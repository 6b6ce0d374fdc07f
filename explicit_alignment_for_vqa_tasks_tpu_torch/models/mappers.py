"""Mapping networks: CLIP embedding -> visual prefix in LM embedding space.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/mappers.py, with
its three families:

  * MLP:          prefix_size -> (d*n)/2 -> d*n, tanh
  * Transformer:  a linear map to clip_length token slots, learned prefix
                  constants appended, a pre-LN self-attention stack (relu
                  MLP, ratio 2); the transformed constants are the prefix
  * Perceiver:    learned latents (sampled vocabulary embeddings under
                  VC-T0) cross-attend to [projected input; latents], depth
                  2, then a final LayerNorm

All are plain PyTorch (the JAX package runs no Pallas kernel in them) over
nested dicts of tensors whose keys and stacked layer axis are the JAX
trees', so ``convert.py`` carries JAX params of any type across. They run
in fp32; the caller casts to the LM's dtype at the splice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapper hyperparameters (the JAX package's field set)."""

    mapping_type: str = "mlp"          # "mlp" | "transformer" | "perceiver"
    prefix_size: int = 768             # CLIP embedding dim
    d_model: int = 2048                # LM embedding dim
    prefix_length: int = 10
    clip_length: int = 10
    num_layers: int = 8
    num_heads: int = 8
    dim_head: int = 64


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u.mul_(2 * bound).sub_(bound)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def _linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    bound = (1.0 / in_dim) ** 0.5
    return {"w": _uniform(gen, (in_dim, out_dim), bound),
            "b": _uniform(gen, (out_dim,), bound)}


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def _stack(blocks: list) -> Params:
    """Per-layer dicts as one dict of tensors stacked on a leading axis."""
    return {k: _stack([b[k] for b in blocks]) if isinstance(blocks[0][k], dict)
            else torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _num_layers(blocks: Params) -> int:
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """(B, N, H, dh) queries over (B, M, H, dh) keys and values: fp32
    logits scaled by dh^-1/2, the softmax over the keys cast to ``dtype``,
    (B, N, H, dh) in ``dtype``."""
    logits = torch.einsum("bnhd,bmhd->bnmh", q.float(), k.float())
    logits = logits * (q.shape[-1] ** -0.5)
    weights = torch.softmax(logits, dim=2).to(dtype)
    return torch.einsum("bnmh,bmhd->bnhd", weights.float(),
                        v.float()).to(dtype)


# ---------------------------------------------------------------------------
# MLP mapper
# ---------------------------------------------------------------------------

def init_mlp_mapper(gen: torch.Generator, prefix_size: int, d_model: int,
                    prefix_length: int) -> Params:
    hidden = (d_model * prefix_length) // 2
    out = d_model * prefix_length
    return {
        "fc1": _linear_init(gen, prefix_size, hidden),
        "fc2": _linear_init(gen, hidden, out),
    }


def mlp_mapper_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model)."""
    return _linear(params["fc2"], torch.tanh(_linear(params["fc1"], x)))


# ---------------------------------------------------------------------------
# Transformer mapper
# ---------------------------------------------------------------------------

def init_transformer_mapper(gen: torch.Generator, prefix_size: int,
                            d_model: int, prefix_length: int,
                            clip_length: int, num_layers: int = 8,
                            num_heads: int = 8) -> Params:
    """JAX ``init_transformer_mapper`` (:74): LayerNorms at 1 and 0, the
    linears uniform in +-fan_in^-1/2, the prefix constants normal."""
    del num_heads  # a property of the apply, as in JAX
    d = d_model
    linear = _linear_init(gen, prefix_size, clip_length * d)
    prefix_const = _normal(gen, (prefix_length, d))
    blocks = [{
        "ln1_scale": torch.ones(d, device=gen.device),
        "ln1_bias": torch.zeros(d, device=gen.device),
        "q": _linear_init(gen, d, d),
        "kv": _linear_init(gen, d, 2 * d),
        "o": _linear_init(gen, d, d),
        "ln2_scale": torch.ones(d, device=gen.device),
        "ln2_bias": torch.zeros(d, device=gen.device),
        "mlp": {"fc1": _linear_init(gen, d, 2 * d),
                "fc2": _linear_init(gen, 2 * d, d)},
    } for _ in range(num_layers)]
    return {"linear": linear, "prefix_const": prefix_const,
            "blocks": _stack(blocks)}


def _mapper_attention(layer_p: Params, x: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """JAX ``_mapper_attention`` (:121): self-attention over x's tokens."""
    d = x.shape[-1]
    head_dim = d // heads
    q = _linear(layer_p["q"], x).reshape(*x.shape[:-1], heads, head_dim)
    kv = _linear(layer_p["kv"], x).reshape(*x.shape[:-1], 2, heads, head_dim)
    out = _softmax_attention(q, kv[..., 0, :, :], kv[..., 1, :, :], x.dtype)
    return _linear(layer_p["o"], out.reshape(*x.shape[:-1], d))


def transformer_mapper_apply(cfg: MapperConfig, params: Params,
                             x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model): x projected to
    clip_length token slots, the prefix constants appended, the pre-LN
    stack over all of them, the constants' slots returned (JAX
    ``transformer_mapper_apply``, :136)."""
    clip_length, prefix_length = cfg.clip_length, cfg.prefix_length
    lead = x.shape[:-1]
    d_model = params["prefix_const"].shape[-1]
    tokens = _linear(params["linear"], x).reshape(-1, clip_length, d_model)
    const = params["prefix_const"].to(x.dtype)[None].expand(
        tokens.shape[0], prefix_length, d_model)
    y = torch.cat([tokens, const], dim=1)
    for i in range(_num_layers(params["blocks"])):
        p = _layer(params["blocks"], i)
        y = y + _mapper_attention(
            p, _ln(y, p["ln1_scale"], p["ln1_bias"]), cfg.num_heads)
        h = _ln(y, p["ln2_scale"], p["ln2_bias"])
        y = y + _linear(p["mlp"]["fc2"], torch.relu(_linear(p["mlp"]["fc1"],
                                                            h)))
    return y[:, clip_length:].reshape(*lead, prefix_length * d_model)


# ---------------------------------------------------------------------------
# Perceiver resampler
# ---------------------------------------------------------------------------

def init_perceiver_mapper(gen: torch.Generator, prefix_size: int,
                          d_model: int, prefix_length: int, depth: int = 2,
                          heads: int = 8, dim_head: int = 64,
                          ff_mult: int = 1,
                          latents_init: Optional[torch.Tensor] = None
                          ) -> Params:
    """JAX ``init_perceiver_mapper`` (:176): the latents are
    ``latents_init`` when given (VC-T0 passes sampled vocabulary
    embeddings), else normal."""
    d, inner = d_model, heads * dim_head
    input_proj = _linear_init(gen, prefix_size, d)
    latents = (latents_init.float().clone() if latents_init is not None
               else _normal(gen, (prefix_length, d)))
    blocks = [{
        "ln_latents_scale": torch.ones(d, device=gen.device),
        "ln_latents_bias": torch.zeros(d, device=gen.device),
        "ln_input_scale": torch.ones(d, device=gen.device),
        "ln_input_bias": torch.zeros(d, device=gen.device),
        "q": _linear_init(gen, d, inner),
        "kv": _linear_init(gen, d, 2 * inner),
        "o": _linear_init(gen, inner, d),
        "ln_ff_scale": torch.ones(d, device=gen.device),
        "ln_ff_bias": torch.zeros(d, device=gen.device),
        "ff1": _linear_init(gen, d, ff_mult * d),
        "ff2": _linear_init(gen, ff_mult * d, d),
    } for _ in range(depth)]
    return {"input_proj": input_proj, "latents": latents,
            "final_ln_scale": torch.ones(d, device=gen.device),
            "final_ln_bias": torch.zeros(d, device=gen.device),
            "blocks": _stack(blocks)}


def perceiver_mapper_apply(cfg: MapperConfig, params: Params,
                           x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model): the latents
    attend to [LN(projected x); LN(latents)], then a tanh-gelu feed-forward,
    each with its residual; a final LayerNorm (JAX
    ``perceiver_mapper_apply``, :217)."""
    heads, dim_head = cfg.num_heads, cfg.dim_head
    d_model = params["latents"].shape[-1]
    n_latents = cfg.prefix_length
    lead = x.shape[:-1]
    feats = _linear(params["input_proj"], x).reshape(-1, 1, d_model)
    batch = feats.shape[0]
    lat = params["latents"].to(x.dtype)[None].expand(batch, n_latents,
                                                     d_model)
    for i in range(_num_layers(params["blocks"])):
        p = _layer(params["blocks"], i)
        lat_n = _ln(lat, p["ln_latents_scale"], p["ln_latents_bias"])
        feats_n = _ln(feats, p["ln_input_scale"], p["ln_input_bias"])
        kv_input = torch.cat([feats_n, lat_n], dim=1)
        q = _linear(p["q"], lat_n).reshape(batch, n_latents, heads, dim_head)
        kv = _linear(p["kv"], kv_input).reshape(batch, -1, 2, heads, dim_head)
        out = _softmax_attention(q, kv[:, :, 0], kv[:, :, 1], x.dtype)
        lat = lat + _linear(p["o"], out.reshape(batch, n_latents,
                                                heads * dim_head))
        h = _ln(lat, p["ln_ff_scale"], p["ln_ff_bias"])
        lat = lat + _linear(p["ff2"], F.gelu(_linear(p["ff1"], h),
                                             approximate="tanh"))
    lat = _ln(lat, params["final_ln_scale"], params["final_ln_bias"])
    return lat.reshape(*lead, n_latents * d_model)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def init_mapper(gen: torch.Generator, cfg: MapperConfig,
                latents_init: Optional[torch.Tensor] = None) -> Params:
    """fp32 mapper params on ``gen``'s device, drawn as the JAX init draws
    them (its distributions, not its random stream). The reference falls
    back to the MLP for unknown types."""
    if cfg.mapping_type == "transformer":
        return init_transformer_mapper(
            gen, cfg.prefix_size, cfg.d_model, cfg.prefix_length,
            cfg.clip_length, cfg.num_layers, cfg.num_heads)
    if cfg.mapping_type == "perceiver":
        return init_perceiver_mapper(
            gen, cfg.prefix_size, cfg.d_model, cfg.prefix_length,
            heads=cfg.num_heads, dim_head=cfg.dim_head,
            latents_init=latents_init)
    return init_mlp_mapper(gen, cfg.prefix_size, cfg.d_model,
                           cfg.prefix_length)


def mapper_apply(cfg: MapperConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """(..., prefix_size) -> (..., prefix_length * d_model)."""
    if cfg.mapping_type == "transformer":
        return transformer_mapper_apply(cfg, params, x)
    if cfg.mapping_type == "perceiver":
        return perceiver_mapper_apply(cfg, params, x)
    return mlp_mapper_apply(params, x)
