"""GPT-2 decoder-only LM in PyTorch (ClipCap's backbone).

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/gpt2.py, with the
same parameter tree (the layers stacked on a leading axis, (in, out)
weights, a fused (D, 3D) QKV, the LM head tied to ``wte``) and the same
roundings: each product accumulates in fp32 and is cast to the LM's dtype,
the attention softmax is fp32, masks are additive ``NEG_INF`` biases.

``gpt2_forward`` is the full-sequence forward (teacher forcing, the ClipCap
loss). With ``cfg.fused_block`` and at most 128 positions it runs the whole
block as one ``fused_gpt2_block`` call per layer
(``ops/fused_attention_block.py``, kernel ``csrc/gpt2_block.cu``) through
its autograd form ``fused_gpt2_block_vjp``, so the loss differentiates, as
the JAX package does (:182-202); otherwise the plain block below. The KV-cached
``gpt2_prefill`` and ``gpt2_decode_step`` run no kernel, in either package.
The cache's ``index`` is a host integer: the decode loop runs on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import fused_attention_block as fab

Params = Dict[str, Any]
NEG_INF = -1e9
# the longest sequence gpt2_forward runs through fused_gpt2_block (the JAX
# package's whole-group scores in VMEM)
FUSED_MAX_LEN = 128


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_epsilon: float = 1e-5
    eos_token_id: int = 50256
    dtype: torch.dtype = torch.bfloat16
    # the whole block as one fused_gpt2_block call per layer in the
    # full-sequence forward at FUSED_MAX_LEN positions or fewer; prefill and
    # decode keep the plain KV-cache path
    fused_block: bool = False

    @classmethod
    def gpt2_small(cls, **kw) -> "GPT2Config":
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw) -> "GPT2Config":
        cfg = dict(vocab_size=128, n_positions=64, d_model=32, num_layers=2,
                   num_heads=4, dtype=torch.float32)
        cfg.update(kw)
        return cls(**cfg)


def init_gpt2_params(gen: torch.Generator, cfg: GPT2Config,
                     param_dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random params with the JAX package's shapes and standard deviations
    (normal 0.02, positions 0.01; LayerNorms one and zero, biases zero),
    drawn on ``gen``'s device."""
    d, n = cfg.d_model, cfg.num_layers
    dev = gen.device

    def normal(shape, std=0.02):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(std).to(param_dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=param_dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=param_dtype, device=dev)

    return {
        "wte": normal((cfg.vocab_size, d)),
        "wpe": normal((cfg.n_positions, d), 0.01),
        "blocks": {
            "ln1_scale": ones(n, d), "ln1_bias": zeros(n, d),
            "attn_qkv": normal((n, d, 3 * d)),
            "attn_qkv_bias": zeros(n, 3 * d),
            "attn_out": normal((n, d, d)), "attn_out_bias": zeros(n, d),
            "ln2_scale": ones(n, d), "ln2_bias": zeros(n, d),
            "mlp_fc": normal((n, d, 4 * d)), "mlp_fc_bias": zeros(n, 4 * d),
            "mlp_proj": normal((n, 4 * d, d)), "mlp_proj_bias": zeros(n, d),
        },
        "ln_f_scale": ones(d), "ln_f_bias": zeros(d),
    }


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 in JAX ``layer_norm``'s order (the mean, the mean
    of squared deviations, ``(x - m) * rsqrt(var + eps)``, ``* scale +
    bias``), cast back to x's dtype; not ``F.layer_norm``."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in x's dtype, in its order:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))`` with c = sqrt(2 /
    pi) rounded to x's dtype."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: fp32 accumulation, one rounding (the JAX einsum
    with ``preferred_element_type=float32`` then ``astype(dt)``)."""
    return torch.matmul(x, w.to(x.dtype))


def _gpt2_block(
    layer_p: Params,
    x: torch.Tensor,                    # (B, Q, D)
    bias: torch.Tensor,                 # (B or 1, 1, Q, K) additive, fp32
    cfg: GPT2Config,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: int = 0,
) -> torch.Tensor:
    """One pre-LN block in the JAX ``_gpt2_block``'s roundings. With
    ``kv_cache`` ((B, max_len, H, dh) buffers of one layer) the new keys and
    values are written in place at ``cache_index`` and the queries attend
    over the whole buffer."""
    h, dt = cfg.num_heads, x.dtype
    batch, length, d_model = x.shape
    eps = cfg.layer_norm_epsilon
    ln1 = layer_norm(x, layer_p["ln1_scale"], layer_p["ln1_bias"], eps)
    qkv = _matmul(ln1, layer_p["attn_qkv"]) + layer_p["attn_qkv_bias"].to(dt)
    q, k, v = (t.reshape(batch, length, h, -1)
               for t in qkv.split(d_model, dim=-1))
    if kv_cache is not None:
        k_buf, v_buf = kv_cache
        k_buf[:, cache_index:cache_index + length] = k.to(k_buf.dtype)
        v_buf[:, cache_index:cache_index + length] = v.to(v_buf.dtype)
        k, v = k_buf, v_buf

    scale = (d_model // h) ** -0.5
    logits = torch.matmul(q.transpose(1, 2).float(),
                          k.permute(0, 2, 3, 1).float()) * scale
    weights = torch.softmax(logits + bias, dim=-1).to(dt)
    attn = torch.matmul(weights, v.transpose(1, 2)).transpose(1, 2)
    attn = attn.reshape(batch, length, d_model)
    attn = _matmul(attn, layer_p["attn_out"])
    x = x + attn + layer_p["attn_out_bias"].to(dt)

    ln2 = layer_norm(x, layer_p["ln2_scale"], layer_p["ln2_bias"], eps)
    hidden = _matmul(ln2, layer_p["mlp_fc"])
    hidden = gelu_tanh(hidden + layer_p["mlp_fc_bias"].to(dt))
    hidden = _matmul(hidden, layer_p["mlp_proj"])
    return x + hidden + layer_p["mlp_proj_bias"].to(dt)


def _layers(blocks: Params):
    """The stacked layer tree, one layer's leaves at a time (the JAX scan)."""
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        yield {name: leaf[i] for name, leaf in blocks.items()}


def gpt2_embed(params: Params, cfg: GPT2Config, input_ids: torch.Tensor,
               position_offset: int = 0) -> torch.Tensor:
    positions = torch.arange(input_ids.shape[1], device=input_ids.device) \
        + position_offset
    return (params["wte"].to(cfg.dtype)[input_ids.long()]
            + params["wpe"].to(cfg.dtype)[positions][None])


def lm_logits(params: Params, cfg: GPT2Config,
              x: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm and the tied LM head, fp32 logits: a plain large
    product (``torch.matmul``), as JAX leaves it to XLA. JAX keeps the fp32
    product of the operands in x's dtype without rounding it to that dtype,
    so the operands are upcast (exact) and multiplied in fp32."""
    x = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                   cfg.layer_norm_epsilon)
    return torch.matmul(x.float(), params["wte"].to(x.dtype).float().t())


def _causal_bias(length: int, device: torch.device) -> torch.Tensor:
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=device).tril()
    return torch.where(causal, 0.0, NEG_INF)[None, None]


def _key_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)


def gpt2_forward(
    params: Params,
    cfg: GPT2Config,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward; returns fp32 logits (B, L, V).

    ``inputs_embeds`` must already include the positional embeddings (use
    ``gpt2_embed`` or ``clipcap.embed_with_prefix``)."""
    if inputs_embeds is None:
        inputs_embeds = gpt2_embed(params, cfg, input_ids)
    x = inputs_embeds.to(cfg.dtype)
    batch, length, _ = x.shape

    if cfg.fused_block and length <= FUSED_MAX_LEN:
        mask = (torch.ones((batch, length), dtype=torch.int32,
                           device=x.device)
                if attention_mask is None
                else attention_mask.to(torch.int32))
        for layer_p in _layers(params["blocks"]):
            x = fab.fused_gpt2_block_vjp(
                x, mask, *(layer_p[n] for n in fab.GPT2_BLOCK_KEYS),
                cfg.num_heads, cfg.layer_norm_epsilon)
        return lm_logits(params, cfg, x)

    bias = _causal_bias(length, x.device)
    if attention_mask is not None:
        bias = bias + _key_bias(attention_mask)
    for layer_p in _layers(params["blocks"]):
        x = _gpt2_block(layer_p, x, bias, cfg)
    return lm_logits(params, cfg, x)


def init_gpt2_cache(cfg: GPT2Config, batch: int, max_len: int,
                    device: Optional[torch.device] = None) -> Params:
    """(num_layers, B, max_len, H, dh) K and V buffers of zeros in the LM's
    dtype, and the host integer ``index`` of the next slot."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads,
             cfg.d_model // cfg.num_heads)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "index": 0}


def gpt2_prefill(
    params: Params,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,    # (B, L, D) incl. positional embeddings
    attention_mask: torch.Tensor,   # (B, L)
    cache: Params,
) -> Tuple[torch.Tensor, Params]:
    """Run the prompt through the model, filling the cache from slot 0 (in
    place). Returns (fp32 logits of the LAST position (B, V), cache)."""
    x = inputs_embeds.to(cfg.dtype)
    batch, length, _ = x.shape
    max_len = cache["k"].shape[2]
    bias = _causal_bias(length, x.device) + _key_bias(attention_mask)
    # queries attend only within the prompt during prefill
    pad = torch.full((batch, 1, length, max_len - length), NEG_INF,
                     device=x.device)
    bias_full = torch.cat([bias.expand(batch, 1, length, length), pad],
                          dim=-1)
    for i, layer_p in enumerate(_layers(params["blocks"])):
        x = _gpt2_block(layer_p, x, bias_full, cfg,
                        kv_cache=(cache["k"][i], cache["v"][i]),
                        cache_index=0)
    logits = lm_logits(params, cfg, x)
    cache["index"] = length
    return logits[:, -1], cache


def gpt2_decode_step(
    params: Params,
    cfg: GPT2Config,
    token: torch.Tensor,             # (B,)
    cache: Params,
    attention_mask: torch.Tensor,    # (B, max_len): 1 for valid cache slots
) -> Tuple[torch.Tensor, Params]:
    """One incremental step; returns (fp32 logits (B, V), the cache with
    this step's K and V written in place and ``index`` advanced)."""
    index = cache["index"]
    x = gpt2_embed(params, cfg, token[:, None], position_offset=index)
    max_len = cache["k"].shape[2]
    pos_valid = torch.arange(max_len, device=x.device) <= index
    bias = torch.where((attention_mask > 0) & pos_valid[None, :], 0.0,
                       NEG_INF)[:, None, None, :]
    for i, layer_p in enumerate(_layers(params["blocks"])):
        x = _gpt2_block(layer_p, x, bias, cfg,
                        kv_cache=(cache["k"][i], cache["v"][i]),
                        cache_index=index)
    logits = lm_logits(params, cfg, x)[:, 0]
    cache["index"] = index + 1
    return logits, cache
