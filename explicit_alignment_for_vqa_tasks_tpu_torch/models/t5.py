"""T5 / T0 encoder-decoder in PyTorch, for inference.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/t5.py. The
parameters are the JAX package's tree as a nested dict of tensors with the
same keys; per-layer weights stay STACKED on a leading layer axis and the
layer scan becomes a Python loop over that axis. Numerics follow the JAX
package:

  * a matmul of bf16 operands is one rounding after an fp32 accumulation
    (``einsum(..., preferred_element_type=f32).astype(dtype)`` there), which
    is what a bf16 ``torch.matmul`` does;
  * attention logits, softmax and the LM logits are fp32; where JAX keeps
    an fp32 product of bf16 operands unrounded, the port upcasts the
    operands (exact) and multiplies in fp32;
  * T5 attention has NO 1/sqrt(d) scale; masks add -1e9.

Encoder self-attention goes through ``ops.fused_attention_block
.t5_attention_core`` (a CUDA kernel on the card) when
``fused_encoder_attention`` is set, as the shipped configs set it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.fused_attention_block import t5_attention_core

Params = Dict[str, Any]
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 5120
    num_encoder_layers: int = 24
    num_decoder_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dtype: Any = torch.bfloat16  # compute dtype
    # training knob (rematerialise each layer); no effect on inference
    remat: bool = False
    # encoder self-attention through the t5_attention_core kernel instead
    # of a materialised (B, H, L, L) fp32 bias
    fused_encoder_attention: bool = False
    # the options below are not ported yet; see _check_ported
    fused_decode_attention: bool = False
    int8_cross_kv: bool = False
    int8_kv_layout: Optional[str] = None
    fused_encoder_ffn: bool = False
    int8_encoder_ffn: bool = False
    int8_encoder_attn: bool = False
    int8_decoder_step: bool = False

    @classmethod
    def t0_3b(cls, **kw) -> "T5Config":
        """bigscience/T0_3B (T5 v1.1 XL, LM-adapted)."""
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw) -> "T5Config":
        cfg = dict(
            vocab_size=32128, d_model=32, d_kv=8, num_heads=4, d_ff=64,
            num_encoder_layers=2, num_decoder_layers=2, dtype=torch.float32,
        )
        cfg.update(kw)
        return cls(**cfg)


_NOT_PORTED = {
    "fused_decode_attention":
        "the cross_attention_decode kernel (ROADMAP.md, Queue 2 #5)",
    "int8_cross_kv": "the int8 main-path stack (ROADMAP.md, Queue 1 item 8)",
    "int8_encoder_ffn":
        "the fused_t5_ffn_q8 kernel (ROADMAP.md, Queue 2 #4)",
    "int8_encoder_attn":
        "the fused_t5_ln_qkv_q8 and fused_oproj_residual_q8 kernels "
        "(ROADMAP.md, Queue 2 #2 and #3)",
    "int8_decoder_step":
        "the int8 main-path stack (ROADMAP.md, Queue 1 item 8)",
    "fused_encoder_ffn": "the fused_t5_ffn kernel (ROADMAP.md, Queue 2 #6)",
}


def _check_ported(cfg: T5Config) -> None:
    for flag, item in _NOT_PORTED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"T5Config.{flag} is not ported yet; it comes with {item}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_t5_params(gen: torch.Generator, cfg: T5Config,
                   param_dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random-init params with T5's fan-in scaled init (stacked layers),
    the JAX package's shapes and standard deviations. The normals are
    drawn on ``gen``'s device."""
    d, kv, h, ff = cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.d_ff
    inner = h * kv
    dev = gen.device

    def normal(shape, stddev):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(stddev).to(param_dtype)

    def attn(n_layers: int) -> Params:
        return {
            "q": normal((n_layers, d, inner), (d * kv) ** -0.5),
            "k": normal((n_layers, d, inner), d ** -0.5),
            "v": normal((n_layers, d, inner), d ** -0.5),
            "o": normal((n_layers, inner, d), inner ** -0.5),
        }

    def ffn(n_layers: int) -> Params:
        p = {
            "wi_0": normal((n_layers, d, ff), d ** -0.5),
            "wo": normal((n_layers, ff, d), ff ** -0.5),
        }
        if cfg.is_gated_act:
            p["wi_1"] = normal((n_layers, d, ff), d ** -0.5)
        return p

    def lns(n_layers: int, count: int) -> Params:
        return {f"ln{i}": torch.ones((n_layers, d), dtype=param_dtype,
                                     device=dev) for i in range(count)}

    def rel_bias():
        return normal((cfg.relative_attention_num_buckets, h), (d // kv) ** -0.5)

    ne, nd = cfg.num_encoder_layers, cfg.num_decoder_layers
    params: Params = {
        "shared": normal((cfg.vocab_size, d), 1.0),
        "encoder": {
            "self_attn": attn(ne),
            "ffn": ffn(ne),
            **lns(ne, 2),
            "rel_bias": rel_bias(),
            "final_ln": torch.ones((d,), dtype=param_dtype, device=dev),
        },
        "decoder": {
            "self_attn": attn(nd),
            "cross_attn": attn(nd),
            "ffn": ffn(nd),
            **lns(nd, 3),
            "rel_bias": rel_bias(),
            "final_ln": torch.ones((d,), dtype=param_dtype, device=dev),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a dict of stacked weights."""
    return {k: v[i] for k, v in stacked.items()}


def _encoder_layer(enc: Params, i: int) -> Params:
    return {"self_attn": _layer(enc["self_attn"], i),
            "ffn": _layer(enc["ffn"], i),
            "ln0": enc["ln0"][i], "ln1": enc["ln1"][i]}


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 LayerNorm: RMS, no mean subtraction, computed in fp32."""
    x32 = x.float()
    variance = (x32 * x32).mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(variance + eps)
    return (weight.float() * x32).to(x.dtype)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5's log-bucketed relative positions. The log is taken in fp32 and
    the cast truncates, as in the JAX package, so both give the same
    integers."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    )
    val_if_large = (max_exact + scaled.to(ret.dtype)).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(
    rel_bias: torch.Tensor,  # (num_buckets, H)
    query_len: int,
    key_len: int,
    bidirectional: bool,
    cfg: T5Config,
    query_offset: int = 0,
) -> torch.Tensor:
    """(1, H, Q, K) fp32 additive attention bias."""
    dev = rel_bias.device
    ctx = torch.arange(query_len, device=dev)[:, None] + query_offset
    mem = torch.arange(key_len, device=dev)[None, :]
    buckets = relative_position_bucket(
        mem - ctx, bidirectional,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    bias = rel_bias.float()[buckets]  # (Q, K, H)
    return bias.permute(2, 0, 1)[None]


def _attention(
    q: torch.Tensor,             # (B, Qlen, H, kv)
    k: torch.Tensor,             # (B, Klen, H, kv)
    v: torch.Tensor,             # (B, Klen, H, kv)
    bias: Optional[torch.Tensor],  # broadcastable to (B, H, Qlen, Klen), f32
    dtype: torch.dtype,
) -> torch.Tensor:
    """Core attention; logits and softmax in fp32. T5: NO 1/sqrt(d) scale."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                        v.float()).to(dtype)


def _project(x: torch.Tensor, w: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, D) x (D, H*kv) -> (B, L, H, kv)"""
    y = torch.matmul(x, w.to(x.dtype))
    return y.reshape(y.shape[0], y.shape[1], heads, -1)


def _attn_block(
    layer_p: Params, x: torch.Tensor, kv_src: torch.Tensor,
    bias: Optional[torch.Tensor], cfg: T5Config
) -> torch.Tensor:
    h = cfg.num_heads
    q = _project(x, layer_p["q"], h)
    k = _project(kv_src, layer_p["k"], h)
    v = _project(kv_src, layer_p["v"], h)
    out = _attention(q, k, v, bias, x.dtype)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    return torch.matmul(out, layer_p["o"].to(x.dtype))


def _ffn_block(layer_p: Params, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    hidden = gelu_new(torch.matmul(x, layer_p["wi_0"].to(x.dtype)))
    if cfg.is_gated_act:
        hidden = hidden * torch.matmul(x, layer_p["wi_1"].to(x.dtype))
    return torch.matmul(hidden, layer_p["wo"].to(x.dtype))


def _encoder_ffn(layer_p: Params, y: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """RMS-norm + FFN + residual (the JAX package's plain branch)."""
    ffn_in = rms_norm(y, layer_p["ln1"], cfg.layer_norm_epsilon)
    return y + _ffn_block(layer_p["ffn"], ffn_in, cfg)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: T5Config,
                 input_ids: torch.Tensor) -> torch.Tensor:
    return params["shared"].to(cfg.dtype)[input_ids.long()]


def t5_encode(
    params: Params,
    cfg: T5Config,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns encoder hidden states (B, L, D)."""
    _check_ported(cfg)
    enc = params["encoder"]
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, cfg, input_ids)
    x = inputs_embeds.to(cfg.dtype)
    batch, length, _ = x.shape
    if attention_mask is None:
        attention_mask = torch.ones((batch, length), dtype=torch.int32,
                                    device=x.device)
    eps = cfg.layer_norm_epsilon
    pos_bias = compute_position_bias(
        enc["rel_bias"], length, length, bidirectional=True, cfg=cfg
    )

    if cfg.fused_encoder_attention:
        pos_hll = pos_bias[0].contiguous()  # (H, L, L), shared by the batch
        key_mask = attention_mask.to(torch.int32).contiguous()
        for i in range(cfg.num_encoder_layers):
            layer_p = _encoder_layer(enc, i)
            p = layer_p["self_attn"]
            attn_in = rms_norm(x, layer_p["ln0"], eps)
            q = torch.matmul(attn_in, p["q"].to(x.dtype))
            k = torch.matmul(attn_in, p["k"].to(x.dtype))
            v = torch.matmul(attn_in, p["v"].to(x.dtype))
            attn = t5_attention_core(q, k, v, pos_hll, key_mask, cfg.num_heads)
            x = x + torch.matmul(attn, p["o"].to(x.dtype))
            x = _encoder_ffn(layer_p, x, cfg)
    else:
        mask_bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
        bias = pos_bias + mask_bias  # (B, H, L, L) fp32
        for i in range(cfg.num_encoder_layers):
            layer_p = _encoder_layer(enc, i)
            attn_in = rms_norm(x, layer_p["ln0"], eps)
            x = x + _attn_block(layer_p["self_attn"], attn_in, attn_in,
                                bias, cfg)
            x = _encoder_ffn(layer_p, x, cfg)
    return rms_norm(x, enc["final_ln"], eps)


def lm_logits(params: Params, cfg: T5Config,
              hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits. JAX keeps the fp32 product of the bf16 operands without
    a bf16 rounding; a bf16 matmul would round the logits and move
    log-probs and argmax ties, so the operands are upcast (exact) and
    multiplied in fp32."""
    if cfg.tie_word_embeddings:
        hidden = hidden * (cfg.d_model ** -0.5)
        head = params["shared"].T
    else:
        head = params["lm_head"]
    return torch.matmul(hidden.float(), head.to(hidden.dtype).float())


# ---------------------------------------------------------------------------
# Incremental decoding with KV cache
# ---------------------------------------------------------------------------

def cross_kv_cache(params: Params, cfg: T5Config,
                   encoder_hidden: torch.Tensor) -> Params:
    """Cross-attention K/V for every decoder layer, (layers, B, L, H, kv)
    in the compute dtype."""
    _check_ported(cfg)
    cross = params["decoder"]["cross_attn"]
    h = cfg.num_heads
    ks, vs = [], []
    for i in range(cfg.num_decoder_layers):
        ks.append(_project(encoder_hidden, cross["k"][i], h))
        vs.append(_project(encoder_hidden, cross["v"][i], h))
    return {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def init_decode_cache(params: Params, cfg: T5Config,
                      encoder_hidden: torch.Tensor, max_len: int) -> Params:
    """Cache dict: cross-attn K/V precomputed once (``cross_kv_cache``);
    self-attn K/V are (num_layers, B, max_len, H, kv) buffers filled step
    by step. ``index`` is a host integer: the decode loop runs on the
    host."""
    batch = encoder_hidden.shape[0]
    shape = (cfg.num_decoder_layers, batch, max_len, cfg.num_heads, cfg.d_kv)
    cache = {
        "self_k": torch.zeros(shape, dtype=cfg.dtype,
                              device=encoder_hidden.device),
        "self_v": torch.zeros(shape, dtype=cfg.dtype,
                              device=encoder_hidden.device),
        "index": 0,
    }
    cache.update(cross_kv_cache(params, cfg, encoder_hidden))
    return cache


def t5_decode_step(
    params: Params,
    cfg: T5Config,
    token: torch.Tensor,         # (B,) current decoder token
    cache: Params,
    encoder_mask: torch.Tensor,  # (B, Lenc)
) -> Tuple[torch.Tensor, Params]:
    """One incremental decode step. Returns (fp32 logits (B, V), cache).

    Unlike the JAX step, which returns a new cache, this writes the step's
    self-attention K/V into the cache's buffers in place (no copy of the
    (layers, B, max_len, H, kv) buffers per step) and returns the same
    dict with ``index`` advanced."""
    _check_ported(cfg)
    dec = params["decoder"]
    eps = cfg.layer_norm_epsilon
    h = cfg.num_heads
    x = embed_tokens(params, cfg, token[:, None])  # (B, 1, D)
    index = cache["index"]
    self_k, self_v = cache["self_k"], cache["self_v"]
    max_len = self_k.shape[2]

    # self-attn bias: relative positions of the current step vs all cached
    # positions, plus invalidation of not-yet-written slots
    self_bias = compute_position_bias(
        dec["rel_bias"], 1, max_len, bidirectional=False, cfg=cfg,
        query_offset=index,
    )
    pos_valid = torch.arange(max_len, device=x.device) <= index
    self_bias = self_bias + torch.where(pos_valid[None, None, None, :], 0.0,
                                        NEG_INF)
    cross_bias = torch.where(encoder_mask[:, None, None, :] > 0, 0.0, NEG_INF)

    for i in range(cfg.num_decoder_layers):
        sa = _layer(dec["self_attn"], i)
        ca = _layer(dec["cross_attn"], i)
        sa_in = rms_norm(x, dec["ln0"][i], eps)
        q = _project(sa_in, sa["q"], h)
        self_k[i, :, index] = _project(sa_in, sa["k"], h)[:, 0]
        self_v[i, :, index] = _project(sa_in, sa["v"], h)[:, 0]
        attn = _attention(q, self_k[i], self_v[i], self_bias, x.dtype)
        x = x + torch.matmul(attn.reshape(attn.shape[0], 1, -1),
                             sa["o"].to(x.dtype))

        ca_in = rms_norm(x, dec["ln1"][i], eps)
        cq = _project(ca_in, ca["q"], h)
        cattn = _attention(cq, cache["cross_k"][i], cache["cross_v"][i],
                           cross_bias, x.dtype)
        x = x + torch.matmul(cattn.reshape(cattn.shape[0], 1, -1),
                             ca["o"].to(x.dtype))

        ffn_in = rms_norm(x, dec["ln2"][i], eps)
        x = x + _ffn_block(_layer(dec["ffn"], i), ffn_in, cfg)
    hidden = rms_norm(x, dec["final_ln"], eps)
    logits = lm_logits(params, cfg, hidden)[:, 0]
    cache["index"] = index + 1
    return logits, cache
