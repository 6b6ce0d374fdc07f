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
``fused_encoder_attention`` is set, as the shipped configs set it. The
opt-in int8 bulk-eval modes (``int8_encoder_ffn``, ``int8_encoder_attn``)
run the encoder's FFN and attention projections through the int8 kernels
of the same module on weights quantized once by ``quantize_encoder_ffn`` /
``quantize_encoder_attn``, optionally after SmoothQuant calibration
(``calibrate_encoder_act_max``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.fused_attention_block import (
    fused_oproj_residual_q8,
    fused_t5_ffn_q8,
    fused_t5_ln_qkv_q8,
    t5_attention_core,
)

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
    # opt-in int8 bulk-eval encoder (W8A8): the FFN through fused_t5_ffn_q8
    # on params["encoder"]["ffn_q8"] (quantize_encoder_ffn), and the
    # attention projections through fused_t5_ln_qkv_q8 /
    # fused_oproj_residual_q8 on params["encoder"]["self_attn_q8"]
    # (quantize_encoder_attn; needs fused_encoder_attention)
    int8_encoder_ffn: bool = False
    int8_encoder_attn: bool = False
    # the options below are not ported yet; see _check_ported
    fused_decode_attention: bool = False
    int8_cross_kv: bool = False
    int8_kv_layout: Optional[str] = None
    fused_encoder_ffn: bool = False
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


def _encoder_layer(enc: Params, i: int, cfg: T5Config) -> Params:
    layer_p = {"self_attn": _layer(enc["self_attn"], i),
               "ffn": _layer(enc["ffn"], i),
               "ln0": enc["ln0"][i], "ln1": enc["ln1"][i]}
    if cfg.int8_encoder_ffn:
        layer_p["ffn_q8"] = _layer(enc["ffn_q8"], i)
    if cfg.int8_encoder_attn:
        layer_p["self_attn_q8"] = _layer(enc["self_attn_q8"], i)
    return layer_p


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
    """RMS-norm + FFN + residual; int8 (the opt-in bulk-eval mode) when
    cfg.int8_encoder_ffn (the layer then carries "ffn_q8")."""
    if cfg.int8_encoder_ffn:
        q8 = layer_p["ffn_q8"]
        gated = cfg.is_gated_act
        return fused_t5_ffn_q8(
            y, q8["ln"] if "ln" in q8 else layer_p["ln1"],
            q8["wi_0"], q8["wi_0_s"],
            q8["wi_1"] if gated else None,
            q8["wi_1_s"] if gated else None,
            q8["wo"], q8["wo_s"],
            eps=cfg.layer_norm_epsilon,
        )
    ffn_in = rms_norm(y, layer_p["ln1"], cfg.layer_norm_epsilon)
    return y + _ffn_block(layer_p["ffn"], ffn_in, cfg)


# ---------------------------------------------------------------------------
# int8 encoder: quantization (once, the LM is frozen) and calibration
# ---------------------------------------------------------------------------

def _pick_groups(k_dim: int, requested) -> int:
    """Resolve the contraction-group count for int8 quantization.
    ``"auto"`` picks the largest g <= 8 such that g divides k_dim and the
    group size is a multiple of 128; an explicit int is used as-is (it
    must divide)."""
    if requested != "auto":
        g = int(requested)
        if g < 1 or k_dim % g:
            raise ValueError(
                f"int8 groups={g} must divide the contraction dim {k_dim}")
        return g
    for cand in range(min(8, k_dim), 1, -1):
        if k_dim % cand == 0 and (k_dim // cand) % 128 == 0:
            return cand
    return 1


def _quant_stacked_i8(w: torch.Tensor,
                      groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(layer, contraction-group, output-channel) symmetric int8
    quantization of stacked (L, K, F) weights, in fp32 on w's device.
    Returns int8 (L, K, F) codes and f32 (L, G, F) scales."""
    w = w.float()
    layers, k_dim, f_dim = w.shape
    wg = w.reshape(layers, groups, k_dim // groups, f_dim)
    scale = torch.clamp(wg.abs().amax(dim=2), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wg / scale[:, :, None, :]), -127, 127)
    return q.reshape(layers, k_dim, f_dim).to(torch.int8), scale


def _smooth_factors(act_max: torch.Tensor, w_list, alpha: float) -> torch.Tensor:
    """SmoothQuant factors (arXiv:2211.10438) for norm-preceded matmuls:
    s_j = act_max_j^alpha / wmax_j^(1-alpha), wmax_j the largest |weight|
    in input row j over all consuming matmuls. act_max (L, K); each w
    (L, K, F); returns (L, K) fp32."""
    wmax = torch.stack([w.float().abs().amax(dim=2) for w in w_list]).amax(0)
    a = torch.clamp(act_max.float().to(wmax.device), min=1e-8)
    s = a ** alpha / torch.clamp(wmax, min=1e-8) ** (1.0 - alpha)
    return torch.clamp(s, 1e-4, 1e4)


def quantize_encoder_ffn(params: Params, groups="auto",
                         act_max: Optional[torch.Tensor] = None,
                         alpha: float = 0.5) -> Params:
    """Once, after loading the frozen LM: int8 quantization of the stacked
    encoder FFN weights for cfg.int8_encoder_ffn. Returns a NEW params dict
    whose ["encoder"]["ffn_q8"] holds (L, D, F) wi_0/wi_1 with (L, G, F)
    scales and (L, F, D) wo with (L, G', D) scales; the input is not
    changed. ``act_max`` (the (L, D) "ffn" entry of
    calibrate_encoder_act_max) folds SmoothQuant factors into the norm
    scale, stored as ffn_q8["ln"] in the LM dtype, and into the wi rows."""
    enc = params["encoder"]
    ffn = enc["ffn"]
    wi_0 = ffn["wi_0"].float()
    wi_1 = ffn["wi_1"].float() if "wi_1" in ffn else None
    wo = ffn["wo"].float()

    q8 = {}
    if act_max is not None:
        gates = [wi_0] if wi_1 is None else [wi_0, wi_1]
        s = _smooth_factors(act_max, gates, alpha)        # (L, D)
        q8["ln"] = (enc["ln1"].float() / s).to(enc["ln1"].dtype)
        wi_0 = wi_0 * s[:, :, None]
        if wi_1 is not None:
            wi_1 = wi_1 * s[:, :, None]

    g_in = _pick_groups(wi_0.shape[1], groups)
    g_hid = _pick_groups(wo.shape[1], groups)
    for name, w, g in (("wi_0", wi_0, g_in), ("wi_1", wi_1, g_in),
                       ("wo", wo, g_hid)):
        if w is None:
            continue
        q8[name], q8[name + "_s"] = _quant_stacked_i8(w, g)
    out = dict(params)
    out["encoder"] = dict(enc)
    out["encoder"]["ffn_q8"] = q8
    return out


def quantize_encoder_attn(params: Params, groups="auto",
                          act_max: Optional[torch.Tensor] = None,
                          alpha: float = 0.5) -> Params:
    """Once: int8 quantization of the stacked encoder attention projections
    (q/k/v/o) for cfg.int8_encoder_attn, the grouped scheme of
    quantize_encoder_ffn. ``act_max`` (the (L, D) "attn" entry) folds
    SmoothQuant factors into the attention norm (self_attn_q8["ln"]) and
    the q/k/v rows; o's input is the attention output, not norm-preceded,
    so it keeps plain grouped quantization."""
    enc = params["encoder"]
    mats = {n: enc["self_attn"][n].float() for n in ("q", "k", "v", "o")}

    q8 = {}
    if act_max is not None:
        s = _smooth_factors(act_max, [mats["q"], mats["k"], mats["v"]],
                            alpha)
        q8["ln"] = (enc["ln0"].float() / s).to(enc["ln0"].dtype)
        for n in ("q", "k", "v"):
            mats[n] = mats[n] * s[:, :, None]

    for name, w in mats.items():
        q8[name], q8[name + "_s"] = _quant_stacked_i8(
            w, _pick_groups(w.shape[1], groups))
    out = dict(params)
    out["encoder"] = dict(enc)
    out["encoder"]["self_attn_q8"] = q8
    return out


@torch.inference_mode()
def calibrate_encoder_act_max(params: Params, cfg: T5Config,
                              batches) -> Dict[str, torch.Tensor]:
    """Run the exact (unfused, non-int8) encoder over ``batches`` and
    record, per layer, the per-channel max |activation| at the two RMS-norm
    outputs (the inputs of the q/k/v and wi_0/wi_1 matmuls), counting only
    positions the attention mask keeps. ``batches``: iterable of
    (input_ids | inputs_embeds, attention_mask or None) pairs. Returns
    {"attn": (L, D), "ffn": (L, D)} fp32 on the params' device, for
    quantize_encoder_attn / quantize_encoder_ffn."""
    cal_cfg = dataclasses.replace(
        cfg, int8_encoder_ffn=False, int8_encoder_attn=False,
        fused_encoder_attention=False, fused_encoder_ffn=False,
    )
    enc = params["encoder"]
    eps = cal_cfg.layer_norm_epsilon
    out = None
    for x, attention_mask in batches:
        x = torch.as_tensor(x, device=enc["ln0"].device)
        if x.dim() == 2:  # token ids
            x = embed_tokens(params, cal_cfg, x)
        x = x.to(cal_cfg.dtype)
        batch, length, _ = x.shape
        if attention_mask is None:
            attention_mask = torch.ones((batch, length), dtype=torch.int32,
                                        device=x.device)
        attention_mask = torch.as_tensor(attention_mask, device=x.device)
        pos_bias = compute_position_bias(
            enc["rel_bias"], length, length, bidirectional=True, cfg=cal_cfg)
        bias = pos_bias + torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
        valid = (attention_mask > 0).float()[:, :, None]
        a_amax, f_amax = [], []
        for i in range(cal_cfg.num_encoder_layers):
            layer_p = _encoder_layer(enc, i, cal_cfg)
            attn_in = rms_norm(x, layer_p["ln0"], eps)
            a_amax.append((attn_in.float().abs() * valid).amax(dim=(0, 1)))
            x = x + _attn_block(layer_p["self_attn"], attn_in, attn_in, bias,
                                cal_cfg)
            ffn_in = rms_norm(x, layer_p["ln1"], eps)
            f_amax.append((ffn_in.float().abs() * valid).amax(dim=(0, 1)))
            x = x + _ffn_block(layer_p["ffn"], ffn_in, cal_cfg)
        cur = {"attn": torch.stack(a_amax), "ffn": torch.stack(f_amax)}
        out = cur if out is None else {
            k: torch.maximum(out[k], cur[k]) for k in out}
    if out is None:
        raise ValueError("calibrate_encoder_act_max needs >= 1 batch")
    return out


def _check_int8_encoder(enc: Params, cfg: T5Config) -> None:
    if cfg.int8_encoder_ffn and "ffn_q8" not in enc:
        raise ValueError(
            "cfg.int8_encoder_ffn requires params['encoder']['ffn_q8'] "
            "— call quantize_encoder_ffn(params) once after loading the "
            "frozen LM weights")
    if cfg.int8_encoder_attn:
        if not cfg.fused_encoder_attention:
            raise ValueError(
                "cfg.int8_encoder_attn requires fused_encoder_attention "
                "(the t5_attention_core kernel between the int8 "
                "projections)")
        if "self_attn_q8" not in enc:
            raise ValueError(
                "cfg.int8_encoder_attn requires "
                "params['encoder']['self_attn_q8'] — call "
                "quantize_encoder_attn(params) once after loading the "
                "frozen LM weights")


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
    _check_int8_encoder(enc, cfg)
    pos_bias = compute_position_bias(
        enc["rel_bias"], length, length, bidirectional=True, cfg=cfg
    )

    if cfg.fused_encoder_attention:
        pos_hll = pos_bias[0].contiguous()  # (H, L, L), shared by the batch
        key_mask = attention_mask.to(torch.int32).contiguous()
        for i in range(cfg.num_encoder_layers):
            layer_p = _encoder_layer(enc, i, cfg)
            if cfg.int8_encoder_attn:
                a8 = layer_p["self_attn_q8"]
                q, k, v = fused_t5_ln_qkv_q8(
                    x, a8["ln"] if "ln" in a8 else layer_p["ln0"],
                    a8["q"], a8["q_s"], a8["k"], a8["k_s"],
                    a8["v"], a8["v_s"], eps=eps,
                )
                attn = t5_attention_core(q, k, v, pos_hll, key_mask,
                                         cfg.num_heads)
                x = fused_oproj_residual_q8(x, attn, a8["o"], a8["o_s"])
                x = _encoder_ffn(layer_p, x, cfg)
                continue
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
            layer_p = _encoder_layer(enc, i, cfg)
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
