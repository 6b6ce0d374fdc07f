"""T5 / T0 encoder-decoder in PyTorch: inference, and the teacher-forced
captioning loss that mapper training differentiates.

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

Every option of ``T5Config`` runs in the port, each through the same
kernel or arithmetic as the JAX package:

  * ``fused_encoder_attention`` (as the shipped configs set it): encoder
    self-attention through ``ops.fused_attention_block.t5_attention_core``,
    called as ``t5_attention_core_vjp`` (its backward through JAX's XLA
    twin, so the loss differentiates through the kernel's forward);
  * ``fused_encoder_ffn``: the encoder FFN through ``fused_t5_ffn``, as
    ``fused_t5_ffn_vjp``;
  * ``remat``: each encoder and decoder layer recomputed in the backward
    (``torch.utils.checkpoint``);
  * the opt-in int8 bulk-eval encoder (``int8_encoder_ffn``,
    ``int8_encoder_attn``): the FFN and attention projections through the
    int8 kernels of the same module, on weights quantized once by
    ``quantize_encoder_ffn`` / ``quantize_encoder_attn``, optionally after
    SmoothQuant calibration (``calibrate_encoder_act_max``);
  * ``fused_decode_attention``: the decode step's cross-attention through
    ``ops.decode_attention.cross_attention_decode``;
  * ``int8_cross_kv`` (with the ``int8_kv_layout`` storage layouts): int8
    cross K/V caches and the scale-folded decode cross-attention;
  * ``int8_decoder_step``: weight-only int8 (W8A16) decode-step matmuls on
    weights quantized once by ``quantize_decoder_step``.

These CUDA kernels run on the card; CPU tensors take their plain versions.
The int8 cross-KV attention and the W8A16 matmuls are plain PyTorch, as
they are plain XLA in the JAX package.

Under a mesh with a ``model`` axis (``parallel/mesh.py``) the weights arrive
split as ``shard_lm_params`` splits them, and each function reads its local
width from them: ``num_heads / model`` heads, ``d_ff / model`` FFN columns.
Each attention and FFN block then ends in one all-reduce over the model
group (``reduce_from_model``, in fp32) and begins with its conjugate
(``copy_to_model``, the gradient's all-reduce), and each rank takes its
heads' slice of the position bias it computes from the whole table. The
fused FFN runs its partial form there (no residual: the sum over the group
takes x once). The subtrees kept whole (the int8 encoder's, the W8A16
``step_q8``) run at full width on every rank with no collective; the cross
K/V cache of a whole-width decode step is gathered to every head once.
With whole weights nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..ops.decode_attention import cross_attention_decode
from ..ops.fused_attention_block import (
    INV_127,
    fused_oproj_residual_q8,
    fused_t5_ffn_q8,
    fused_t5_ffn_vjp,
    fused_t5_ln_qkv_q8,
    t5_attention_core_vjp,
    t5_bias_tiles,
)
from ..parallel.mesh import (
    Mesh,
    copy_to_model,
    gather_model,
    reduce_from_model,
    split_by_model,
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
    # training knob: each layer's activations recomputed in the backward
    # instead of kept; no effect on inference
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
    # decode-step cross-attention through the cross_attention_decode kernel
    # over the whole stacked cross K/V cache (not with int8_cross_kv)
    fused_decode_attention: bool = False
    # int8 cross K/V caches, per-(layer, row, head, channel) scales over the
    # encoder length, in the storage layout int8_kv_layout names:
    # "unmerged" (layers, B, L, H, kv), "merged" (layers, B, L, H*kv),
    # "transposed" (layers, B, H, kv, L), or None for auto ("transposed"
    # when the decode batch is 96 or more, else "unmerged"); the layouts
    # give the same values (_resolve_kv_layout)
    int8_cross_kv: bool = False
    int8_kv_layout: Optional[str] = None
    # encoder RMSNorm + FFN + residual through the fused_t5_ffn kernel
    fused_encoder_ffn: bool = False
    # weight-only int8 decode step (W8A16): the step's matmuls read
    # params["decoder"]["step_q8"] (quantize_decoder_step)
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


def _maybe_remat(cfg: T5Config, layer, x: torch.Tensor,
                 layer_p: Params) -> torch.Tensor:
    """``layer(x, layer_p)``; under ``cfg.remat`` with grad enabled, its
    activations are not kept but recomputed in the backward (JAX
    ``jax.checkpoint`` of the scan body, models/t5.py:753, :821). A layer's
    kernels then launch twice a step. The layers draw no random numbers, so
    no RNG state is kept for the recompute."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            layer, x, layer_p, use_reentrant=False, preserve_rng_state=False)
    return layer(x, layer_p)


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


def local_heads(w: torch.Tensor, cfg: T5Config) -> int:
    """The heads a q, k or v weight (.., D, heads * d_kv) holds: all of
    them, or this model rank's share."""
    return w.shape[-1] // cfg.d_kv


def _local_bias(bias: Optional[torch.Tensor], mesh: Optional[Mesh],
                heads: int, cfg: T5Config) -> Optional[torch.Tensor]:
    """This model rank's heads of a (.., H, Q, K) bias (one that has a head
    axis of all H); the bias itself with no split."""
    if mesh is None or bias is None or bias.shape[1] != cfg.num_heads:
        return bias
    first = mesh.model_rank * heads
    return bias[:, first:first + heads]


def _out_proj(y: torch.Tensor, w: torch.Tensor,
              mesh: Optional[Mesh]) -> torch.Tensor:
    """y · w, the product that closes a block: whole, in y's dtype (one
    rounding of the fp32 sum); split over a model axis, each rank's partial
    product in fp32 (the operands upcast, which is exact), summed over the
    model group in fp32 and rounded once to y's dtype, as the whole product
    is."""
    if mesh is None:
        return torch.matmul(y, w.to(y.dtype))
    partial = torch.matmul(y.float(), w.to(y.dtype).float())
    return reduce_from_model(partial, mesh).to(y.dtype)


def _attn_block(
    layer_p: Params, x: torch.Tensor, kv_src: torch.Tensor,
    bias: Optional[torch.Tensor], cfg: T5Config
) -> torch.Tensor:
    h = local_heads(layer_p["q"], cfg)
    mesh = split_by_model(h, cfg.num_heads)
    if mesh is not None:
        x_in = copy_to_model(x, mesh)
        kv_src = x_in if kv_src is x else copy_to_model(kv_src, mesh)
        x = x_in
        bias = _local_bias(bias, mesh, h, cfg)
    q = _project(x, layer_p["q"], h)
    k = _project(kv_src, layer_p["k"], h)
    v = _project(kv_src, layer_p["v"], h)
    out = _attention(q, k, v, bias, x.dtype)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    return _out_proj(out, layer_p["o"], mesh)


def _ffn_block(layer_p: Params, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    mesh = split_by_model(layer_p["wi_0"].shape[-1], cfg.d_ff)
    x = copy_to_model(x, mesh)
    hidden = gelu_new(torch.matmul(x, layer_p["wi_0"].to(x.dtype)))
    if cfg.is_gated_act:
        hidden = hidden * torch.matmul(x, layer_p["wi_1"].to(x.dtype))
    return _out_proj(hidden, layer_p["wo"], mesh)


def _encoder_ffn(layer_p: Params, y: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """RMS-norm + FFN + residual; int8 (the opt-in bulk-eval mode) when
    cfg.int8_encoder_ffn (the layer then carries "ffn_q8"), else through the
    fused_t5_ffn kernel when cfg.fused_encoder_ffn (JAX models/t5.py:342-369,
    the same precedence)."""
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
    if cfg.fused_encoder_ffn:
        ffn_p = layer_p["ffn"]
        mesh = split_by_model(ffn_p["wi_0"].shape[-1], cfg.d_ff)
        if mesh is not None:
            # the shard's partial product in fp32, summed over the model
            # group in fp32, y added once, one rounding
            partial = fused_t5_ffn_vjp(
                copy_to_model(y, mesh), layer_p["ln1"], ffn_p["wi_0"],
                ffn_p["wi_1"] if cfg.is_gated_act else None,
                ffn_p["wo"], cfg.layer_norm_epsilon, residual=False)
            return (y.float() + reduce_from_model(partial, mesh)).to(y.dtype)
        return fused_t5_ffn_vjp(
            y, layer_p["ln1"], ffn_p["wi_0"],
            ffn_p["wi_1"] if cfg.is_gated_act else None,
            ffn_p["wo"], cfg.layer_norm_epsilon,
        )
    ffn_in = rms_norm(y, layer_p["ln1"], cfg.layer_norm_epsilon)
    return y + _ffn_block(layer_p["ffn"], ffn_in, cfg)


def _matmul_w8(x: torch.Tensor, w8: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 matmul (JAX models/t5.py:387-403): (B, Q, K) x int8
    (K, F) with f32 (G, F) per-(contraction-group, output-channel) scales.
    Each group's partial product of x's values and the codes (both exact in
    fp32) is taken in fp32 with no rounding to x's dtype, then the scales
    apply in fp32 and the groups are summed. Returns (B, Q, F) fp32.

    The int8 codes are upcast at every call: a bf16 matmul would round
    each partial to bf16."""
    groups, f_dim = scale.shape
    k_dim = w8.shape[0]
    batch, qlen, _ = x.shape
    xg = x.float().reshape(batch * qlen, groups, k_dim // groups)
    part = torch.bmm(xg.transpose(0, 1),
                     w8.reshape(groups, k_dim // groups, f_dim).float())
    out = (part * scale.float()[:, None, :]).sum(dim=0)
    return out.reshape(batch, qlen, f_dim)


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
    Returns int8 (L, K, F) codes and f32 (L, G, F) scales.

    The JAX package quantizes in numpy, with true divisions: the scale is
    ``max(amax, 1e-8) / 127.0``. The divisor is a tensor here because
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal; so the codes and scales are bit-equal to JAX's on either
    device (as ``quantize_weight_i8``'s)."""
    w = w.float()
    layers, k_dim, f_dim = w.shape
    wg = w.reshape(layers, groups, k_dim // groups, f_dim)
    amax = torch.clamp(wg.abs().amax(dim=2), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
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


def quantize_decoder_step(params: Params, groups="auto",
                          drop_bf16: bool = False) -> Params:
    """Once: weight-only int8 quantization of every matmul of the decode
    step for cfg.int8_decoder_step (JAX models/t5.py:545-593): self-attn
    q/k/v/o, cross-attn q/o (the cross k/v feed the cache; int8 there is
    cfg.int8_cross_kv) and the decoder FFN wi_0/wi_1/wo, with the grouped
    scheme of quantize_encoder_ffn. Returns a NEW params dict whose
    ["decoder"]["step_q8"] holds them under the JAX key names ("self_q",
    "self_q_s", ..., "cross_o", "wi_0", ..., "wo_s").

    ``drop_bf16=True`` also removes the quantized bf16 weights from the
    decoder subtrees (cross-attn k/v, the norms and rel_bias stay): the
    decode step then reads no bf16 matmul weight."""
    dec = params["decoder"]
    q8 = {}
    dropped = {sub: set() for sub in ("self_attn", "cross_attn", "ffn")}
    for sub, names, prefix in (
        ("self_attn", ("q", "k", "v", "o"), "self_"),
        ("cross_attn", ("q", "o"), "cross_"),
        ("ffn", ("wi_0", "wi_1", "wo"), ""),
    ):
        for name in names:
            if name not in dec[sub]:
                continue  # the non-gated FFN has no wi_1
            w = dec[sub][name]
            q8[prefix + name], q8[prefix + name + "_s"] = _quant_stacked_i8(
                w, _pick_groups(w.shape[1], groups))
            dropped[sub].add(name)
    out = dict(params)
    out["decoder"] = dict(dec)
    if drop_bf16:
        for sub, names in dropped.items():
            out["decoder"][sub] = {
                k: v for k, v in dec[sub].items() if k not in names}
    out["decoder"]["step_q8"] = q8
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
    collect_hiddens: bool = False,
):
    """Returns encoder hidden states (B, L, D). With ``collect_hiddens``
    returns ``(final, per_layer (num_layers, B, L, D))``, each layer's
    output before the final norm (JAX models/t5.py:667-788), for the drift
    studies (tools/bf16_drift_study.py, tools/int8_drift_study.py)."""
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
        # the int8 projections are whole: every head on every rank
        heads = (cfg.num_heads if cfg.int8_encoder_attn
                 else local_heads(enc["self_attn"]["q"], cfg))
        mesh = split_by_model(heads, cfg.num_heads)
        # (H, L, L), shared by the batch; this rank's heads under a split
        pos_hll = _local_bias(pos_bias, mesh, heads, cfg)[0].contiguous()
        # the bf16 kernel's order of it, built once for every layer (the
        # fp32 kernel reads pos_hll as it is)
        bias_tiles = (t5_bias_tiles(pos_hll)
                      if pos_hll.is_cuda and x.dtype == torch.bfloat16
                      else None)
        key_mask = attention_mask.to(torch.int32).contiguous()

        def attention(q, k, v):
            return t5_attention_core_vjp(q, k, v, pos_hll, key_mask,
                                         heads, bias_tiles)

        def layer(x, layer_p):
            if cfg.int8_encoder_attn:
                a8 = layer_p["self_attn_q8"]
                q, k, v = fused_t5_ln_qkv_q8(
                    x, a8["ln"] if "ln" in a8 else layer_p["ln0"],
                    a8["q"], a8["q_s"], a8["k"], a8["k_s"],
                    a8["v"], a8["v_s"], eps=eps,
                )
                x = fused_oproj_residual_q8(x, attention(q, k, v), a8["o"],
                                            a8["o_s"])
                return _encoder_ffn(layer_p, x, cfg)
            p = layer_p["self_attn"]
            attn_in = copy_to_model(rms_norm(x, layer_p["ln0"], eps), mesh)
            attn = attention(torch.matmul(attn_in, p["q"].to(x.dtype)),
                             torch.matmul(attn_in, p["k"].to(x.dtype)),
                             torch.matmul(attn_in, p["v"].to(x.dtype)))
            x = x + _out_proj(attn, p["o"], mesh)
            return _encoder_ffn(layer_p, x, cfg)
    else:
        mask_bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
        bias = pos_bias + mask_bias  # (B, H, L, L) fp32

        def layer(x, layer_p):
            attn_in = rms_norm(x, layer_p["ln0"], eps)
            x = x + _attn_block(layer_p["self_attn"], attn_in, attn_in,
                                bias, cfg)
            return _encoder_ffn(layer_p, x, cfg)

    per_layer = []
    for i in range(cfg.num_encoder_layers):
        x = _maybe_remat(cfg, layer, x, _encoder_layer(enc, i, cfg))
        if collect_hiddens:
            per_layer.append(x)
    final = rms_norm(x, enc["final_ln"], eps)
    if collect_hiddens:
        return final, torch.stack(per_layer)
    return final


# ---------------------------------------------------------------------------
# Decoder, teacher forced (training loss)
# ---------------------------------------------------------------------------

def _decoder_scan(params: Params, cfg: T5Config, x: torch.Tensor,
                  encoder_hidden: torch.Tensor, self_bias: torch.Tensor,
                  cross_bias: torch.Tensor) -> torch.Tensor:
    """Every decoder layer over the whole target (JAX models/t5.py:799-829),
    then the final RMSNorm."""
    dec = params["decoder"]
    eps = cfg.layer_norm_epsilon

    def layer(y, layer_p):
        sa_in = rms_norm(y, layer_p["ln0"], eps)
        y = y + _attn_block(layer_p["self_attn"], sa_in, sa_in, self_bias,
                            cfg)
        ca_in = rms_norm(y, layer_p["ln1"], eps)
        y = y + _attn_block(layer_p["cross_attn"], ca_in, encoder_hidden,
                            cross_bias, cfg)
        ffn_in = rms_norm(y, layer_p["ln2"], eps)
        return y + _ffn_block(layer_p["ffn"], ffn_in, cfg)

    for i in range(cfg.num_decoder_layers):
        layer_p = {name: _layer(dec[name], i)
                   for name in ("self_attn", "cross_attn", "ffn")}
        layer_p.update({name: dec[name][i] for name in ("ln0", "ln1", "ln2")})
        x = _maybe_remat(cfg, layer, x, layer_p)
    return rms_norm(x, dec["final_ln"], eps)


def t5_decode(
    params: Params,
    cfg: T5Config,
    decoder_input_ids: torch.Tensor,
    encoder_hidden: torch.Tensor,
    encoder_mask: Optional[torch.Tensor] = None,
    decoder_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence (teacher-forced) decoding (JAX models/t5.py:842-885);
    returns fp32 logits (B, T, V). Refuses the params of
    ``quantize_decoder_step(drop_bf16=True)``, whose bf16 decoder weights
    are gone."""
    dec = params["decoder"]
    if "q" not in dec["self_attn"]:
        raise ValueError(
            "the bf16 decoder matmul weights were dropped by "
            "quantize_decoder_step(drop_bf16=True) — int8_decoder_step "
            "is an eval-only mode; teacher-forced passes (training loss "
            "/ rescoring) need the bf16 decoder, so disable "
            "tpu.int8_decoder_step for this run")
    x = embed_tokens(params, cfg, decoder_input_ids)
    batch, qlen, _ = x.shape
    dev = x.device
    if encoder_mask is None:
        encoder_mask = torch.ones((batch, encoder_hidden.shape[1]),
                                  dtype=torch.int32, device=dev)
    causal = torch.ones((qlen, qlen), dtype=torch.bool, device=dev).tril()
    self_bias = compute_position_bias(dec["rel_bias"], qlen, qlen,
                                      bidirectional=False, cfg=cfg)
    self_bias = self_bias + torch.where(causal[None, None], 0.0, NEG_INF)
    if decoder_mask is not None:
        self_bias = self_bias + torch.where(
            decoder_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    cross_bias = torch.where(encoder_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    hidden = _decoder_scan(params, cfg, x, encoder_hidden, self_bias,
                           cross_bias)
    return lm_logits(params, cfg, hidden)


def shift_right(labels: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Teacher-forcing decoder inputs from labels: the start token, then the
    labels but the last, -100 read as pad (JAX models/t5.py:1228-1237)."""
    clean = torch.where(labels == -100, cfg.pad_token_id, labels)
    start = torch.full_like(clean[:, :1], cfg.decoder_start_token_id)
    return torch.cat([start, clean[:, :-1]], dim=1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       token_count: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy over the positions whose label is not -100,
    from an fp32 log-softmax, divided by that count (at least 1). Returns
    (loss, count) (JAX models/t5.py:1240-1252). ``token_count`` divides
    instead of this batch's count: a data-parallel step passes the global
    batch's, so that the sum of the ranks' losses is the global batch's
    token-weighted loss."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(log_probs, -1, safe[..., None])[..., 0]
    count = valid.sum()
    divisor = count if token_count is None else token_count
    return -(token_ll * valid).sum() / divisor.clamp(min=1), count


def t5_forward_loss(
    params: Params,
    cfg: T5Config,
    labels: torch.Tensor,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    token_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Seq2seq cross-entropy of ``labels`` (the captioning objective, JAX
    models/t5.py:1255-1277): encode, decode the right-shifted labels
    teacher forced, ``cross_entropy_loss`` (divided by ``token_count``
    where it is given). With ``fused_encoder_attention`` /
    ``fused_encoder_ffn`` the encoder runs the kernels forward and their
    twins backward."""
    encoder_hidden = t5_encode(params, cfg, input_ids=input_ids,
                               inputs_embeds=inputs_embeds,
                               attention_mask=attention_mask)
    logits = t5_decode(params, cfg, shift_right(labels, cfg), encoder_hidden,
                       attention_mask)
    loss, _ = cross_entropy_loss(logits, labels, token_count)
    return loss


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

def _resolve_kv_layout(cfg: T5Config, batch: int) -> str:
    """The int8 cross-KV storage layout (T5Config.int8_kv_layout) for a
    decode batch of ``batch`` rows (JAX models/t5.py:888-901)."""
    if cfg.int8_kv_layout is not None:
        if cfg.int8_kv_layout not in ("unmerged", "merged", "transposed"):
            raise ValueError(
                f"int8_kv_layout must be unmerged|merged|transposed|None, "
                f"got {cfg.int8_kv_layout!r}")
        return cfg.int8_kv_layout
    return "transposed" if batch >= 96 else "unmerged"


def _quant_cross_kv(x: torch.Tensor, layout: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of one layer's (B, L, H, kv) cross K or V with
    per-(row, head, channel) scales over the length axis, in ``layout``.
    The scale is ``max(max|x| / 127, 1e-8)`` with the division as XLA
    compiles it (a product with the fp32 reciprocal of 127); the codes are
    a true division by it, rounded half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=1, keepdim=True) * INV_127,
                        min=1e-8)                        # (B, 1, H, kv)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    batch, length, heads, kv = q.shape
    if layout == "merged":
        return (q.reshape(batch, length, heads * kv),
                scale.reshape(batch, 1, heads * kv))
    if layout == "transposed":
        return q.permute(0, 2, 3, 1).contiguous(), scale
    return q, scale


def cross_kv_cache(params: Params, cfg: T5Config,
                   encoder_hidden: torch.Tensor,
                   layout_batch: Optional[int] = None,
                   out: Optional[Params] = None, row0: int = 0) -> Params:
    """The cross-attention K/V cache of every decoder layer (JAX
    models/t5.py:904-982): (layers, B, L, H, kv) in the compute dtype, or
    with cfg.int8_cross_kv int8 codes ("cross_k", "cross_v") and fp32
    scales ("cross_k_scale", "cross_v_scale") in the storage layout that
    ``_resolve_kv_layout`` picks for ``layout_batch`` rows (the encoder
    batch by default): unmerged (layers, B, L, H, kv) with (layers, B, 1,
    H, kv) scales; merged (layers, B, L, H*kv) with (layers, B, 1, H*kv);
    transposed (layers, B, H, kv, L) with (layers, B, 1, H, kv). Each
    layer's bf16 K and V are quantized as they are projected, so no
    (layers, ...) bf16 cache is held.

    With ``out`` (a dict), each layer's leaves are written into rows
    row0 .. row0 + B of (layers, layout_batch, ...) buffers in ``out``,
    allocated there by the first call: a chunked prefill fills one cache
    chunk by chunk. Returns the dict written."""
    cross = params["decoder"]["cross_attn"]
    h = local_heads(cross["k"], cfg)
    mesh = split_by_model(h, cfg.num_heads)
    # the whole-width W8A16 step reads every head: the split cache is
    # gathered to all of them, once
    gather = mesh is not None and cfg.int8_decoder_step
    batch = encoder_hidden.shape[0]
    total = batch if layout_batch is None else layout_batch
    cache = {} if out is None else out
    rows = slice(row0, row0 + batch) if out is not None else slice(None)

    def put(key: str, i: int, leaf: torch.Tensor) -> None:
        if key not in cache:
            cache[key] = leaf.new_empty(
                (cfg.num_decoder_layers, batch if out is None else total)
                + tuple(leaf.shape[1:]))
        cache[key][i, rows] = leaf

    layout = (_resolve_kv_layout(cfg, total) if cfg.int8_cross_kv
              else None)
    for i in range(cfg.num_decoder_layers):
        for name in ("k", "v"):
            proj = _project(encoder_hidden, cross[name][i], h)
            if gather:
                proj = gather_model(proj, mesh, dim=2)
            if layout is None:
                put(f"cross_{name}", i, proj)
                continue
            codes, scales = _quant_cross_kv(proj, layout)
            put(f"cross_{name}", i, codes)
            put(f"cross_{name}_scale", i, scales)
    return cache


def self_cache_heads(params: Params, cfg: T5Config) -> int:
    """The heads of the decode step's self-attention K/V on this rank:
    every head under the whole-width W8A16 step, else those its q weight
    holds."""
    if cfg.int8_decoder_step:
        return cfg.num_heads
    return local_heads(params["decoder"]["self_attn"]["q"], cfg)


def init_decode_cache(params: Params, cfg: T5Config,
                      encoder_hidden: torch.Tensor, max_len: int) -> Params:
    """Cache dict: cross-attn K/V precomputed once (``cross_kv_cache``);
    self-attn K/V are (num_layers, B, max_len, H, kv) buffers filled step
    by step (H this rank's heads under a model split). ``index`` is a host
    integer: the decode loop runs on the host."""
    batch = encoder_hidden.shape[0]
    shape = (cfg.num_decoder_layers, batch, max_len,
             self_cache_heads(params, cfg), cfg.d_kv)
    cache = {
        "self_k": torch.zeros(shape, dtype=cfg.dtype,
                              device=encoder_hidden.device),
        "self_v": torch.zeros(shape, dtype=cfg.dtype,
                              device=encoder_hidden.device),
        "index": 0,
    }
    cache.update(cross_kv_cache(params, cfg, encoder_hidden))
    return cache


def _cross_attention_q8(cq: torch.Tensor, cache: Params, i: int,
                        layout: str, cross_bias: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Layer ``i``'s scale-folded int8 cross-attention (JAX
    models/t5.py:1109-1173): q.(k8 ks) = (q ks).k8 and P.(v8 vs) =
    (P.v8) vs, so the codes enter both products as they are (exact in
    bf16) and the products accumulate in fp32 with no rounding of the
    scores. (B, 1, H, kv) in ``dtype``.

    The codes are upcast to fp32 for each product: a bf16 matmul would
    round its output."""
    k8, v8 = cache["cross_k"][i], cache["cross_v"][i]
    ks, vs = cache["cross_k_scale"][i], cache["cross_v_scale"][i]
    batch, _, heads, kv = cq.shape
    if layout == "merged":
        k8, v8 = (t.reshape(batch, -1, heads, kv) for t in (k8, v8))
        ks, vs = (t.reshape(batch, 1, heads, kv) for t in (ks, vs))
    q_scaled = (cq.float() * ks.float()).to(dtype).float()
    if layout == "transposed":   # (B, H, kv, L)
        logits = torch.einsum("bqhd,bhdk->bhqk", q_scaled, k8.float())
    else:                        # (B, L, H, kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q_scaled, k8.float())
    weights = torch.softmax(logits + cross_bias, dim=-1).to(dtype).float()
    if layout == "transposed":
        pv = torch.einsum("bhqk,bhdk->bqhd", weights, v8.float())
    else:
        pv = torch.einsum("bhqk,bkhd->bqhd", weights, v8.float())
    return (pv * vs.float()).to(dtype)


def t5_decode_step(
    params: Params,
    cfg: T5Config,
    token: torch.Tensor,         # (B,) current decoder token
    cache: Params,
    encoder_mask: torch.Tensor,  # (B, Lenc)
) -> Tuple[torch.Tensor, Params]:
    """One incremental decode step (JAX models/t5.py:1003-1222). Returns
    (fp32 logits (B, V), cache).

    Unlike the JAX step, which returns a new cache, this writes the step's
    self-attention K/V into the cache's buffers in place (no copy of the
    (layers, B, max_len, H, kv) buffers per step) and returns the same
    dict with ``index`` advanced.

    The cross-attention takes the cross_attention_decode kernel when
    cfg.fused_decode_attention, the scale-folded int8 products when
    cfg.int8_cross_kv, else the plain fp32 attention. With
    cfg.int8_decoder_step every matmul of the step reads the int8
    ``step_q8`` weights (W8A16, ``_matmul_w8``) and no bf16 matmul weight,
    so the tree may have had them dropped (quantize_decoder_step's
    drop_bf16)."""
    dec = params["decoder"]
    eps = cfg.layer_norm_epsilon
    h = self_cache_heads(params, cfg)
    # the W8A16 step is whole; bf16 weights may be split over a model axis
    mesh = split_by_model(h, cfg.num_heads)
    if cfg.fused_decode_attention and cfg.int8_cross_kv:
        raise ValueError(
            "int8_cross_kv is implemented for the default (unfused) decode "
            "path only; disable fused_decode_attention")
    use_q8 = cfg.int8_decoder_step
    if use_q8 and "step_q8" not in dec:
        raise ValueError(
            "int8_decoder_step requires params['decoder']['step_q8'] "
            "(models.t5.quantize_decoder_step)")
    q8 = dec.get("step_q8")
    x = embed_tokens(params, cfg, token[:, None])  # (B, 1, D)
    batch, dtype = x.shape[0], x.dtype
    index = cache["index"]
    self_k, self_v = cache["self_k"], cache["self_v"]
    max_len = self_k.shape[2]

    def proj(y: torch.Tensor, sub: str, name: str, q8_name: str,
             i: int) -> torch.Tensor:
        """(B, Q, D_in) through layer i's weight: W8A16 or bf16."""
        if use_q8:
            out = _matmul_w8(y, q8[q8_name][i], q8[q8_name + "_s"][i])
            return out.to(dtype)
        return torch.matmul(y, dec[sub][name][i].to(dtype))

    def proj_out(y: torch.Tensor, sub: str, q8_name: str,
                 i: int) -> torch.Tensor:
        """The out-projection of a sublayer: W8A16, or its bf16 weight's
        product closing the block (summed over a model axis)."""
        if use_q8:
            return proj(y, sub, "o", q8_name, i)
        return _out_proj(y, dec[sub]["o"][i], mesh)

    def heads(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(y.shape[0], y.shape[1], h, -1)

    # self-attn bias: relative positions of the current step vs all cached
    # positions, plus invalidation of not-yet-written slots
    self_bias = compute_position_bias(
        dec["rel_bias"], 1, max_len, bidirectional=False, cfg=cfg,
        query_offset=index,
    )
    pos_valid = torch.arange(max_len, device=x.device) <= index
    self_bias = self_bias + torch.where(pos_valid[None, None, None, :], 0.0,
                                        NEG_INF)
    self_bias = _local_bias(self_bias, mesh, h, cfg)
    cross_bias = torch.where(encoder_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    if cfg.fused_decode_attention:
        # (layers, B, L, H, kv) -> (layers, B, L, H*kv): a view; the kernel
        # offsets into the whole stacked cache by the layer index
        nl, _, lenc = cache["cross_k"].shape[:3]
        cross_k_flat = cache["cross_k"].view(nl, batch, lenc, -1)
        cross_v_flat = cache["cross_v"].view(nl, batch, lenc, -1)
        key_mask = encoder_mask.to(torch.int32).contiguous()
    elif cfg.int8_cross_kv:
        kv_layout = _resolve_kv_layout(cfg, batch)

    for i in range(cfg.num_decoder_layers):
        sa_in = rms_norm(x, dec["ln0"][i], eps)
        q = heads(proj(sa_in, "self_attn", "q", "self_q", i))
        self_k[i, :, index] = heads(proj(sa_in, "self_attn", "k", "self_k",
                                         i))[:, 0]
        self_v[i, :, index] = heads(proj(sa_in, "self_attn", "v", "self_v",
                                         i))[:, 0]
        attn = _attention(q, self_k[i], self_v[i], self_bias, dtype)
        x = x + proj_out(attn.reshape(batch, 1, -1), "self_attn", "self_o",
                         i)

        ca_in = rms_norm(x, dec["ln1"][i], eps)
        cq = heads(proj(ca_in, "cross_attn", "q", "cross_q", i))
        if cfg.fused_decode_attention:
            cattn = cross_attention_decode(
                cq.reshape(batch, -1), cross_k_flat, cross_v_flat, key_mask,
                i, h)
        elif cfg.int8_cross_kv:
            cattn = _cross_attention_q8(cq, cache, i, kv_layout, cross_bias,
                                        dtype)
        else:
            cattn = _attention(cq, cache["cross_k"][i], cache["cross_v"][i],
                               cross_bias, dtype)
        x = x + proj_out(cattn.reshape(batch, 1, -1), "cross_attn",
                         "cross_o", i)

        ffn_in = rms_norm(x, dec["ln2"][i], eps)
        if use_q8:
            hidden = gelu_new(_matmul_w8(ffn_in, q8["wi_0"][i],
                                         q8["wi_0_s"][i]).to(dtype))
            if cfg.is_gated_act:
                hidden = hidden * _matmul_w8(ffn_in, q8["wi_1"][i],
                                             q8["wi_1_s"][i]).to(dtype)
            x = x + _matmul_w8(hidden, q8["wo"][i], q8["wo_s"][i]).to(dtype)
        else:
            x = x + _ffn_block(_layer(dec["ffn"], i), ffn_in, cfg)
    hidden = rms_norm(x, dec["final_ln"], eps)
    logits = lm_logits(params, cfg, hidden)[:, 0]
    cache["index"] = index + 1
    return logits, cache
