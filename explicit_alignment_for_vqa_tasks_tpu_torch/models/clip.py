"""CLIP ViT image and text encoders in PyTorch.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/models/clip.py, with the
same parameter trees (the layers stacked on a leading axis) and the same
layout: NHWC images, patch embedding as a patch reshape and one matmul,
pre-LN blocks with quickGELU, the post-LN on CLS and a linear projection;
the text tower with a causal mask and EOT pooling.

The default configuration is plain PyTorch, as the JAX package's is plain
XLA. ``fused_block`` runs the long-sequence ``split3`` block (the JAX
default for ViT-L/14@336, :201-235): three hand-written CUDA kernels,
``fused_ln_qkv``, ``attention_core_oproj`` and ``fused_mlp_block``
(``ops/fused_attention_block.py``, ``csrc/vit_block.cu``). Above 128 tokens
the ``split*`` variants (:237-271) and ``fused_attention`` (:310-330) run
the ``attention_core`` kernel, ``whole`` and ``whole_dd`` (:182-199) the
``fused_vit_block`` kernel, and ``cfg.int8`` (with the ``blocks_q8`` tree
of ``quantize_vision_blocks``) runs ``fused_qkv_q8``, ``attention_core``
and ``fused_mlp_block_q8`` (:532-579, ``csrc/vit_block_q8.cu``). At 128
tokens or fewer (ViT-B/32's 50) ``fused_block`` runs ``fused_vit_block``
(:273-291), ``fused_attention`` the ``fused_attention_block`` kernel
(:295-309) and ``cfg.int8`` ``fused_vit_block_q8`` (:497-530).
``use_pallas`` (below those branches, as in JAX :356-359) runs the plain
block with the ``flash_attention`` kernel (``ops/attention.py``,
``csrc/flash_attention.cu``) in place of the fp32 attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import DeviceLike
from ..ops import fused_attention_block as fab
from ..ops.attention import flash_attention

Params = Dict[str, Any]
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024           # hidden size
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    projection_dim: int = 768
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # bf16 attention logits and PV (the JAX package's bulk-extraction
    # option); fp32 logits by default
    fast_attention: bool = False
    # the legacy fused attention block: above 128 tokens the attention
    # core kernel; at 128 or fewer fused_attention_block
    fused_attention: bool = False
    # fused encoder blocks: at sequences longer than 128 "" and "split3" run
    # the three split3 kernels, "split", "split_c2", "split_fe" and
    # "split_c2fe" the attention core kernel and fused_mlp_block, "whole"
    # and "whole_dd" fused_vit_block; at 128 or fewer "split3" runs the
    # split3 kernels and any other name fused_vit_block ("whole_fe" with its
    # exponential in bf16)
    fused_block: bool = False
    fused_block_group: int = 0   # images per TPU program; 0 = auto
    fused_block_long: str = ""
    # the int8 blocks (params["blocks_q8"] from quantize_vision_blocks):
    # fused_vit_block_q8 at 128 tokens or fewer, the long int8 path above
    int8: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @classmethod
    def vit_l_14_336(cls, **kw) -> "CLIPVisionConfig":
        return cls(**kw)

    @classmethod
    def vit_b_32(cls, **kw) -> "CLIPVisionConfig":
        cfg = dict(image_size=224, patch_size=32, width=768, num_layers=12,
                   num_heads=12, projection_dim=512)
        cfg.update(kw)
        return cls(**cfg)

    @classmethod
    def small_test(cls, **kw) -> "CLIPVisionConfig":
        cfg = dict(image_size=28, patch_size=14, width=32, num_layers=2,
                   num_heads=4, projection_dim=16, dtype=torch.float32)
        cfg.update(kw)
        return cls(**cfg)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    projection_dim: int = 768
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def small_test(cls, **kw) -> "CLIPTextConfig":
        cfg = dict(vocab_size=96, context_length=16, width=32, num_layers=2,
                   num_heads=4, projection_dim=16, dtype=torch.float32)
        cfg.update(kw)
        return cls(**cfg)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(fab.QUICK_GELU_ALPHA * x)


def _layer_norm(x, scale, bias, eps):
    """LayerNorm in fp32 in JAX ``_layer_norm``'s order (the mean, the mean
    of squared deviations, ``(x - m) * rsqrt(var + eps)``, ``* scale +
    bias``), cast back to x's dtype; not ``F.layer_norm``."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _fused_group(batch: int) -> int:
    for g in (4, 2, 1):
        if batch % g == 0:
            return g
    return 1


def _linear(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ w in dt: fp32 accumulation, one rounding to dt (the JAX einsum
    with ``preferred_element_type=float32`` then ``astype(dt)``)."""
    return torch.matmul(x, w.to(dt))


def _split3_block(layer_p, x, num_heads, eps, group):
    head_dim = x.shape[-1] // num_heads
    q, k, v = fab.fused_ln_qkv(
        x, layer_p["ln1_scale"], layer_p["ln1_bias"],
        layer_p["q"], layer_p["q_bias"],
        layer_p["k"], layer_p["k_bias"],
        layer_p["v"], layer_p["v_bias"],
        scale=head_dim ** -0.5, group=group, eps=eps,
    )
    y = fab.attention_core_oproj(
        x, q, k, v, layer_p["o"], layer_p["o_bias"],
        num_heads=num_heads, group=group,
    )
    return fab.fused_mlp_block(
        y, layer_p["ln2_scale"], layer_p["ln2_bias"],
        layer_p["mlp_fc"], layer_p["mlp_fc_bias"],
        layer_p["mlp_proj"], layer_p["mlp_proj_bias"],
        group=group, eps=eps,
    )


def _whole_block(layer_p, x, num_heads, eps, group, deferred_div=False,
                 fast_exp=False):
    return fab.fused_vit_block(
        x, *(layer_p[n] for n in (
            "ln1_scale", "ln1_bias", "q", "q_bias", "k", "k_bias", "v",
            "v_bias", "o", "o_bias", "ln2_scale", "ln2_bias", "mlp_fc",
            "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")),
        num_heads=num_heads, group=group, eps=eps, deferred_div=deferred_div,
        fast_exp=fast_exp)


# the long-sequence split variants (JAX :237-271): the attention core with
# the exponential in bf16 or not; "_c2" only splits the MLP program's rows
# in two for the TPU scheduler, which changes no value
SPLIT_VARIANTS = {"split": False, "split_c2": False, "split_fe": True,
                  "split_c2fe": True}


def _qkv(layer_p, ln1, dt):
    return tuple(_linear(ln1, layer_p[n], dt) + layer_p[n + "_bias"].to(dt)
                 for n in ("q", "k", "v"))


def _mlp(layer_p, x, eps):
    """x + MLP(LN2(x)) as the XLA path computes it."""
    dt = x.dtype
    ln2 = _layer_norm(x, layer_p["ln2_scale"], layer_p["ln2_bias"], eps)
    hidden = _linear(ln2, layer_p["mlp_fc"], dt)
    hidden = quick_gelu(hidden + layer_p["mlp_fc_bias"].to(dt))
    hidden = _linear(hidden, layer_p["mlp_proj"], dt)
    return x + hidden + layer_p["mlp_proj_bias"].to(dt)


def _core_attention(layer_p, x, num_heads, eps, fast_exp=False):
    """x + the attention half of the block with the attention core kernel
    (projections and out-projection as XLA runs them, JAX :251-265)."""
    dt = x.dtype
    head_dim = x.shape[-1] // num_heads
    ln1 = _layer_norm(x, layer_p["ln1_scale"], layer_p["ln1_bias"], eps)
    q, k, v = _qkv(layer_p, ln1, dt)
    attn = fab.attention_core(q * (head_dim ** -0.5), k, v, num_heads,
                              fast_exp=fast_exp)
    attn = _linear(attn, layer_p["o"], dt)
    return x + attn + layer_p["o_bias"].to(dt)


def _encoder_block(layer_p, x, bias, num_heads, eps, use_pallas=False,
                   fast_attention=False, fused_attention=False,
                   fused_block=False, fused_block_group=0,
                   fused_block_long=""):
    """One pre-LN block; the branches in the JAX ``_encoder_block``'s order
    (:175-391)."""
    dt = x.dtype
    seq = x.shape[1]
    head_dim = x.shape[-1] // num_heads

    if fused_block and bias is None:
        if seq > 128 and fused_block_long in ("whole", "whole_dd"):
            return _whole_block(layer_p, x, num_heads, eps, group=1,
                                deferred_div=fused_block_long == "whole_dd")
        if (seq > 128 and fused_block_long in ("", "split3")) or (
                seq <= 128 and fused_block_long == "split3"):
            group = 1 if seq > 128 else (
                fused_block_group or _fused_group(x.shape[0]))
            return _split3_block(layer_p, x, num_heads, eps, group)
        if seq > 128:
            if fused_block_long not in SPLIT_VARIANTS:
                # the JAX package runs any other name as "split"
                raise ValueError(
                    f"fused_block_long={fused_block_long!r} at {seq} tokens "
                    f"is none of '', 'split3', 'whole', 'whole_dd', "
                    f"{', '.join(map(repr, SPLIT_VARIANTS))}")
            x = _core_attention(layer_p, x, num_heads, eps,
                                SPLIT_VARIANTS[fused_block_long])
            return fab.fused_mlp_block(
                x, layer_p["ln2_scale"], layer_p["ln2_bias"],
                layer_p["mlp_fc"], layer_p["mlp_fc_bias"],
                layer_p["mlp_proj"], layer_p["mlp_proj_bias"],
                group=1, eps=eps)
        # 128 tokens or fewer: the whole block, its exponential in bf16 with
        # "whole_fe"
        return _whole_block(layer_p, x, num_heads, eps,
                            group=fused_block_group or _fused_group(x.shape[0]),
                            fast_exp=fused_block_long == "whole_fe")

    if fused_attention and bias is None:
        if seq <= 128:
            ln1 = _layer_norm(x, layer_p["ln1_scale"], layer_p["ln1_bias"],
                              eps)
            attn = fab.fused_attention_block(
                ln1, *(layer_p[n].to(dt) for n in (
                    "q", "q_bias", "k", "k_bias", "v", "v_bias", "o",
                    "o_bias")),
                num_heads=num_heads, group=_fused_group(x.shape[0]),
                block_diag=True)
            return _mlp(layer_p, x + attn, eps)
        return _mlp(layer_p, _core_attention(layer_p, x, num_heads, eps),
                    eps)

    ln1 = _layer_norm(x, layer_p["ln1_scale"], layer_p["ln1_bias"], eps)
    q, k, v = _qkv(layer_p, ln1, dt)
    batch, seq, _ = q.shape
    if use_pallas:
        # the flash_attention kernel on (B, L, H, dh) q, k, v; q scaled in
        # dt, the scale rounded to dt as JAX rounds a weakly typed scalar
        q, k, v = (t.reshape(batch, seq, num_heads, head_dim)
                   for t in (q, k, v))
        scale = torch.tensor(head_dim ** -0.5, dtype=dt, device=q.device)
        attn = flash_attention(q * scale, k, v, bias=bias)
        attn = _linear(attn.reshape(batch, seq, -1), layer_p["o"], dt)
        return _mlp(layer_p, x + attn + layer_p["o_bias"].to(dt), eps)

    def heads(t):  # (B, L, H*dh) -> (B, H, L, dh)
        return t.reshape(batch, seq, num_heads, head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if fast_attention and bias is None:
        # bf16 scores, the max-subtracted exp in fp32, bf16 PV
        s = torch.matmul(q * (head_dim ** -0.5), k.transpose(-1, -2)) \
            .to(torch.bfloat16)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp((s - m).float()).to(dt)
        weights = p / p.sum(dim=-1, keepdim=True)
        attn = torch.matmul(weights, v).to(torch.bfloat16).to(dt)
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits * (head_dim ** -0.5)
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.matmul(weights, v)
    attn = attn.transpose(1, 2).reshape(batch, seq, -1)
    attn = _linear(attn, layer_p["o"], dt)
    return _mlp(layer_p, x + attn + layer_p["o_bias"].to(dt), eps)


def _layers(blocks: Params):
    """The stacked layer tree, one layer's leaves at a time (the JAX scan)."""
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        yield {name: leaf[i] for name, leaf in blocks.items()}


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def _normal_init(gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
    def normal(shape, std=0.02):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(dtype)
    return normal


def _block_params(normal, n: int, w: int, d_ff: int, dtype, device) -> Params:
    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "ln1_scale": ones(n, w), "ln1_bias": zeros(n, w),
        "q": normal((n, w, w)), "q_bias": zeros(n, w),
        "k": normal((n, w, w)), "k_bias": zeros(n, w),
        "v": normal((n, w, w)), "v_bias": zeros(n, w),
        "o": normal((n, w, w)), "o_bias": zeros(n, w),
        "ln2_scale": ones(n, w), "ln2_bias": zeros(n, w),
        "mlp_fc": normal((n, w, d_ff)), "mlp_fc_bias": zeros(n, d_ff),
        "mlp_proj": normal((n, d_ff, w)), "mlp_proj_bias": zeros(n, w),
    }


def init_clip_vision_params(gen: torch.Generator, cfg: CLIPVisionConfig,
                            param_dtype: torch.dtype = torch.bfloat16,
                            device: DeviceLike = None) -> Params:
    """Random-init params with the JAX package's keys, shapes, stacked layer
    axis and standard deviations, drawn on ``gen`` (on ``device``, by
    default ``gen``'s device)."""
    dev = torch.device(device) if device is not None else gen.device
    normal = _normal_init(gen, param_dtype, dev)
    w, n = cfg.width, cfg.num_layers
    return {
        "class_embedding": normal((w,)),
        "patch_embedding": normal(
            (cfg.patch_size, cfg.patch_size, 3, w), w ** -0.5),
        "position_embedding": normal((cfg.seq_len, w)),
        "pre_ln_scale": torch.ones((w,), dtype=param_dtype, device=dev),
        "pre_ln_bias": torch.zeros((w,), dtype=param_dtype, device=dev),
        "blocks": _block_params(normal, n, w, cfg.mlp_ratio * w, param_dtype,
                                dev),
        "post_ln_scale": torch.ones((w,), dtype=param_dtype, device=dev),
        "post_ln_bias": torch.zeros((w,), dtype=param_dtype, device=dev),
        "projection": normal((w, cfg.projection_dim), w ** -0.5),
    }


def quantize_vision_blocks(params: Params) -> Params:
    """Per-output-channel int8 quantization of each encoder block's
    projections, in fp32 on the params' device: the JAX ``blocks_q8`` tree
    (:435-460), layers stacked. q, k and v are concatenated into one (D, 3D)
    matrix (its per-column scales make that exact); ``o`` is quantized too,
    though only the short-sequence int8 block (``fused_vit_block_q8``) reads
    it. Codes and scales are bit-equal to JAX's (``fab.quantize_weight_i8``)."""
    blocks = params["blocks"]

    def stacked(w):  # (layers, d_in, d_out) -> int8 codes, fp32 scales
        pairs = [fab.quantize_weight_i8(w[i]) for i in range(w.shape[0])]
        return (torch.stack([q for q, _ in pairs]),
                torch.stack([s for _, s in pairs]))

    out: Params = {}
    out["qkv"], out["qkv_scale"] = stacked(torch.cat(
        [blocks[n].float() for n in ("q", "k", "v")], dim=-1))
    for name in ("o", "mlp_fc", "mlp_proj"):
        out[name], out[name + "_scale"] = stacked(blocks[name])
    return out


def _int8_blocks(params: Params, cfg: CLIPVisionConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """The long-sequence int8 blocks (JAX :532-579): fused_qkv_q8, the
    attention core, the bf16 out-projection, fused_mlp_block_q8."""
    dt = cfg.dtype
    head_dim = cfg.width // cfg.num_heads
    eps = cfg.layer_norm_epsilon
    q8 = params["blocks_q8"]
    for i, lp in enumerate(_layers(params["blocks"])):
        qkv_bias = torch.cat([lp["q_bias"], lp["k_bias"], lp["v_bias"]],
                             dim=-1)
        q, k, v = fab.fused_qkv_q8(
            x, lp["ln1_scale"], lp["ln1_bias"], q8["qkv"][i],
            q8["qkv_scale"][i], qkv_bias, scale=head_dim ** -0.5, eps=eps)
        attn = fab.attention_core(q, k, v, cfg.num_heads)
        attn = _linear(attn, lp["o"], dt)
        y = x + attn + lp["o_bias"].to(dt)
        x = fab.fused_mlp_block_q8(
            y, lp["ln2_scale"], lp["ln2_bias"], q8["mlp_fc"][i],
            q8["mlp_fc_scale"][i], lp["mlp_fc_bias"], q8["mlp_proj"][i],
            q8["mlp_proj_scale"][i], lp["mlp_proj_bias"], eps=eps)
    return x


def _int8_whole_blocks(params: Params, cfg: CLIPVisionConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """The int8 blocks at 128 tokens or fewer (JAX :497-530): one
    fused_vit_block_q8 a layer, every projection int8."""
    q8 = params["blocks_q8"]
    group = cfg.fused_block_group or _fused_group(x.shape[0])
    for i, lp in enumerate(_layers(params["blocks"])):
        qkv_bias = torch.cat([lp["q_bias"], lp["k_bias"], lp["v_bias"]],
                             dim=-1)
        x = fab.fused_vit_block_q8(
            x, lp["ln1_scale"], lp["ln1_bias"],
            q8["qkv"][i], q8["qkv_scale"][i], qkv_bias,
            q8["o"][i], q8["o_scale"][i], lp["o_bias"],
            lp["ln2_scale"], lp["ln2_bias"],
            q8["mlp_fc"][i], q8["mlp_fc_scale"][i], lp["mlp_fc_bias"],
            q8["mlp_proj"][i], q8["mlp_proj_scale"][i], lp["mlp_proj_bias"],
            num_heads=cfg.num_heads, group=group, eps=cfg.layer_norm_epsilon)
    return x


def patch_embed(params: Params, cfg: CLIPVisionConfig,
                images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, grid*grid, width) via reshape + matmul."""
    batch = images.shape[0]
    g, p = cfg.grid, cfg.patch_size
    x = images.to(cfg.dtype)
    x = x.reshape(batch, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(batch, g * g, p * p * 3)
    kernel = params["patch_embedding"].reshape(p * p * 3, cfg.width)
    return _linear(x, kernel, cfg.dtype)


def clip_encode_image(
    params: Params,
    cfg: CLIPVisionConfig,
    images: torch.Tensor,        # (B, H, W, 3) normalized NHWC
    project: bool = True,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Returns (B, projection_dim) image embeddings (CLS pooled):
    embeddings -> pre-LN -> transformer -> post-LN on CLS -> projection, as
    HF CLIPVisionModelWithProjection computes them."""
    if cfg.int8:
        if "blocks_q8" not in params:
            # the JAX package silently runs the bf16 blocks here (:497)
            raise ValueError(
                "CLIPVisionConfig.int8 needs params['blocks_q8'] "
                "(quantize_vision_blocks)")
    x = patch_embed(params, cfg, images)
    cls = params["class_embedding"].to(cfg.dtype)[None, None].expand(
        x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"].to(cfg.dtype)[None]
    x = _layer_norm(x, params["pre_ln_scale"], params["pre_ln_bias"],
                    cfg.layer_norm_epsilon)
    if cfg.int8 and cfg.seq_len <= 128:
        x = _int8_whole_blocks(params, cfg, x)
    elif cfg.int8:
        x = _int8_blocks(params, cfg, x)
    else:
        for layer_p in _layers(params["blocks"]):
            x = _encoder_block(
                layer_p, x, None, cfg.num_heads, cfg.layer_norm_epsilon,
                use_pallas=use_pallas, fast_attention=cfg.fast_attention,
                fused_attention=cfg.fused_attention,
                fused_block=cfg.fused_block,
                fused_block_group=cfg.fused_block_group,
                fused_block_long=cfg.fused_block_long,
            )
    pooled = _layer_norm(x[:, 0], params["post_ln_scale"],
                         params["post_ln_bias"], cfg.layer_norm_epsilon)
    if project and "projection" in params:
        pooled = _linear(pooled, params["projection"], pooled.dtype)
    return pooled


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------

def init_clip_text_params(gen: torch.Generator, cfg: CLIPTextConfig,
                          param_dtype: torch.dtype = torch.bfloat16,
                          device: DeviceLike = None) -> Params:
    """Random-init text params with the JAX package's keys and shapes."""
    dev = torch.device(device) if device is not None else gen.device
    normal = _normal_init(gen, param_dtype, dev)
    w, n = cfg.width, cfg.num_layers
    return {
        "token_embedding": normal((cfg.vocab_size, w)),
        "position_embedding": normal((cfg.context_length, w)),
        "blocks": _block_params(normal, n, w, 4 * w, param_dtype, dev),
        "final_ln_scale": torch.ones((w,), dtype=param_dtype, device=dev),
        "final_ln_bias": torch.zeros((w,), dtype=param_dtype, device=dev),
        "projection": normal((w, cfg.projection_dim), w ** -0.5),
    }


def clip_encode_text(
    params: Params,
    cfg: CLIPTextConfig,
    input_ids: torch.Tensor,     # (B, L); EOT = the max id's position
    project: bool = True,
) -> torch.Tensor:
    """Returns (B, projection_dim) text embeddings (EOT pooled)."""
    x = params["token_embedding"].to(cfg.dtype)[input_ids.long()]
    length = input_ids.shape[1]
    x = x + params["position_embedding"].to(cfg.dtype)[None, :length]
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=x.device).tril()
    bias = torch.where(causal[None, None], 0.0, NEG_INF)
    for layer_p in _layers(params["blocks"]):
        x = _encoder_block(layer_p, x, bias, cfg.num_heads,
                           cfg.layer_norm_epsilon)
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"],
                    cfg.layer_norm_epsilon)
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    if project and "projection" in params:
        pooled = _linear(pooled, params["projection"], pooled.dtype)
    return pooled


# ---------------------------------------------------------------------------
# Image preprocessing constants (OpenAI CLIP normalization)
# ---------------------------------------------------------------------------

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC (B, H, W, 3) -> normalized float NHWC."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std
