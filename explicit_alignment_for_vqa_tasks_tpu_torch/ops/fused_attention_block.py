"""The T5 encoder's and the CLIP ViT's kernels: each CUDA kernel with its
plain version.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py:

  * ``t5_attention_core`` (:1105-1180), kernel ``csrc/t5_attention_core.cu``
    over ``csrc/vit_attention_wgmma.cuh`` (bf16; two passes, any L) and,
    for fp32 q, k and v, over ``csrc/attention_f32.cuh`` (CUDA cores; where
    a block's score rows fit its shared memory, ``t5_f32_route``, q·kᵀ once
    into them and P·V from them, else two passes, any L);
  * the int8 bulk-eval trio ``fused_t5_ln_qkv_q8`` (:1635-1677),
    ``fused_oproj_residual_q8`` (:1695-1728) and ``fused_t5_ffn_q8``
    (:1547-1603), kernels in ``csrc/int8_encoder.cu``;
  * the encoder FFN ``fused_t5_ffn`` (:631-678; x and the output bf16 or
    fp32, the products bf16), kernel ``csrc/t5_ffn.cu``;
  * the CLIP ViT ``split3`` block: ``fused_ln_qkv`` (:268-298),
    ``attention_core_oproj`` (:348-376) and ``fused_mlp_block``
    (:419-459), kernels in ``csrc/vit_block.cu`` (``fused_ln_qkv``'s q | k
    | v product on ``csrc/bf16_gemm_tma.cuh``);
  * the CLIP ViT long-sequence attention ``attention_core`` (:203-232,
    optional bf16 exp), kernel in ``csrc/vit_block.cu``. Its attention and
    ``attention_core_oproj``'s are ``csrc/vit_attention_wgmma.cuh``
    (``wgmma`` and TMA, two passes over the keys, any L); on fp32
    activations ``csrc/attention_f32.cuh`` (``vit_f32_route`` picks its
    route). The split3 kernels and ``attention_core`` take bf16 or fp32
    activations, the vectors and weights as ``_vit_form`` reads them;
  * the int8 ViT long-sequence block: ``fused_qkv_q8`` (:559-593) and
    ``fused_mlp_block_q8`` (:495-527), kernels in ``csrc/vit_block_q8.cu``,
    with ``quantize_weight_i8`` (:690-699), the host quantizer of their
    weights;
  * the CLIP ViT whole blocks: ``fused_vit_block`` (:1349-1414, also the
    long ``whole`` / ``whole_dd`` variants; bf16 or fp32 x, the vectors as
    ``_vit_form`` reads them), kernel in ``csrc/vit_whole_block.cu``, its
    attention ``csrc/vit_attention.cuh``; ``fused_attention_block``
    (:1417-1462, with ``block_diag`` and without, in fp32 or bf16
    ``compute_dtype``; x and the weights bf16 or fp32, fp32 products as
    exact bf16 planes; any length, its fp32 attention past 128 tokens on
    ``csrc/attention_f32.cuh``), kernel in ``csrc/attention_block.cu``; the
    int8 ``fused_vit_block_q8`` (:772-826), kernel in
    ``csrc/vit_block_q8.cu``, its attention ``csrc/vit_attention.cuh``;
  * the GPT-2 whole block ``fused_gpt2_block`` (:898-958), kernel
    ``csrc/gpt2_block.cu`` over the same attention with its causal key
    mask.

Each source's note gives the design and the bound.

Every kernel computes a forward pass only, as every Pallas kernel of the
JAX package does. Three of them have autograd forms, the counterparts of
JAX's ``custom_vjp``s: ``t5_attention_core_vjp``, ``fused_t5_ffn_vjp`` and
``fused_gpt2_block_vjp``, each a ``torch.autograd.Function`` whose forward
calls the wrapper and whose backward differentiates the port's copy of
JAX's XLA twin (``_t5_attention_reference``, ``_t5_ffn_reference``,
``_gpt2_block_reference``). The CUDA path of every wrapper raises when grad
is enabled and an input requires it (``kernels.refuse_grad``), so no kernel
output is silently cut from the graph.

The attention core's plain version follows the Pallas kernel's order of
rounding, not that of the JAX package's XLA twin ``_t5_attention_reference``:
the kernel casts the unnormalised probabilities to the input dtype before
PV, sums the denominator from those cast values and divides after PV. In
bf16 that order gives the kernel's results bit for bit, where the XLA twin's
order (normalise in fp32, then PV) differs by up to a bf16 ulp.

The int8 plain versions follow the Pallas kernels' order of rounding too:
fp32 RMSNorm ``(x * rsqrt(mean(x^2) + eps)) * w``; per-(row, group)
activation scales ``max(amax, 1e-6) * (1/127)`` (the division by 127 as XLA
compiles it) and codes ``clip(round_half_even(h / scale), +-127)`` (a true
division); each group's exact integer product in fp32, then
``(p * hs) * s_g``, the groups added in order; one cast to the output dtype
at the end.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels

NEG_INF = -1e9
_SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
# the fp32 attention of csrc/attention_f32.cuh: whole 64-dim groups a head
_F32_HEAD_DIMS = (64, 128)
# its held route's query rows a block, keys a ring slot, ring slots, floats
# past the last tile a score row, and the most shared memory a block gets
_F32_HELD_ROWS, _F32_HELD_TILE, _F32_HELD_SLOTS, _F32_HELD_PAD = 64, 64, 4, 8
_F32_MAX_SMEM = 232448
_F32_EV_ALIGN = 1024  # the E·V planes' swizzle period (attention_f32.cuh)
_max_len_cache: dict = {}


def t5_attention_core_plain(
    q: torch.Tensor,         # (B, L, H*dh) — UNSCALED (T5 convention)
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,  # (H, L, L) fp32 relative-position bias
    mask: torch.Tensor,      # (B, L) key-validity mask
    num_heads: int,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in the kernel's order."""
    batch, seq, width = q.shape
    head_dim = width // num_heads

    def heads(x):  # (B, L, H*dh) -> (B, H, L, dh) in fp32 (exact for bf16)
        return x.reshape(batch, seq, num_heads, head_dim).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    s = s + pos_bias.float()[None]
    s = s + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(q.dtype)                 # UNNORMALISED
    denom = p.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(p.float(), heads(v)) / denom
    return o.to(q.dtype).transpose(1, 2).reshape(batch, seq, width)


def _launcher(symbol: str):
    fn = getattr(kernels.load("t5_attention_core"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# The kernel's bias blocks: 64 query rows x 64 keys, two a 128-query tile.
T5_BIAS_BLOCK = 64


def t5_bias_tiles(pos_bias: torch.Tensor) -> torch.Tensor:
    """The (H, L, L) fp32 position bias in the order the kernel reads it:
    for each head, 64-query block (an even number of them) and 64-key tile,
    a 16 KB block holding each consumer thread's 32 values together, zero
    past L. In the block, thread 32 w + 4 gid + tig of a warpgroup (wgmma's
    accumulator layout) holds rows 16 w + gid + 8 half and columns 8 g + 2
    tig + e as its values 4 g + 2 half + e, and value 4 g + x of thread t
    sits at float 4 (128 g + t) + x. The encoder builds it once a call and
    shares it across its layers (47 MB at 32 heads and 557 tokens)."""
    heads, q_len, k_len = pos_bias.shape
    size = T5_BIAS_BLOCK
    blocks = -(-q_len // (2 * size)) * 2
    tiles = -(-k_len // size)
    padded = torch.zeros((heads, blocks * size, tiles * size),
                         dtype=torch.float32, device=pos_bias.device)
    padded[:, :q_len, :k_len] = pos_bias
    # (h, block, w, half, gid, tile, g, tig, e) ->
    # (h, block, tile, g, w, gid, tig, half, e)
    return padded.view(heads, blocks, 4, 2, 8, tiles, 8, 4, 2).permute(
        0, 1, 5, 6, 2, 4, 7, 3, 8).contiguous()


def t5_f32_held_smem_bytes(seq: int, head_dim: int) -> int:
    """The shared memory of the fp32 kernel's held route for ``seq`` keys
    (``held_smem_bytes`` of ``csrc/attention_f32.cuh``): Q's rows, the ring
    of K / V tiles and the score rows over whole key tiles, fp32."""
    keys = -(-seq // _F32_HELD_TILE) * _F32_HELD_TILE
    return 4 * (_F32_HELD_ROWS * head_dim
                + _F32_HELD_SLOTS * _F32_HELD_TILE * head_dim
                + _F32_HELD_ROWS * (keys + _F32_HELD_PAD))


def f32_attention_held(seq: int, head_dim: int) -> bool:
    """Whether the fp32 attention of ``csrc/attention_f32.cuh`` takes its
    held route at ``seq`` keys: where the score rows fit a block's shared
    memory; the two-pass route (any length) past that. The held launcher
    refuses the lengths it cannot hold, so the two limits cannot part."""
    return t5_f32_held_smem_bytes(seq, head_dim) <= _F32_MAX_SMEM


def f32_held_ks_smem_bytes(seq: int) -> int:
    """The shared memory of the held route with K in the score rows
    (``held_ks_smem_bytes`` of ``csrc/attention_f32.cuh``, head size 64):
    the region that holds Q during q·kᵀ and V's tiles and bf16 planes
    during E·V, the score rows, and the bytes that start the region on the
    planes' swizzle period."""
    keys = -(-seq // _F32_HELD_TILE) * _F32_HELD_TILE
    return 4 * (_F32_HELD_SLOTS * _F32_HELD_TILE * _F32_HELD_TILE
                + _F32_HELD_ROWS * (keys + _F32_HELD_PAD)) + _F32_EV_ALIGN


# the routes of the ViT kernels' fp32 attention (the launchers' ``route``)
F32_TWO_PASS, F32_HELD, F32_HELD_KS = 0, 1, 2


def vit_f32_route(seq: int, head_dim: int) -> int:
    """The route of ``attention_core``'s and ``attention_core_oproj``'s fp32
    attention at ``seq`` keys: the held route where it fits, else at head
    size 64 the held route with K in the score rows where that fits (up to
    640 keys: ViT-L/14@336's 577), else the two-pass route. Each held
    launcher refuses the lengths it cannot hold."""
    if f32_attention_held(seq, head_dim):
        return F32_HELD
    if head_dim == _F32_HELD_TILE and f32_held_ks_smem_bytes(seq) \
            <= _F32_MAX_SMEM:
        return F32_HELD_KS
    return F32_TWO_PASS


def t5_f32_route(seq: int, head_dim: int) -> str:
    """The launcher of ``t5_attention_core``'s fp32 form for length
    ``seq``: the held route or the two-pass one (``f32_attention_held``)."""
    if f32_attention_held(seq, head_dim):
        return "t5_attention_core_f32_held_launch"
    return "t5_attention_core_f32_launch"


def _kernel_max_len(lib: str, symbol: str, head_dim: int) -> int:
    """``symbol(head_dim)`` of kernel library ``lib``: the longest sequence
    whose (32, L) fp32 score tile fits the current card's shared memory."""
    key = (lib, symbol, head_dim)
    if key not in _max_len_cache:
        fn = getattr(kernels.load(lib), symbol)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        _max_len_cache[key] = fn(head_dim)
    return _max_len_cache[key]


def _check_kernel_inputs(q, k, v, pos_bias, mask, num_heads):
    tensors = {"q": q, "k": k, "v": v, "pos_bias": pos_bias, "mask": mask}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"t5_attention_core: {name} is on {t.device}, the kernel "
                f"needs every input on q's CUDA device ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"t5_attention_core: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(
                f"t5_attention_core: {name} is not 16-byte aligned")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"t5_attention_core: q is {q.dtype}; the kernel takes bfloat16 "
            "or float32")
    for name in ("k", "v"):
        if tensors[name].dtype != q.dtype:
            raise ValueError(
                f"t5_attention_core: {name} is {tensors[name].dtype}, q is "
                f"{q.dtype}; the kernel takes q, k and v of one dtype")
    if pos_bias.dtype != torch.float32:
        raise ValueError(
            f"t5_attention_core: pos_bias is {pos_bias.dtype}, not float32")
    if mask.dtype != torch.int32:
        raise ValueError(f"t5_attention_core: mask is {mask.dtype}, not int32")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"t5_attention_core: q, k, v must share one (B, L, H*dh) shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    batch, seq, width = q.shape
    if width % num_heads:
        raise ValueError(
            f"t5_attention_core: width {width} is not a multiple of "
            f"{num_heads} heads")
    head_dim = width // num_heads
    dims = _F32_HEAD_DIMS if q.dtype == torch.float32 else _SUPPORTED_HEAD_DIMS
    if head_dim not in dims:
        raise ValueError(
            f"t5_attention_core: head size {head_dim} is not one of {dims} "
            f"({q.dtype})")
    if tuple(pos_bias.shape) != (num_heads, seq, seq):
        raise ValueError(
            f"t5_attention_core: pos_bias is {tuple(pos_bias.shape)}, "
            f"expected {(num_heads, seq, seq)}")
    if tuple(mask.shape) != (batch, seq):
        raise ValueError(
            f"t5_attention_core: mask is {tuple(mask.shape)}, expected "
            f"{(batch, seq)}")
    return head_dim


def t5_attention_core(
    q: torch.Tensor,         # (B, L, H*dh) — UNSCALED (T5 convention)
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,  # (H, L, L) fp32
    mask: torch.Tensor,      # (B, L) int32 key-validity mask
    num_heads: int,
    bias_tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """T5 encoder self-attention core: scores + position bias + key mask +
    softmax + PV. CPU tensors take the plain version; CUDA tensors launch
    the kernel (``t5_attention_core.launches`` counts those launches, of
    either form) or raise. bf16 q, k, v take the tensor-core kernel, which
    reads the bias as ``t5_bias_tiles(pos_bias)``: the caller may pass it
    (the encoder builds it once for its layers), and it is made here
    otherwise. fp32 q, k, v take the CUDA-core kernel, which reads
    ``pos_bias`` as it is (no ``bias_tiles``), by the route that
    ``t5_f32_route`` gives for L."""
    if q.device.type == "cpu":
        return t5_attention_core_plain(q, k, v, pos_bias, mask, num_heads)
    kernels.refuse_grad("t5_attention_core", q, k, v, pos_bias,
                        vjp="t5_attention_core_vjp")
    batch, seq, _ = q.shape
    head_dim = _check_kernel_inputs(q, k, v, pos_bias, mask, num_heads)
    if q.dtype == torch.float32:
        if bias_tiles is not None:
            raise ValueError(
                "t5_attention_core: bias_tiles is the bf16 kernel's layout; "
                "the fp32 kernel reads pos_bias as it is")
        symbol, bias = t5_f32_route(seq, head_dim), pos_bias
    else:
        if bias_tiles is None:
            bias_tiles = t5_bias_tiles(pos_bias)
        blocks = -(-seq // (2 * T5_BIAS_BLOCK)) * 2
        tiles = -(-seq // T5_BIAS_BLOCK)
        _check_tensors("t5_attention_core", q.device,
                       {"bias_tiles": torch.float32}, bias_tiles=bias_tiles)
        _check_shapes("t5_attention_core", bias_tiles=(
            bias_tiles, (num_heads, blocks, tiles, 8, 4, 8, 4, 2, 2)))
        symbol, bias = "t5_attention_core_launch", bias_tiles
    out = torch.empty_like(q)
    rc = _launcher(symbol)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        mask.data_ptr(), out.data_ptr(), batch, seq, num_heads, head_dim,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"t5_attention_core kernel launch failed: cudaError {rc}")
    t5_attention_core.launches += 1
    return out


t5_attention_core.launches = 0


# ---------------------------------------------------------------------------
# The autograd forms: the kernel forward, the gradient through JAX's XLA twin
# ---------------------------------------------------------------------------

def _twin_grads(needs: Sequence[bool], inputs: Sequence[Optional[torch.Tensor]],
                twin, d_out: torch.Tensor) -> list:
    """The gradients of ``twin(*inputs)`` against ``d_out`` for the inputs
    whose ``needs`` is set, None for the others: the twin recomputed with
    grad on and differentiated by ``torch.autograd.grad``, as JAX's
    ``custom_vjp`` backward runs ``jax.vjp`` of it. Nothing is computed for
    an input that needs no gradient (the frozen LM's weights)."""
    leaves = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs)]
    wanted = [t for t, need in zip(leaves, needs) if need]
    if not wanted:
        return [None] * len(inputs)
    with torch.enable_grad():
        out = twin(*leaves)
    got = iter(torch.autograd.grad(out, wanted, d_out))
    return [next(got) if need else None for need in needs]


def _t5_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pos_bias: torch.Tensor, mask: torch.Tensor, num_heads: int,
    *, wide: torch.dtype = torch.float32,
) -> torch.Tensor:
    """JAX's XLA twin of the kernel (``_t5_attention_reference``,
    :1179-1197), which its custom VJP differentiates: scores, bias, key
    mask and softmax in ``wide`` (fp32), the normalised probabilities times
    V in ``wide``, one cast to q's dtype. Not the kernel's order of
    rounding (``t5_attention_core_plain`` casts the unnormalised
    probabilities before P·V and divides after it). ``wide`` is float64
    only in the gradient check."""
    batch, seq, width = q.shape
    head_dim = width // num_heads

    def split(x):
        return x.reshape(batch, seq, num_heads, head_dim).to(wide)

    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k))
    s = s + pos_bias[None].to(wide)
    s = s + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(wide)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
    return out.reshape(batch, seq, width).to(q.dtype)


class _T5AttentionCoreVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos_bias, mask, num_heads, bias_tiles):
        ctx.save_for_backward(q, k, v, pos_bias, mask)
        ctx.num_heads = num_heads
        return t5_attention_core(q, k, v, pos_bias, mask, num_heads,
                                 bias_tiles)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, pos_bias, mask = ctx.saved_tensors
        grads = _twin_grads(
            ctx.needs_input_grad[:4], (q, k, v, pos_bias),
            lambda q_, k_, v_, b_: _t5_attention_reference(
                q_, k_, v_, b_, mask, ctx.num_heads), d_out)
        return (*grads, None, None, None)


def t5_attention_core_vjp(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pos_bias: torch.Tensor, mask: torch.Tensor, num_heads: int,
    bias_tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable ``t5_attention_core`` (JAX ``t5_attention_core_vjp``,
    :1202-1234): the forward is the wrapper (the kernel on CUDA tensors,
    the plain version on the CPU); the backward recomputes through
    ``_t5_attention_reference`` and differentiates it, since the kernel
    never keeps the probabilities. No kernel runs in the backward. ``mask``
    gets no gradient; ``pos_bias`` gets one when it requires it."""
    return _T5AttentionCoreVJP.apply(q, k, v, pos_bias, mask, num_heads,
                                     bias_tiles)


# ---------------------------------------------------------------------------
# int8 T5 encoder (bulk eval): plain helpers
# ---------------------------------------------------------------------------

# The int8 kernels' tiles: a contraction group is a whole number of 64-deep
# k steps and the output width a whole number of 128-wide column tiles.
Q8_GROUP_MULTIPLE = 64
Q8_WIDTH_MULTIPLE = 128
# 1/127 as XLA folds it (in fp32; a Python float times an fp32 tensor is
# an fp32 product with this value rounded to fp32)
INV_127 = 1.0 / 127.0


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF gelu_new (tanh approximation) in the JAX kernels' order of
    operations; not ``F.gelu``, whose order of rounding differs."""
    return 0.5 * x * (
        1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x))
    )


def _rms_norm_f32(x32: torch.Tensor, ln_weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * ln_weight.float()


def _row_quant_i8(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of an fp32 (rows, K) tile.
    Returns (int8 codes, (rows, 1) fp32 dequant scales).

    The JAX kernels write ``max(amax, 1e-6) / 127.0``, which XLA compiles
    into a multiplication by the fp32 reciprocal of 127 (its algebraic
    simplifier folds a division by a constant); a true division differs by
    an ulp in about one row in twenty. So the scale here is that product,
    and the codes a true division by it, as XLA keeps them."""
    amax = torch.amax(torch.abs(h), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) * INV_127
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


def _group_quant_rows_i8(h: torch.Tensor, groups: int) -> list:
    """Per-(row, contraction-group) quantization: [(codes, scales)] for
    each of ``groups`` equal column slices of ``h``."""
    kg = h.shape[-1] // groups
    return [_row_quant_i8(h[:, g * kg:(g + 1) * kg]) for g in range(groups)]


def _mm_q8_grouped(parts: list, w: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """sum_g (hq_g @ W_g) * hs_g * s_g, accumulated in fp32 in group order.

    ``torch.matmul`` has no int8 path on CUDA, so the codes go to a float
    type: a group's products and partial sums are integers below
    K/G * 127^2, exact in fp32 (and under TF32, whose inputs hold any code
    exactly) while that is below 2^24, i.e. a group size of at most 1040.
    Larger groups multiply in float64."""
    kg = parts[0][0].shape[-1]
    exact = torch.float32 if kg * 127 * 127 < 2 ** 24 else torch.float64
    acc = None
    for g, (hq, hs) in enumerate(parts):
        p = torch.matmul(hq.to(exact), w[g * kg:(g + 1) * kg].to(exact))
        t = p.float() * hs * s[g].float()
        acc = t if acc is None else acc + t
    return acc


def _as_group_scales(s: torch.Tensor) -> torch.Tensor:
    """Accept legacy per-output-channel (F,) scales as 1 group."""
    return s.reshape(1, -1) if s.dim() == 1 else s


def _record_codes(codes_out: Optional[dict], prefix: str,
                  parts: list) -> None:
    """With ``codes_out`` given, set its ``<prefix>codes`` (rows, K) int8
    and ``<prefix>scales`` (rows, G) fp32 to the quantization ``parts``,
    joined as the kernels' scratch holds them."""
    if codes_out is not None:
        codes_out[prefix + "codes"] = torch.cat([q for q, _ in parts], dim=1)
        codes_out[prefix + "scales"] = torch.cat([s for _, s in parts], dim=1)


# ---------------------------------------------------------------------------
# int8 T5 encoder: plain versions
# ---------------------------------------------------------------------------

def fused_t5_ln_qkv_q8_plain(
    x: torch.Tensor,             # (B, L, D) pre-norm residual stream
    ln_weight: torch.Tensor,     # (D,) RMS-norm scale
    wq: torch.Tensor, sq: torch.Tensor,   # int8 (D, inner) + f32 (G, inner)
    wk: torch.Tensor, sk: torch.Tensor,
    wv: torch.Tensor, sv: torch.Tensor,
    eps: float = 1e-6,
    *, codes_out: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSNorm, one per-(row, group) quantization shared by Q, K and V,
    three grouped int8 products; (q, k, v) in x.dtype. ``codes_out``, when
    given, receives that quantization's ``codes`` and ``scales``."""
    batch, seq, d_model = x.shape
    g_in = _as_group_scales(sq).shape[0]
    h = _rms_norm_f32(x.reshape(-1, d_model).float(), ln_weight, eps)
    parts = _group_quant_rows_i8(h, g_in)
    _record_codes(codes_out, "", parts)
    return tuple(
        _mm_q8_grouped(parts, w, _as_group_scales(s))
        .reshape(batch, seq, -1).to(x.dtype)
        for w, s in ((wq, sq), (wk, sk), (wv, sv)))


def fused_oproj_residual_q8_plain(
    residual: torch.Tensor,      # (B, L, D) pre-attention stream
    attn: torch.Tensor,          # (B, L, inner) attention core output
    wo: torch.Tensor, so: torch.Tensor,   # int8 (inner, D) + f32 (G, D)
) -> torch.Tensor:
    """residual + attn @ Wo with attn quantized per (row, group), no norm;
    the fp32 residual is added before the one cast to residual.dtype."""
    batch, seq, inner = attn.shape
    so = _as_group_scales(so)
    parts = _group_quant_rows_i8(attn.reshape(-1, inner).float(), so.shape[0])
    y = _mm_q8_grouped(parts, wo, so)
    res = residual.reshape(batch * seq, -1).float()
    return (res + y).reshape(residual.shape).to(residual.dtype)


def fused_t5_ffn_q8_plain(
    x: torch.Tensor,             # (B, L, D) pre-norm residual stream
    ln_weight: torch.Tensor,     # (D,)
    wi_0: torch.Tensor, s_0: torch.Tensor,       # int8 (D, F) + f32 (G, F)
    wi_1: Optional[torch.Tensor], s_1: Optional[torch.Tensor],  # gate or None
    wo: torch.Tensor, s_o: torch.Tensor,         # int8 (F, D) + f32 (G', D)
    eps: float = 1e-6,
    *, codes_out: Optional[dict] = None,
) -> torch.Tensor:
    """x + FFN(RMSNorm(x)): wi_0 and wi_1 share one activation
    quantization; the hidden gelu(a0) * a1 stays fp32 and is requantized
    with the g_hid groups of s_o before wo. ``codes_out``, when given,
    receives the input's ``codes`` and ``scales`` and the hidden's
    ``hidden_codes`` and ``hidden_scales``."""
    batch, seq, d_model = x.shape
    s_0, s_o = _as_group_scales(s_0), _as_group_scales(s_o)
    x32 = x.reshape(-1, d_model).float()
    parts = _group_quant_rows_i8(_rms_norm_f32(x32, ln_weight, eps),
                                 s_0.shape[0])
    hid = _t5_ffn_q8_hidden(parts, wi_0, s_0, wi_1, s_1)
    hid_parts = _group_quant_rows_i8(hid, s_o.shape[0])
    _record_codes(codes_out, "", parts)
    _record_codes(codes_out, "hidden_", hid_parts)
    y = _mm_q8_grouped(hid_parts, wo, s_o)
    return (x32 + y).reshape(x.shape).to(x.dtype)


def _t5_ffn_q8_hidden(parts: list, wi_0: torch.Tensor, s_0: torch.Tensor,
                      wi_1: Optional[torch.Tensor],
                      s_1: Optional[torch.Tensor]) -> torch.Tensor:
    """The FFN's fp32 hidden from the input's quantization ``parts``:
    gelu(a0) * a1, or gelu(a0) without the gate."""
    hid = _tanh_gelu(_mm_q8_grouped(parts, wi_0, _as_group_scales(s_0)))
    if wi_1 is not None:
        hid = hid * _mm_q8_grouped(parts, wi_1, _as_group_scales(s_1))
    return hid


# ---------------------------------------------------------------------------
# int8 T5 encoder: wrappers around csrc/int8_encoder.cu
# ---------------------------------------------------------------------------

def _launcher_of(lib: str, name: str, n_ptrs: int, n_ints: int,
                 n_floats: int):
    """``<name>_launch`` of kernel library ``lib``, its ctypes signature
    (pointers, ints, floats, then the stream) declared."""
    fn = getattr(kernels.load(lib), name + "_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tensors(op: str, device: torch.device, dtypes: dict,
                   **tensors) -> None:
    """Every tensor on ``device`` (a CUDA device), contiguous, 16-byte
    aligned and of the dtype named for it."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{op}: {name} is on {t.device}, the kernel needs every "
                f"input on {device}")
        if t.dtype != dtypes[name]:
            raise ValueError(
                f"{op}: {name} is {t.dtype}; the kernel takes "
                f"{dtypes[name]} only")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")


def _check_q8_product(op: str, name: str, w: torch.Tensor, s: torch.Tensor,
                      k_dim: int, groups: int) -> None:
    """int8 (K, N) weights with (G, N) scales the kernel's tiles take."""
    if w.dim() != 2 or w.shape[0] != k_dim:
        raise ValueError(
            f"{op}: {name} is {tuple(w.shape)}, expected ({k_dim}, N)")
    if tuple(s.shape) != (groups, w.shape[1]):
        raise ValueError(
            f"{op}: {name}'s scales are {tuple(s.shape)}, expected "
            f"{(groups, w.shape[1])}")
    if k_dim % groups or (k_dim // groups) % Q8_GROUP_MULTIPLE:
        raise ValueError(
            f"{op}: {name}'s contraction {k_dim} in {groups} groups is not "
            f"a whole number of {Q8_GROUP_MULTIPLE}-deep k steps per group")
    if w.shape[1] % Q8_WIDTH_MULTIPLE:
        raise ValueError(
            f"{op}: {name}'s width {w.shape[1]} is not a multiple of "
            f"{Q8_WIDTH_MULTIPLE}")


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights as (N, K): the tensor cores' int8 product takes both
    operands with the contraction contiguous. A copy of a few MB a call."""
    return w.t().contiguous()


def _k_major_stacked(ws: Sequence[torch.Tensor],
                     ss: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Products of one input as ONE K-major (sum N, K) weight, the (K, N)
    weights' transposes stacked in order, with their (G, N) scales side by
    side as (G, sum N): the kernel's column tile n0 of the stacked product
    is column n0 - offset of the product it falls in. One copy a call, as
    _k_major's."""
    return (torch.cat([w.t() for w in ws]).contiguous(),
            torch.cat(list(ss), dim=1).contiguous())


# rows of each gate weight that alternate in the gated FFN's up-product: one
# 8-column chunk of the s8 loop's fragment layout
GATE_INTERLEAVE = 8


def _interleave_gate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, ...) a and b as one (2 N, ...) tensor whose rows alternate by
    GATE_INTERLEAVE: a's rows 8c .. 8c + 7, then b's same rows."""
    n = a.shape[0]
    return torch.stack(
        [a.reshape(n // GATE_INTERLEAVE, GATE_INTERLEAVE, *a.shape[1:]),
         b.reshape(n // GATE_INTERLEAVE, GATE_INTERLEAVE, *b.shape[1:])],
        dim=1).reshape(2 * n, *a.shape[1:])


def _k_major_gated(wi_0: torch.Tensor, s_0: torch.Tensor, wi_1: torch.Tensor,
                   s_1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated FFN's up-product as one K-major (2 F, D) weight with (G, 2
    F) scales: wi_0's and wi_1's output columns interleaved by eight, so
    that the kernel's thread holding a0 of a column holds its a1 too. The
    same per-call copy as _k_major's (no parameter changes layout)."""
    return (_interleave_gate(wi_0.t(), wi_1.t()).contiguous(),
            _interleave_gate(s_0.t(), s_1.t()).t().contiguous())


def _run(op: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {rc}")


_BF16, _I8, _F32 = torch.bfloat16, torch.int8, torch.float32


def _q8_activation_dtype(op: str, t: torch.Tensor,
                         name: str = "x") -> torch.dtype:
    """The int8 T5 kernels' activation dtype: bf16, or fp32 for the fp32
    forms (the JAX kernels take any dtype and write it)."""
    if t.dtype not in (_BF16, _F32):
        raise ValueError(f"{op}: {name} is {t.dtype}; the kernel takes "
                         "bfloat16 or float32")
    return t.dtype


def _q8_norm_scale(ln_weight: torch.Tensor,
                   act: torch.dtype) -> torch.Tensor:
    """The norm scale as the form reads it: bf16 for bf16 x; fp32 for fp32
    x, a bf16 scale widened (exact), as JAX reads it ``.astype(f32)``."""
    if act == _F32 and ln_weight.dtype == _BF16:
        return ln_weight.float()
    return ln_weight


def fused_t5_ln_qkv_q8(
    x: torch.Tensor, ln_weight: torch.Tensor,
    wq: torch.Tensor, sq: torch.Tensor,
    wk: torch.Tensor, sk: torch.Tensor,
    wv: torch.Tensor, sv: torch.Tensor,
    eps: float = 1e-6,
    *, codes_out: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMS-norm + the three int8 T5 attention input projections; q, k and
    v in x's dtype, bf16 or fp32 (the fp32 form: fp32 x, its norm scale
    read as fp32). CPU tensors take the plain version; CUDA tensors launch
    the kernel (``fused_t5_ln_qkv_q8.launches`` counts those calls, of
    either form) or raise. ``codes_out``, when given, receives the
    activation ``codes`` and ``scales`` (the kernel's scratch), as the
    plain version's does."""
    if x.device.type == "cpu":
        return fused_t5_ln_qkv_q8_plain(x, ln_weight, wq, sq, wk, sk, wv, sv,
                                        eps, codes_out=codes_out)
    kernels.refuse_grad("fused_t5_ln_qkv_q8", x, ln_weight, sq, sk, sv)
    op = "fused_t5_ln_qkv_q8"
    sq, sk, sv = (_as_group_scales(s) for s in (sq, sk, sv))
    act = _q8_activation_dtype(op, x)
    ln_weight = _q8_norm_scale(ln_weight, act)
    _check_tensors(
        op, x.device,
        dict(x=act, ln_weight=act, wq=_I8, wk=_I8, wv=_I8, sq=_F32,
             sk=_F32, sv=_F32),
        x=x, ln_weight=ln_weight, wq=wq, sq=sq, wk=wk, sk=sk, wv=wv, sv=sv)
    batch, seq, d_model = x.shape
    groups = sq.shape[0]
    if tuple(ln_weight.shape) != (d_model,):
        raise ValueError(f"{op}: ln_weight is {tuple(ln_weight.shape)}")
    for name, w, s in (("wq", wq, sq), ("wk", wk, sk), ("wv", wv, sv)):
        _check_q8_product(op, name, w, s, d_model, groups)
    if not wq.shape == wk.shape == wv.shape:
        raise ValueError(f"{op}: wq, wk and wv differ in shape")
    rows, inner = batch * seq, wq.shape[1]
    codes = torch.empty((rows, d_model), dtype=_I8, device=x.device)
    row_scales = torch.empty((rows, groups), dtype=_F32, device=x.device)
    q, k, v = (torch.empty((batch, seq, inner), dtype=act, device=x.device)
               for _ in range(3))
    w_qkv, s_qkv = _k_major_stacked((wq, wk, wv), (sq, sk, sv))
    _run(op, _launcher_of("int8_encoder", op, 9, 5, 1),
         x.data_ptr(), ln_weight.data_ptr(), w_qkv.data_ptr(),
         s_qkv.data_ptr(), codes.data_ptr(), row_scales.data_ptr(),
         q.data_ptr(), k.data_ptr(), v.data_ptr(), rows, d_model, inner,
         groups, int(act == _F32), eps,
         torch.cuda.current_stream(x.device).cuda_stream)
    fused_t5_ln_qkv_q8.launches += 1
    if codes_out is not None:
        codes_out.update(codes=codes, scales=row_scales)
    return q, k, v


def fused_oproj_residual_q8(
    residual: torch.Tensor, attn: torch.Tensor,
    wo: torch.Tensor, so: torch.Tensor,
) -> torch.Tensor:
    """residual + attn @ Wo with the product int8, in residual's dtype;
    attn and residual each bf16 or fp32 (the fp32 forms), as JAX's kernel
    takes them. CPU tensors take the plain version; CUDA tensors launch
    the kernel (``fused_oproj_residual_q8.launches``, any form) or
    raise."""
    if attn.device.type == "cpu":
        return fused_oproj_residual_q8_plain(residual, attn, wo, so)
    kernels.refuse_grad("fused_oproj_residual_q8", residual, attn, so)
    op = "fused_oproj_residual_q8"
    so = _as_group_scales(so)
    attn_dtype = _q8_activation_dtype(op, attn, "attn")
    res_dtype = _q8_activation_dtype(op, residual, "residual")
    _check_tensors(op, attn.device,
                   dict(residual=res_dtype, attn=attn_dtype, wo=_I8,
                        so=_F32),
                   residual=residual, attn=attn, wo=wo, so=so)
    batch, seq, inner = attn.shape
    groups = so.shape[0]
    _check_q8_product(op, "wo", wo, so, inner, groups)
    d_model = wo.shape[1]
    if tuple(residual.shape) != (batch, seq, d_model):
        raise ValueError(
            f"{op}: residual is {tuple(residual.shape)}, expected "
            f"{(batch, seq, d_model)}")
    rows = batch * seq
    codes = torch.empty((rows, inner), dtype=_I8, device=attn.device)
    row_scales = torch.empty((rows, groups), dtype=_F32, device=attn.device)
    out = torch.empty_like(residual)
    wo = _k_major(wo)
    _run(op, _launcher_of("int8_encoder", op, 7, 6, 0),
         residual.data_ptr(), attn.data_ptr(), wo.data_ptr(), so.data_ptr(),
         codes.data_ptr(), row_scales.data_ptr(), out.data_ptr(),
         rows, inner, d_model, groups, int(attn_dtype == _F32),
         int(res_dtype == _F32),
         torch.cuda.current_stream(attn.device).cuda_stream)
    fused_oproj_residual_q8.launches += 1
    return out


def fused_t5_ffn_q8(
    x: torch.Tensor, ln_weight: torch.Tensor,
    wi_0: torch.Tensor, s_0: torch.Tensor,
    wi_1: Optional[torch.Tensor], s_1: Optional[torch.Tensor],
    wo: torch.Tensor, s_o: torch.Tensor,
    eps: float = 1e-6,
    *, codes_out: Optional[dict] = None,
) -> torch.Tensor:
    """x + FFN(RMSNorm(x)) with every product int8 (gated when wi_1 is
    given), in x's dtype, bf16 or fp32 (the fp32 form: fp32 x, its norm
    scale read as fp32). CPU tensors take the plain version; CUDA tensors
    launch the kernel (``fused_t5_ffn_q8.launches``, either form) or raise.
    ``codes_out``, when given, receives the plain version's keys from the
    kernel's scratch."""
    if x.device.type == "cpu":
        return fused_t5_ffn_q8_plain(x, ln_weight, wi_0, s_0, wi_1, s_1, wo,
                                     s_o, eps, codes_out=codes_out)
    kernels.refuse_grad("fused_t5_ffn_q8", x, ln_weight, s_0, s_1, s_o)
    op = "fused_t5_ffn_q8"
    gated = wi_1 is not None
    s_0, s_o = _as_group_scales(s_0), _as_group_scales(s_o)
    act = _q8_activation_dtype(op, x)
    ln_weight = _q8_norm_scale(ln_weight, act)
    tensors = dict(x=x, ln_weight=ln_weight, wi_0=wi_0, s_0=s_0, wo=wo,
                   s_o=s_o)
    if gated:
        s_1 = _as_group_scales(s_1)
        tensors.update(wi_1=wi_1, s_1=s_1)
    _check_tensors(
        op, x.device,
        dict(x=act, ln_weight=act, wi_0=_I8, wi_1=_I8, wo=_I8, s_0=_F32,
             s_1=_F32, s_o=_F32),
        **tensors)
    batch, seq, d_model = x.shape
    g_in, g_hid = s_0.shape[0], s_o.shape[0]
    if tuple(ln_weight.shape) != (d_model,):
        raise ValueError(f"{op}: ln_weight is {tuple(ln_weight.shape)}")
    _check_q8_product(op, "wi_0", wi_0, s_0, d_model, g_in)
    d_ff = wi_0.shape[1]
    if gated:
        _check_q8_product(op, "wi_1", wi_1, s_1, d_model, g_in)
        if wi_1.shape != wi_0.shape:
            raise ValueError(f"{op}: wi_0 and wi_1 differ in shape")
    _check_q8_product(op, "wo", wo, s_o, d_ff, g_hid)
    if wo.shape[1] != d_model:
        raise ValueError(f"{op}: wo is {tuple(wo.shape)}, expected "
                         f"({d_ff}, {d_model})")
    rows, dev = batch * seq, x.device
    codes_in = torch.empty((rows, d_model), dtype=_I8, device=dev)
    scales_in = torch.empty((rows, g_in), dtype=_F32, device=dev)
    # the fp32 hidden gelu(a0) * a1 goes through device memory once
    hidden = torch.empty((rows, d_ff), dtype=_F32, device=dev)
    codes_hid = torch.empty((rows, d_ff), dtype=_I8, device=dev)
    scales_hid = torch.empty((rows, g_hid), dtype=_F32, device=dev)
    out = torch.empty_like(x)
    if gated:
        w_up, s_up = _k_major_gated(wi_0, s_0, wi_1, s_1)
    else:
        w_up, s_up = _k_major(wi_0), s_0
    wo = _k_major(wo)
    _run(op, _launcher_of("int8_encoder", op, 12, 7, 1),
         x.data_ptr(), ln_weight.data_ptr(), w_up.data_ptr(), s_up.data_ptr(),
         wo.data_ptr(), s_o.data_ptr(), codes_in.data_ptr(),
         scales_in.data_ptr(), hidden.data_ptr(), codes_hid.data_ptr(),
         scales_hid.data_ptr(), out.data_ptr(),
         rows, d_model, d_ff, int(gated), g_in, g_hid, int(act == _F32),
         eps, torch.cuda.current_stream(dev).cuda_stream)
    fused_t5_ffn_q8.launches += 1
    if codes_out is not None:
        codes_out.update(codes=codes_in, scales=scales_in,
                         hidden_codes=codes_hid, hidden_scales=scales_hid)
    return out


fused_t5_ln_qkv_q8.launches = 0
fused_oproj_residual_q8.launches = 0
fused_t5_ffn_q8.launches = 0


# ---------------------------------------------------------------------------
# bf16 T5 encoder FFN: plain version and the wrapper around csrc/t5_ffn.cu
# ---------------------------------------------------------------------------

# The kernel's tiles: the contraction a whole number of 64-deep k steps, the
# output widths a whole number of 128-wide column tiles (the gated product's
# tiles 128 columns of each of wi_0 and wi_1); its RMSNorm keeps a row of at
# most NORM_MAX_WIDTH in one warp's registers.
FFN_WIDTH_MULTIPLE = 128


def fused_t5_ffn_plain(
    x: torch.Tensor,             # (B, L, D) pre-norm residual stream
    ln_weight: torch.Tensor,     # (D,)
    wi_0: torch.Tensor,          # (D, F)
    wi_1: Optional[torch.Tensor],  # (D, F) gate, or None
    wo: torch.Tensor,            # (F, D)
    eps: float = 1e-6,
    residual: bool = True,
) -> torch.Tensor:
    """x + FFN(RMSNorm(x)) in the Pallas kernel's order of rounding: the
    fp32 norm rounded to bf16 whatever x's dtype, the bf16 weights'
    products accumulated in fp32 (the operands upcast, which is exact, and
    multiplied in true fp32: the port leaves
    ``torch.backends.cuda.matmul.allow_tf32`` at its default, False),
    gelu(a0) * a1 in fp32 and rounded to bf16 once, then the down product
    and the fp32 residual, cast to x's dtype. JAX's XLA twin of the kernel
    (``_t5_ffn_reference``, which its custom VJP differentiates) has this
    order of rounding too, so the two are one function here. With
    ``residual`` False: the fp32 FFN(RMSNorm(x)) alone, the partial form of
    a tensor-parallel rank (its weights a shard)."""
    return _t5_ffn_reference(x, ln_weight, wi_0, wi_1, wo, eps,
                             residual=residual)


def _t5_ffn_reference(
    x: torch.Tensor, ln_weight: torch.Tensor,
    wi_0: torch.Tensor, wi_1: Optional[torch.Tensor], wo: torch.Tensor,
    eps: float = 1e-6, residual: bool = True,
    *, wide: torch.dtype = torch.float32, narrow: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """JAX's ``_t5_ffn_reference`` (:1047-1066): ``x32 * rsqrt(mean(x32^2) +
    eps) * w`` in ``wide``, rounded to ``narrow``; the products of
    ``narrow`` operands summed in ``wide``; the tanh-gelu hidden times the
    gate in ``wide``, rounded to ``narrow`` for the down product; the
    residual in ``wide``, one cast to x's dtype (without ``residual``, the
    down product in ``wide`` as it is). ``wide`` and ``narrow`` are fp32
    and bf16 except in the float64 gradient check."""
    x32 = x.to(wide)

    def operand(t):
        return t.to(narrow).to(wide)

    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    # h is cast up once for each product, as JAX's einsums each read the
    # narrow h: the backward rounds each product's gradient of h to narrow
    # and sums the two in narrow, as JAX's transposes do
    h = (x32 * torch.rsqrt(var + eps) * ln_weight.to(wide)).to(narrow)
    hid = _tanh_gelu(torch.matmul(h.to(wide), operand(wi_0)))
    if wi_1 is not None:
        hid = hid * torch.matmul(h.to(wide), operand(wi_1))
    y = torch.matmul(operand(hid), operand(wo))
    if not residual:
        return y
    return (x32 + y).to(x.dtype)


def fused_t5_ffn(
    x: torch.Tensor, ln_weight: torch.Tensor,
    wi_0: torch.Tensor, wi_1: Optional[torch.Tensor], wo: torch.Tensor,
    eps: float = 1e-6, residual: bool = True,
) -> torch.Tensor:
    """x + FFN(RMSNorm(x)), gated when wi_1 is given (T5 v1.1 gated-gelu).
    x (and the output) bf16 or fp32, ln_weight bf16 or fp32; the weights
    are cast to bf16 here where they are not (fp32 params), as the JAX
    wrapper casts them. With ``residual`` False the output is the fp32
    FFN(RMSNorm(x)) alone (the partial form: a tensor-parallel rank's
    shard of wi_0, wi_1 by column and of wo by row, whose sum over the
    model group takes x once). CPU tensors take the plain version; CUDA
    tensors launch the kernel (``fused_t5_ffn.launches`` counts those calls,
    of either form) or raise."""
    if x.device.type == "cpu":
        return fused_t5_ffn_plain(x, ln_weight, wi_0, wi_1, wo, eps,
                                  residual=residual)
    op = "fused_t5_ffn"
    kernels.refuse_grad(op, x, ln_weight, wi_0, wi_1, wo,
                        vjp="fused_t5_ffn_vjp")
    gated = wi_1 is not None
    for name, t in (("x", x), ("ln_weight", ln_weight)):
        if t.dtype not in (_BF16, _F32):
            raise ValueError(
                f"{op}: {name} is {t.dtype}; the kernel takes bfloat16 or "
                "float32")
    wi_0, wo = _bf16_weight(wi_0), _bf16_weight(wo)
    tensors = dict(x=x, ln_weight=ln_weight, wi_0=wi_0, wo=wo)
    if gated:
        wi_1 = _bf16_weight(wi_1)
        tensors["wi_1"] = wi_1
    _check_tensors(op, x.device, dict(x=x.dtype, ln_weight=ln_weight.dtype,
                                      wi_0=_BF16, wi_1=_BF16, wo=_BF16),
                   **tensors)
    batch, seq, d_model = x.shape
    d_ff = wi_0.shape[-1]
    if tuple(ln_weight.shape) != (d_model,):
        raise ValueError(f"{op}: ln_weight is {tuple(ln_weight.shape)}")
    for name, w, shape in (("wi_0", wi_0, (d_model, d_ff)),
                           ("wi_1", wi_1, (d_model, d_ff)),
                           ("wo", wo, (d_ff, d_model))):
        if w is not None and tuple(w.shape) != shape:
            raise ValueError(
                f"{op}: {name} is {tuple(w.shape)}, expected {shape}")
    if d_model % FFN_WIDTH_MULTIPLE or d_ff % FFN_WIDTH_MULTIPLE:
        raise ValueError(
            f"{op}: widths D={d_model}, F={d_ff} are not multiples of "
            f"{FFN_WIDTH_MULTIPLE}")
    _check_norm_width(op, d_model)
    rows, dev = batch * seq, x.device
    h = torch.empty((rows, d_model), dtype=_BF16, device=dev)
    # the bf16 hidden gelu(a0) * a1 goes through device memory once
    hidden = torch.empty((rows, d_ff), dtype=_BF16, device=dev)
    out = torch.empty_like(x) if residual else torch.empty(
        x.shape, dtype=_F32, device=dev)
    _run(op, _launcher_of("t5_ffn", op if residual else op + "_partial",
                          8, 5, 1),
         x.data_ptr(), ln_weight.data_ptr(), wi_0.data_ptr(),
         wi_1.data_ptr() if gated else None, wo.data_ptr(), h.data_ptr(),
         hidden.data_ptr(), out.data_ptr(), rows, d_model, d_ff,
         int(x.dtype == _F32), int(ln_weight.dtype == _F32), eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_t5_ffn.launches += 1
    return out


def _bf16_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as the Pallas wrapper passes it: bf16 (a copy a call for
    fp32 params; none for bf16 ones)."""
    return w if w.dtype == _BF16 else w.to(_BF16).contiguous()


fused_t5_ffn.launches = 0


class _FusedT5FfnVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_weight, wi_0, wi_1, wo, eps, residual):
        ctx.save_for_backward(x, ln_weight, wi_0, wi_1, wo)
        ctx.eps, ctx.residual = eps, residual
        return fused_t5_ffn(x, ln_weight, wi_0, wi_1, wo, eps=eps,
                            residual=residual)

    @staticmethod
    def backward(ctx, d_out):
        inputs = ctx.saved_tensors
        grads = _twin_grads(
            ctx.needs_input_grad[:5], inputs,
            lambda *t: _t5_ffn_reference(*t, ctx.eps,
                                         residual=ctx.residual), d_out)
        return (*grads, None, None)


def fused_t5_ffn_vjp(
    x: torch.Tensor, ln_weight: torch.Tensor,
    wi_0: torch.Tensor, wi_1: Optional[torch.Tensor], wo: torch.Tensor,
    eps: float = 1e-6, residual: bool = True,
) -> torch.Tensor:
    """Differentiable ``fused_t5_ffn`` (JAX ``fused_t5_ffn_vjp``,
    :1069-1102): the wrapper forward (the kernel on CUDA tensors), the
    gradient by recomputing ``_t5_ffn_reference``, since the kernel keeps
    neither the normed input nor the hidden. No kernel runs in the
    backward. ``residual`` False: the partial form."""
    return _FusedT5FfnVJP.apply(x, ln_weight, wi_0, wi_1, wo, eps, residual)


# ---------------------------------------------------------------------------
# CLIP ViT split3 block: plain versions and the wrappers around
# csrc/vit_block.cu
# ---------------------------------------------------------------------------

# The GEMMs' tiles take widths (D, 3 x D, F) that are whole numbers of
# 128-wide column tiles; the whole blocks' attention kernel keeps a (32, L)
# fp32 score tile in shared memory (attention_core's takes any L); the
# row norms of csrc/row_norm.cuh keep a row of at most NORM_MAX_WIDTH in
# one warp's registers.
VIT_WIDTH_MULTIPLE = 128
NORM_MAX_WIDTH = 4096
QUICK_GELU_ALPHA = 1.702


def _ln_f32(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of an fp32 ``z``: the mean, then the
    mean of the squared deviations, ``(z - m) * rsqrt(var + eps)``, then
    ``* scale + bias`` (JAX ``_ln_f32``'s order; not ``F.layer_norm``)."""
    m = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - m), dim=-1, keepdim=True)
    return (z - m) * torch.rsqrt(var + eps) * scale.to(z.dtype) + bias.to(
        z.dtype)


def _bf16_operand(w: torch.Tensor) -> torch.Tensor:
    """A weight as the Pallas wrappers pass it (cast to bf16), in fp32 for
    an exact-product fp32 matmul."""
    return w.to(torch.bfloat16).float()


def fused_ln_qkv_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    scale: float,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q * scale, k, v) in x.dtype: ``h = bf16(LN(x))`` in fp32, each
    product of h with a bf16 weight accumulated in fp32, then the bias,
    then (q only) the fp32 scale, one cast at the end."""
    h = _ln_f32(x.float(), ln_scale, ln_bias, eps).to(torch.bfloat16).float()

    def proj(w, b):
        return torch.matmul(h, _bf16_operand(w)) + b.float()

    q = proj(wq, bq) * scale
    return q.to(x.dtype), proj(wk, bk).to(x.dtype), proj(wv, bv).to(x.dtype)


# The softmax orders of the ViT attention kernels (the ``mode`` argument of
# vit_attention.cuh), with e = exp(s - max):
#   "bf16_sum"      p = q.dtype(e), divided after PV by the sum of those p
#                   (attention_core);
#   "fast_exp"      e = exp(bf16(s - max)), PV with q.dtype(e), divided after
#                   PV by the sum of the fp32 e (attention_core and
#                   fused_vit_block with fast_exp);
#   "normalised"    p = q.dtype(e / sum(e)), nothing divided after PV
#                   (fused_vit_block's default, fused_vit_block_q8);
#   "deferred_div"  PV with q.dtype(e), divided after PV by the sum of the
#                   fp32 e (fused_vit_block with deferred_div).
SOFTMAX_MODES = {"bf16_sum": 0, "fast_exp": 1, "normalised": 2,
                 "deferred_div": 3}


def _softmax_pv_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, mode: str) -> torch.Tensor:
    """softmax(q k^T) v per head over (B, L, H*dh) pre-scaled q, in one of
    the SOFTMAX_MODES orders: fp32 scores, fp32 PV; returns the fp32
    (B, L, H*dh) output before any cast.

    ``fast_exp`` takes the exponential of ``bf16(s - max)``. XLA evaluates
    that bf16 exponential in fp32 and, allowed excess precision, rounds it
    to bf16 only where a bf16 value is needed: the interpret-mode kernels
    sum the unrounded fp32 exponentials and multiply V by them cast to q's
    dtype. So does this version."""
    batch, seq, width = q.shape
    head_dim = width // num_heads

    def heads(t):  # (B, L, H*dh) -> (B, H, L, dh) in fp32 (exact for bf16)
        return t.reshape(batch, seq, num_heads, head_dim).transpose(1, 2) \
            .float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    d = s - s.amax(dim=-1, keepdim=True)
    if mode == "fast_exp":
        d = d.to(torch.bfloat16).float()
    e = torch.exp(d)
    if mode == "normalised":
        p, denom = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype), None
    elif mode == "bf16_sum":
        p = e.to(q.dtype)
        denom = p.float().sum(dim=-1, keepdim=True)
    else:
        p, denom = e.to(q.dtype), e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.float(), heads(v))
    if denom is not None:
        o = o / denom
    return o.transpose(1, 2).reshape(batch, seq, width)


def attention_core_plain(
    q: torch.Tensor,             # (B, L, D) PRE-SCALED queries, heads on lanes
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    fast_exp: bool = False,
) -> torch.Tensor:
    """softmax(q k^T) v per head in the Pallas kernel's order: fp32 scores,
    the unnormalised probabilities ``p = exp(s - max)`` cast to q's dtype
    and their fp32 sum, PV in fp32 divided after the product, one cast to
    q's dtype; with ``fast_exp`` the exponential of ``bf16(s - max)``
    (``_softmax_pv_f32``'s "bf16_sum" and "fast_exp" orders)."""
    mode = "fast_exp" if fast_exp else "bf16_sum"
    return _softmax_pv_f32(q, k, v, num_heads, mode).to(q.dtype)


def attention_core_oproj_plain(
    residual: torch.Tensor,      # (B, L, D) the block's residual stream
    q: torch.Tensor,             # (B, L, D) PRE-SCALED queries, heads on lanes
    k: torch.Tensor,
    v: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """residual + Attn(q, k, v) @ wo + bo in the Pallas kernel's order: the
    attention as ``attention_core_plain`` computes it, staged in the output
    dtype, then the out-projection (bf16 weights, fp32 accumulation), its
    bias and the fp32 residual, one cast at the end."""
    o = attention_core_plain(q, k, v, num_heads).to(residual.dtype)
    y = torch.matmul(o.to(q.dtype).float(), _bf16_operand(wo)) + bo.float()
    return (residual.float() + y).to(residual.dtype)


def fused_mlp_block_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + MLP(LN(x)) with quickGELU: ``h = bf16(LN(x))``, ``hid = h.w_fc +
    b_fc`` in fp32, ``bf16(hid * sigmoid(1.702 hid))``, then the down
    product, its bias and the fp32 residual, one cast at the end."""
    x32 = x.float()
    h = _ln_f32(x32, ln_scale, ln_bias, eps).to(torch.bfloat16).float()
    hid = torch.matmul(h, _bf16_operand(w_fc)) + b_fc.float()
    hid = (hid * torch.sigmoid(QUICK_GELU_ALPHA * hid)).to(torch.bfloat16)
    y = torch.matmul(hid.float(), _bf16_operand(w_proj)) + b_proj.float()
    return (x32 + y).to(x.dtype)


def _check_group(op: str, batch: int, group: int) -> None:
    """``group`` tiles the TPU grid (images per program); the results do
    not depend on it, but the JAX wrappers assert that it divides B."""
    if group < 1 or batch % group:
        raise ValueError(f"{op}: batch {batch} is not a multiple of group "
                         f"{group}")


def _vit_form(op: str, acts: dict, vectors: dict, weights: dict) -> tuple:
    """The form of a ViT kernel's CUDA call (split3, whole-block or int8),
    as the JAX wrappers read their operands: ``acts`` (x, the residual, q, k, v) of one dtype, bf16
    or fp32 (the fp32 form); ``vectors`` (the LayerNorms' scales and
    biases, the biases) bf16 or fp32, read as they are when all are bf16,
    else all fp32 (a bf16 one widened, which is exact); ``weights`` bf16 or
    fp32, an fp32 one cast to bf16 (a copy a call, as the JAX wrapper casts
    it; bf16 ones pass with no copy). Any other dtype raises ValueError.
    Returns (x_f32, params_f32, vectors, weights), those as the kernel reads
    them, each checked by ``_check_tensors``."""
    first, x = next(iter(acts.items()))
    for name, t in {**acts, **vectors, **weights}.items():
        if t.dtype not in (_BF16, _F32):
            raise ValueError(f"{op}: {name} is {t.dtype}; the kernel takes "
                             "bfloat16 or float32")
    for name, t in acts.items():
        if t.dtype != x.dtype:
            raise ValueError(
                f"{op}: {name} is {t.dtype}, {first} is {x.dtype}; the "
                f"kernel takes {', '.join(acts)} of one dtype")
    params_f32 = any(t.dtype == _F32 for t in vectors.values())
    vectors = {name: t.float() if params_f32 else t
               for name, t in vectors.items()}
    weights = {name: _bf16_weight(t) for name, t in weights.items()}
    dtypes = {**{name: x.dtype for name in acts},
              **{name: _F32 if params_f32 else _BF16 for name in vectors},
              **{name: _BF16 for name in weights}}
    _check_tensors(op, x.device, dtypes, **acts, **vectors, **weights)
    return x.dtype == _F32, params_f32, vectors, weights


def _check_vit_widths(op: str, **widths: int) -> None:
    for name, n in widths.items():
        if n <= 0 or n % VIT_WIDTH_MULTIPLE:
            raise ValueError(
                f"{op}: width {name}={n} is not a multiple of "
                f"{VIT_WIDTH_MULTIPLE}")


def _check_norm_width(op: str, d_model: int) -> None:
    """A width the bf16 kernels' row norm (csrc/row_norm.cuh) takes."""
    if d_model > NORM_MAX_WIDTH:
        raise ValueError(f"{op}: width D={d_model} exceeds the norm "
                         f"kernel's {NORM_MAX_WIDTH}")


def _check_shapes(op: str, **pairs) -> None:
    for name, (t, shape) in pairs.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{op}: {name} is {tuple(t.shape)}, expected {tuple(shape)}")


def vit_attention_max_len(head_dim: int) -> int:
    """The longest sequence the whole blocks' attention kernel
    (``csrc/vit_attention.cuh``: ``fused_vit_block``,
    ``fused_vit_block_q8``) takes on the current card at this head size
    (its (32, L) fp32 score tile lives in shared memory); 0 for an
    unsupported head size."""
    return _kernel_max_len("vit_block", "vit_attention_max_len", head_dim)


def _vit_head_size(op: str, d_model: int, num_heads: int) -> int:
    """The head size, one the ViT attention kernels take."""
    if num_heads <= 0 or d_model % num_heads:
        raise ValueError(
            f"{op}: width {d_model} is not a multiple of {num_heads} heads")
    head_dim = d_model // num_heads
    if head_dim not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{op}: head size {head_dim} is not one of "
                         f"{_SUPPORTED_HEAD_DIMS}")
    return head_dim


def _vit_f32_head_size(op: str, d_model: int, num_heads: int) -> int:
    """The head size, one the fp32 attention (csrc/attention_f32.cuh)
    takes."""
    head_dim = _vit_head_size(op, d_model, num_heads)
    if head_dim not in _F32_HEAD_DIMS:
        raise ValueError(f"{op}: head size {head_dim} is not one of "
                         f"{_F32_HEAD_DIMS} (float32)")
    return head_dim


def _vit_head_dim(op: str, seq: int, d_model: int, num_heads: int) -> int:
    """The head size, one the whole blocks' attention kernel takes, at a
    sequence length whose score tile fits the card's shared memory."""
    head_dim = _vit_head_size(op, d_model, num_heads)
    limit = vit_attention_max_len(head_dim)
    if seq > limit:
        raise ValueError(
            f"{op}: sequence length {seq} exceeds {limit}, the longest whose "
            f"score tile fits this card's shared memory at head size "
            f"{head_dim}")
    return head_dim


def fused_ln_qkv(
    x: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    scale: float,
    group: int = 1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm + the three biased CLIP projections; returns (q * scale,
    k, v), each (B, L, D) in x.dtype. ``group`` (images per TPU program) is
    checked (it must divide B) and does not change the results. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``fused_ln_qkv.launches`` counts those calls, of either form) or
    raise: x bf16 or fp32 (the fp32 form), the vectors and weights as
    ``_vit_form`` reads them."""
    op = "fused_ln_qkv"
    _check_group(op, x.shape[0], group)
    if x.device.type == "cpu":
        return fused_ln_qkv_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv,
                                  bv, scale, eps)
    kernels.refuse_grad("fused_ln_qkv", x, ln_scale, ln_bias, wq, bq, wk, bk,
                        wv, bv)
    x_f32, params_f32, vecs, ws = _vit_form(
        op, dict(x=x), dict(ln_scale=ln_scale, ln_bias=ln_bias, bq=bq, bk=bk,
                            bv=bv), dict(wq=wq, wk=wk, wv=wv))
    batch, seq, d_model = x.shape
    vec, mat = (d_model,), (d_model, d_model)
    _check_shapes(op, **{name: (t, vec) for name, t in vecs.items()},
                  **{name: (t, mat) for name, t in ws.items()})
    _check_vit_widths(op, D=d_model)
    _check_norm_width(op, d_model)
    rows, dev = batch * seq, x.device
    h = torch.empty((rows, d_model), dtype=_BF16, device=dev)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    _run(op, _launcher_of("vit_block", op, 13, 4, 2),
         x.data_ptr(), vecs["ln_scale"].data_ptr(),
         vecs["ln_bias"].data_ptr(), ws["wq"].data_ptr(),
         vecs["bq"].data_ptr(), ws["wk"].data_ptr(), vecs["bk"].data_ptr(),
         ws["wv"].data_ptr(), vecs["bv"].data_ptr(), h.data_ptr(),
         q.data_ptr(), k.data_ptr(), v.data_ptr(), rows, d_model,
         int(x_f32), int(params_f32), scale, eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_ln_qkv.launches += 1
    return q, k, v


def attention_core_oproj(
    residual: torch.Tensor,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    num_heads: int,
    group: int = 1,
) -> torch.Tensor:
    """residual + softmax(q k^T) v @ wo + bo over pre-scaled q (no bias, no
    mask). ``group`` is checked (it must divide B) and does not change the
    results. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``attention_core_oproj.launches``, either form) or raise: the
    residual, q, k and v all bf16 or all fp32 (the fp32 form, head sizes
    64 and 128), bo and wo as ``_vit_form`` reads them."""
    op = "attention_core_oproj"
    _check_group(op, q.shape[0], group)
    if q.device.type == "cpu":
        return attention_core_oproj_plain(residual, q, k, v, wo, bo,
                                          num_heads)
    kernels.refuse_grad("attention_core_oproj", residual, q, k, v, wo, bo)
    x_f32, params_f32, vecs, ws = _vit_form(
        op, dict(residual=residual, q=q, k=k, v=v), dict(bo=bo), dict(wo=wo))
    if q.dim() != 3:
        raise ValueError(f"{op}: q is {tuple(q.shape)}, expected (B, L, D)")
    batch, seq, d_model = q.shape
    _check_shapes(op, residual=(residual, q.shape), k=(k, q.shape),
                  v=(v, q.shape), wo=(ws["wo"], (d_model, d_model)),
                  bo=(vecs["bo"], (d_model,)))
    _check_vit_widths(op, D=d_model)
    dev = q.device
    if x_f32:
        # the fp32 attention output goes through device memory once, as
        # three bf16 planes: the out-projection's A operand
        head_dim = _vit_f32_head_size(op, d_model, num_heads)
        route = vit_f32_route(seq, head_dim)
        attn = torch.empty((batch * seq, 3 * d_model), dtype=_BF16,
                           device=dev)
    else:
        # the attention output goes through device memory once, bf16
        head_dim = _vit_head_size(op, d_model, num_heads)
        route = F32_TWO_PASS
        attn = torch.empty_like(q)
    out = torch.empty_like(residual)
    _run(op, _launcher_of("vit_block", op, 8, 7, 0),
         residual.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         ws["wo"].data_ptr(), vecs["bo"].data_ptr(), attn.data_ptr(),
         out.data_ptr(), batch, seq, num_heads, head_dim, int(x_f32),
         int(params_f32), route, torch.cuda.current_stream(dev).cuda_stream)
    attention_core_oproj.launches += 1
    return out


def fused_mlp_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    group: int = 1,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + MLP(LN(x)) with quickGELU. ``group`` (images of a TPU program)
    is checked and does not change the results. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``fused_mlp_block.launches``,
    either form) or raise: x bf16 or fp32 (the fp32 form), the vectors and
    weights as ``_vit_form`` reads them."""
    op = "fused_mlp_block"
    _check_group(op, x.shape[0], group)
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w_fc, b_fc,
                                     w_proj, b_proj, eps)
    kernels.refuse_grad("fused_mlp_block", x, ln_scale, ln_bias, w_fc, b_fc,
                        w_proj, b_proj)
    x_f32, params_f32, vecs, ws = _vit_form(
        op, dict(x=x), dict(ln_scale=ln_scale, ln_bias=ln_bias, b_fc=b_fc,
                            b_proj=b_proj), dict(w_fc=w_fc, w_proj=w_proj))
    batch, seq, d_model = x.shape
    d_ff = w_fc.shape[-1]
    vec = (d_model,)
    _check_shapes(op, ln_scale=(vecs["ln_scale"], vec),
                  ln_bias=(vecs["ln_bias"], vec),
                  w_fc=(ws["w_fc"], (d_model, d_ff)),
                  b_fc=(vecs["b_fc"], (d_ff,)),
                  w_proj=(ws["w_proj"], (d_ff, d_model)),
                  b_proj=(vecs["b_proj"], vec))
    _check_vit_widths(op, D=d_model, F=d_ff)
    _check_norm_width(op, d_model)
    rows, dev = batch * seq, x.device
    h = torch.empty((rows, d_model), dtype=_BF16, device=dev)
    # the bf16 quickGELU hidden goes through device memory once
    hidden = torch.empty((rows, d_ff), dtype=_BF16, device=dev)
    out = torch.empty_like(x)
    _run(op, _launcher_of("vit_block", op, 10, 5, 1),
         x.data_ptr(), vecs["ln_scale"].data_ptr(),
         vecs["ln_bias"].data_ptr(), ws["w_fc"].data_ptr(),
         vecs["b_fc"].data_ptr(), ws["w_proj"].data_ptr(),
         vecs["b_proj"].data_ptr(), h.data_ptr(), hidden.data_ptr(),
         out.data_ptr(), rows, d_model, d_ff, int(x_f32), int(params_f32),
         eps, torch.cuda.current_stream(dev).cuda_stream)
    fused_mlp_block.launches += 1
    return out


fused_ln_qkv.launches = 0
attention_core_oproj.launches = 0
fused_mlp_block.launches = 0


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    num_heads: int,
    fast_exp: bool = False,
) -> torch.Tensor:
    """softmax(q k^T) v per head over pre-scaled q in the native (B, L, D)
    layout (no bias, no mask), the exponential's argument rounded to bf16
    with ``fast_exp``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``attention_core.launches``, either form) or raise:
    q, k and v all bf16 (the tensor-core kernel) or all fp32 (the CUDA-core
    kernel of csrc/attention_f32.cuh, head sizes 64 and 128, by the route
    ``vit_f32_route`` gives for L)."""
    op = "attention_core"
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, num_heads, fast_exp)
    kernels.refuse_grad(op, q, k, v)
    x_f32 = _vit_form(op, dict(q=q, k=k, v=v), {}, {})[0]
    if q.dim() != 3:
        raise ValueError(f"{op}: q is {tuple(q.shape)}, expected (B, L, D)")
    batch, seq, d_model = q.shape
    _check_shapes(op, k=(k, q.shape), v=(v, q.shape))
    if x_f32:
        head_dim = _vit_f32_head_size(op, d_model, num_heads)
        route = vit_f32_route(seq, head_dim)
    else:
        head_dim = _vit_head_size(op, d_model, num_heads)
        route = F32_TWO_PASS
    out = torch.empty_like(q)
    _run(op, _launcher_of("vit_block", op, 4, 7, 0),
         q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         batch, seq, num_heads, head_dim, int(fast_exp), int(x_f32), route,
         torch.cuda.current_stream(q.device).cuda_stream)
    attention_core.launches += 1
    return out


attention_core.launches = 0


# ---------------------------------------------------------------------------
# int8 CLIP ViT long-sequence block: the weight quantizer, plain versions and
# the wrappers around csrc/vit_block_q8.cu
# ---------------------------------------------------------------------------

def quantize_weight_i8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a (D_in, D_out)
    weight, in fp32 on w's device: int8 codes and (D_out,) fp32 scales.

    The JAX package runs this in numpy (host-side, once), where nothing
    folds the division: the scale is ``max(amax, 1e-8) / 127.0`` and the
    codes ``clip(round_half_even(w / scale), +-127)``, both true divisions.
    The divisor 127 is a tensor here because PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal; so the codes and scales are
    bit-equal to JAX's on either device."""
    w = w.float()
    amax = torch.clamp(w.abs().amax(dim=0), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def fused_qkv_q8_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_qkv: torch.Tensor,         # int8 (D, 3D), q | k | v columns
    s_qkv: torch.Tensor,         # fp32 (3D,) per-output-channel scales
    b_qkv: torch.Tensor,         # (3D,)
    scale: float,
    eps: float = 1e-5,
    *, codes_out: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q * scale, k, v) in x.dtype: the fp32 LayerNorm ``h`` (never rounded
    to bf16), one per-row quantization of it, one int8 product with the
    concatenated weight, ``(acc * hs) * s + b``, q times the fp32 scale, one
    cast at the end. ``codes_out``, when given, receives that
    quantization's ``codes`` and ``scales``."""
    batch, seq, d_model = x.shape
    h = _ln_f32(x.reshape(-1, d_model).float(), ln_scale, ln_bias, eps)
    parts = [_row_quant_i8(h)]
    _record_codes(codes_out, "", parts)
    qkv = _mm_q8_grouped(parts, w_qkv, _as_group_scales(s_qkv)) \
        + b_qkv.float()
    q = qkv[:, :d_model] * scale
    return tuple(t.reshape(batch, seq, d_model).to(x.dtype) for t in (
        q, qkv[:, d_model:2 * d_model], qkv[:, 2 * d_model:]))


def fused_mlp_block_q8_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_fc: torch.Tensor, s_fc: torch.Tensor, b_fc: torch.Tensor,  # (D, F)
    w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    eps: float = 1e-5,
    *, codes_out: Optional[dict] = None,
) -> torch.Tensor:
    """x + MLP(LN(x)) with both products int8: the fp32 LayerNorm quantized
    per row, ``hid = (acc * hs) * s_fc + b_fc``, fp32 quickGELU, the fp32
    hidden requantized per row over its whole width, ``(acc * gs) * s_proj
    + b_proj``, the fp32 residual, one cast at the end. ``codes_out``, when
    given, receives the LayerNorm's ``codes`` and ``scales`` and the
    hidden's ``hidden_codes`` and ``hidden_scales``."""
    d_model = x.shape[-1]
    x32 = x.reshape(-1, d_model).float()
    h = _ln_f32(x32, ln_scale, ln_bias, eps)
    parts = [_row_quant_i8(h)]
    hid = _mm_q8_grouped(parts, w_fc, _as_group_scales(s_fc)) + b_fc.float()
    hid = hid * torch.sigmoid(QUICK_GELU_ALPHA * hid)
    hid_parts = [_row_quant_i8(hid)]
    _record_codes(codes_out, "", parts)
    _record_codes(codes_out, "hidden_", hid_parts)
    y = _mm_q8_grouped(hid_parts, w_proj,
                       _as_group_scales(s_proj)) + b_proj.float()
    return (x32 + y).reshape(x.shape).to(x.dtype)


def _check_vit_q8_product(op: str, name: str, w: torch.Tensor,
                          s: torch.Tensor, k_dim: int) -> torch.Tensor:
    """int8 (K, N) weights with (N,) or (1, N) scales in one contraction
    group; returns the scales as (1, N)."""
    s = _as_group_scales(s)
    _check_q8_product(op, name, w, s, k_dim, 1)
    return s


def fused_qkv_q8(
    x: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    scale: float,
    eps: float = 1e-5,
    *, codes_out: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm + the concatenated int8 q | k | v product; returns (q *
    scale, k, v), each (B, L, D) in x.dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``fused_qkv_q8.launches``
    counts those calls, of every form) or raise: x bf16 or fp32 (the fp32
    form, q, k, v fp32 and unrounded), the LayerNorm's parameters and the
    bias as ``_vit_form`` reads them. ``codes_out``, when given, receives
    the activation ``codes`` and ``scales`` (the kernel's scratch), as the
    plain version's does."""
    op = "fused_qkv_q8"
    if x.device.type == "cpu":
        return fused_qkv_q8_plain(x, ln_scale, ln_bias, w_qkv, s_qkv, b_qkv,
                                  scale, eps, codes_out=codes_out)
    kernels.refuse_grad("fused_qkv_q8", x, ln_scale, ln_bias, s_qkv, b_qkv)
    x_f32, params_f32, vecs, _ = _vit_form(
        op, dict(x=x), dict(ln_scale=ln_scale, ln_bias=ln_bias, b_qkv=b_qkv),
        {})
    batch, seq, d_model = x.shape
    s_qkv = _check_vit_q8_product(op, "w_qkv", w_qkv, s_qkv, d_model)
    _check_tensors(op, x.device, dict(w_qkv=_I8, s_qkv=_F32), w_qkv=w_qkv,
                   s_qkv=s_qkv)
    vec = (d_model,)
    _check_shapes(op, ln_scale=(vecs["ln_scale"], vec),
                  ln_bias=(vecs["ln_bias"], vec),
                  w_qkv=(w_qkv, (d_model, 3 * d_model)),
                  b_qkv=(vecs["b_qkv"], (3 * d_model,)))
    _check_vit_widths(op, D=d_model)
    rows, dev = batch * seq, x.device
    codes = torch.empty((rows, d_model), dtype=_I8, device=dev)
    row_scales = torch.empty((rows, 1), dtype=_F32, device=dev)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    w_qkv = _k_major(w_qkv)
    _run(op, _launcher_of("vit_block_q8", op, 11, 4, 2),
         x.data_ptr(), vecs["ln_scale"].data_ptr(),
         vecs["ln_bias"].data_ptr(), w_qkv.data_ptr(), s_qkv.data_ptr(),
         vecs["b_qkv"].data_ptr(), codes.data_ptr(), row_scales.data_ptr(),
         q.data_ptr(), k.data_ptr(), v.data_ptr(), rows, d_model,
         int(x_f32), int(params_f32), scale, eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_qkv_q8.launches += 1
    if codes_out is not None:
        codes_out.update(codes=codes, scales=row_scales)
    return q, k, v


def fused_mlp_block_q8(
    x: torch.Tensor,
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    w_fc: torch.Tensor, s_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    eps: float = 1e-5,
    *, codes_out: Optional[dict] = None,
) -> torch.Tensor:
    """x + MLP(LN(x)) with quickGELU and both products int8. CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (``fused_mlp_block_q8.launches`` counts those calls, of every form) or
    raise: x bf16 or fp32 (the fp32 form, its output fp32), the LayerNorm's
    parameters and the biases as ``_vit_form`` reads them; the quickGELU
    hidden is fp32 in every form. ``codes_out``, when given, receives the
    plain version's keys from the kernel's scratch."""
    op = "fused_mlp_block_q8"
    if x.device.type == "cpu":
        return fused_mlp_block_q8_plain(x, ln_scale, ln_bias, w_fc, s_fc,
                                        b_fc, w_proj, s_proj, b_proj, eps,
                                        codes_out=codes_out)
    kernels.refuse_grad("fused_mlp_block_q8", x, ln_scale, ln_bias, s_fc,
                        b_fc, s_proj, b_proj)
    x_f32, params_f32, vecs, _ = _vit_form(
        op, dict(x=x), dict(ln_scale=ln_scale, ln_bias=ln_bias, b_fc=b_fc,
                            b_proj=b_proj), {})
    batch, seq, d_model = x.shape
    d_ff = w_fc.shape[-1]
    s_fc = _check_vit_q8_product(op, "w_fc", w_fc, s_fc, d_model)
    s_proj = _check_vit_q8_product(op, "w_proj", w_proj, s_proj, d_ff)
    _check_tensors(op, x.device,
                   dict(w_fc=_I8, s_fc=_F32, w_proj=_I8, s_proj=_F32),
                   w_fc=w_fc, s_fc=s_fc, w_proj=w_proj, s_proj=s_proj)
    vec = (d_model,)
    _check_shapes(op, ln_scale=(vecs["ln_scale"], vec),
                  ln_bias=(vecs["ln_bias"], vec),
                  b_fc=(vecs["b_fc"], (d_ff,)),
                  w_proj=(w_proj, (d_ff, d_model)),
                  b_proj=(vecs["b_proj"], vec))
    _check_vit_widths(op, D=d_model, F=d_ff)
    rows, dev = batch * seq, x.device
    codes_in = torch.empty((rows, d_model), dtype=_I8, device=dev)
    scales_in = torch.empty((rows, 1), dtype=_F32, device=dev)
    # the fp32 quickGELU hidden goes through device memory once
    hidden = torch.empty((rows, d_ff), dtype=_F32, device=dev)
    codes_hid = torch.empty((rows, d_ff), dtype=_I8, device=dev)
    scales_hid = torch.empty((rows, 1), dtype=_F32, device=dev)
    out = torch.empty_like(x)
    w_fc, w_proj = _k_major(w_fc), _k_major(w_proj)
    _run(op, _launcher_of("vit_block_q8", op, 15, 5, 1),
         x.data_ptr(), vecs["ln_scale"].data_ptr(),
         vecs["ln_bias"].data_ptr(), w_fc.data_ptr(), s_fc.data_ptr(),
         vecs["b_fc"].data_ptr(), w_proj.data_ptr(), s_proj.data_ptr(),
         vecs["b_proj"].data_ptr(), codes_in.data_ptr(), scales_in.data_ptr(),
         hidden.data_ptr(), codes_hid.data_ptr(), scales_hid.data_ptr(),
         out.data_ptr(), rows, d_model, d_ff, int(x_f32), int(params_f32),
         eps, torch.cuda.current_stream(dev).cuda_stream)
    fused_mlp_block_q8.launches += 1
    if codes_out is not None:
        codes_out.update(codes=codes_in, scales=scales_in,
                         hidden_codes=codes_hid, hidden_scales=scales_hid)
    return out


fused_qkv_q8.launches = 0
fused_mlp_block_q8.launches = 0


# ---------------------------------------------------------------------------
# CLIP ViT whole blocks (128 tokens or fewer, and the long whole / whole_dd
# variants): plain versions and the wrappers around csrc/vit_block.cu
# (fused_vit_block, fused_attention_block) and csrc/vit_block_q8.cu
# (fused_vit_block_q8)
#
# The Pallas kernels run a group of G images as one (G L, G L) score matrix
# per head whose cross-image entries are ``s - 1e30``: their exponentials
# after the row max are exactly 0 in fp32 and add nothing to a sum or to PV.
# So the plain versions and the CUDA kernels work image by image; G changes
# the Pallas results only through the order of the sums. The wrappers still
# refuse a G that does not divide B, as the JAX wrappers assert.
# ---------------------------------------------------------------------------

def _vit_block_softmax(deferred_div: bool, fast_exp: bool) -> str:
    """The Pallas kernel's softmax order (fast_exp wins, as in JAX)."""
    if fast_exp:
        return "fast_exp"
    return "deferred_div" if deferred_div else "normalised"


def fused_vit_block_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    eps: float = 1e-5,
    deferred_div: bool = False,
    fast_exp: bool = False,
) -> torch.Tensor:
    """x + Attn(LN1(x)) + MLP(LN2(x + Attn(LN1(x)))) in the Pallas kernel's
    order of rounding, whatever x's dtype: ``h = bf16(LN1(x))``; q = (h.wq
    + bq) * scale, k and v in fp32 (bf16 weights, fp32 accumulation), each
    cast to bf16; the attention in fp32 (``_softmax_pv_f32``: "normalised",
    "deferred_div" or "fast_exp"), rounded to bf16; ``r1 = x + (attn.wo +
    bo)`` in fp32; ``h2 = bf16(LN2(r1))``; ``hid = bf16(quickGELU(h2.w_fc +
    b_fc))``; one cast of ``r1 + (hid.w_proj + b_proj)`` to x's dtype."""
    bf = torch.bfloat16
    d_model = x.shape[-1]
    x32 = x.float()

    def proj(a, w, b):
        return torch.matmul(a, _bf16_operand(w)) + b.float()

    h = _ln_f32(x32, ln1_scale, ln1_bias, eps).to(bf).float()
    q = (proj(h, wq, bq) * (d_model // num_heads) ** -0.5).to(bf)
    k, v = proj(h, wk, bk).to(bf), proj(h, wv, bv).to(bf)
    attn = _softmax_pv_f32(q, k, v, num_heads,
                           _vit_block_softmax(deferred_div, fast_exp))
    r1 = x32 + proj(attn.to(bf).float(), wo, bo)
    h2 = _ln_f32(r1, ln2_scale, ln2_bias, eps).to(bf).float()
    hid = proj(h2, w_fc, b_fc)
    hid = (hid * torch.sigmoid(QUICK_GELU_ALPHA * hid)).to(bf).float()
    return (r1 + proj(hid, w_proj, b_proj)).to(x.dtype)


# fused_vit_block's parameters in the kernel's order; its weights (cast to
# bf16), the others vectors (read as they are, bf16 or fp32)
_VIT_BLOCK_ORDER = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv",
                    "bv", "wo", "bo", "ln2_scale", "ln2_bias", "w_fc", "b_fc",
                    "w_proj", "b_proj")
_VIT_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_fc", "w_proj")


def fused_vit_block(
    x: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    group: int = 4,
    eps: float = 1e-5,
    deferred_div: bool = False,
    fast_exp: bool = False,
) -> torch.Tensor:
    """The whole pre-LN CLIP block (quickGELU) over (B, L, D) x. ``group``
    (images per TPU program) is checked (it must divide B) and changes no
    result. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``fused_vit_block.launches`` counts those calls, of every form)
    or raise: x bf16 or fp32 (the fp32 form, output fp32), the vectors and
    weights as ``_vit_form`` reads them (q, k, v, the attention and the
    hidden are bf16 in every form, as the Pallas kernel casts them)."""
    op = "fused_vit_block"
    _check_group(op, x.shape[0], group)
    if x.device.type == "cpu":
        return fused_vit_block_plain(
            x, ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wo, bo,
            ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj, num_heads, eps,
            deferred_div, fast_exp)
    given = dict(ln1_scale=ln1_scale, ln1_bias=ln1_bias, wq=wq, bq=bq, wk=wk,
                 bk=bk, wv=wv, bv=bv, wo=wo, bo=bo, ln2_scale=ln2_scale,
                 ln2_bias=ln2_bias, w_fc=w_fc, b_fc=b_fc, w_proj=w_proj,
                 b_proj=b_proj)
    kernels.refuse_grad(op, x, *given.values())
    x_f32, params_f32, vecs, ws = _vit_form(
        op, dict(x=x), {name: t for name, t in given.items()
                        if name not in _VIT_BLOCK_WEIGHTS},
        {name: given[name] for name in _VIT_BLOCK_WEIGHTS})
    tensors = {**vecs, **ws}
    if x.dim() != 3:
        raise ValueError(f"{op}: x is {tuple(x.shape)}, expected (B, L, D)")
    batch, seq, d_model = x.shape
    d_ff = w_fc.shape[-1]
    shapes = {name: (d_model,) for name in vecs}
    shapes.update({name: (d_model, d_model) for name in ws},
                  b_fc=(d_ff,), w_fc=(d_model, d_ff), w_proj=(d_ff, d_model))
    _check_shapes(op, **{name: (tensors[name], shape)
                         for name, shape in shapes.items()})
    _check_vit_widths(op, D=d_model, F=d_ff)
    _check_norm_width(op, d_model)
    head_dim = _vit_head_dim(op, seq, d_model, num_heads)
    rows, dev = batch * seq, x.device
    # through device memory, once each: bf16 h (LN1, then LN2), q, k, v and
    # the attention output; the fp32 residual r1; the bf16 quickGELU hidden
    h, q, k, v, attn = (torch.empty((rows, d_model), dtype=_BF16, device=dev)
                        for _ in range(5))
    r1 = torch.empty((rows, d_model), dtype=_F32, device=dev)
    hidden = torch.empty((rows, d_ff), dtype=_BF16, device=dev)
    out = torch.empty_like(x)
    mode = SOFTMAX_MODES[_vit_block_softmax(deferred_div, fast_exp)]
    _run(op, _launcher_of("vit_whole_block", op, 25, 8, 2),
         x.data_ptr(),
         *(tensors[name].data_ptr() for name in _VIT_BLOCK_ORDER),
         h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         attn.data_ptr(), r1.data_ptr(), hidden.data_ptr(), out.data_ptr(),
         batch, seq, num_heads, head_dim, d_ff, mode, int(x_f32),
         int(params_f32), head_dim ** -0.5, eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0


def fused_vit_block_q8_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,  # (D, 3D)
    wo: torch.Tensor, so: torch.Tensor, bo: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, s_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    eps: float = 1e-5,
    *, stages_out: Optional[dict] = None,
) -> torch.Tensor:
    """``fused_vit_block`` with the four projections int8 (int8 (K, N)
    weights with fp32 per-output-channel scales), in the Pallas kernel's
    order: each product quantizes its fp32 input per row
    (``_row_quant_i8``) and gives ``(acc * hs) * s + b``; the fp32
    LayerNorm h (never rounded to bf16) feeds the concatenated q | k | v
    product, q times the scale; the attention takes q, k, v cast to bf16
    and its "normalised" softmax, and its fp32 output is quantized as it is;
    ``r1 = x + attn-product`` in fp32; the MLP's LN2, quickGELU hidden and
    residual in fp32; one cast to x's dtype. ``stages_out``, when given,
    receives the fp32 attention output ``attn`` and ``r1``, each (B, L,
    D)."""
    bf = torch.bfloat16
    batch, seq, d_model = x.shape
    x32 = x.reshape(-1, d_model).float()

    def mm_q8(a, w, s, b):
        return _mm_q8_grouped([_row_quant_i8(a)], w, _as_group_scales(s)) \
            + b.float()

    qkv = mm_q8(_ln_f32(x32, ln1_scale, ln1_bias, eps), w_qkv, s_qkv, b_qkv)
    q = qkv[:, :d_model] * (d_model // num_heads) ** -0.5
    q, k, v = (t.reshape(batch, seq, d_model).to(bf) for t in (
        q, qkv[:, d_model:2 * d_model], qkv[:, 2 * d_model:]))
    attn = _softmax_pv_f32(q, k, v, num_heads, "normalised")
    r1 = x32 + mm_q8(attn.reshape(-1, d_model), wo, so, bo)
    if stages_out is not None:
        stages_out.update(attn=attn.reshape(x.shape), r1=r1.reshape(x.shape))
    hid = mm_q8(_ln_f32(r1, ln2_scale, ln2_bias, eps), w_fc, s_fc, b_fc)
    hid = hid * torch.sigmoid(QUICK_GELU_ALPHA * hid)
    return (r1 + mm_q8(hid, w_proj, s_proj, b_proj)).reshape(x.shape) \
        .to(x.dtype)


def fused_vit_block_q8(
    x: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, s_qkv: torch.Tensor, b_qkv: torch.Tensor,
    wo: torch.Tensor, so: torch.Tensor, bo: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, s_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, s_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    group: int = 4,
    eps: float = 1e-5,
    *, stages_out: Optional[dict] = None,
) -> torch.Tensor:
    """The whole int8 CLIP block over (B, L, D) x. ``group`` is checked (it
    must divide B) and changes no result. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``fused_vit_block_q8.launches``
    counts those calls, of every form) or raise: x bf16 or fp32 (the fp32
    form, output fp32), the LayerNorms' parameters and the biases as
    ``_vit_form`` reads them (q, k, v are bf16 in every form, as the Pallas
    kernel casts them; the attention output, r1 and the hidden fp32).
    ``stages_out``, when given, receives the fp32 ``attn`` and ``r1`` (B,
    L, D) the call computed (on the card, the kernel's scratch)."""
    op = "fused_vit_block_q8"
    _check_group(op, x.shape[0], group)
    if x.device.type == "cpu":
        return fused_vit_block_q8_plain(
            x, ln1_scale, ln1_bias, w_qkv, s_qkv, b_qkv, wo, so, bo,
            ln2_scale, ln2_bias, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj,
            num_heads, eps, stages_out=stages_out)
    kernels.refuse_grad(op, x, ln1_scale, ln1_bias, s_qkv, b_qkv, so, bo,
                        ln2_scale, ln2_bias, s_fc, b_fc, s_proj, b_proj)
    x_f32, params_f32, vecs, _ = _vit_form(
        op, dict(x=x), dict(ln1_scale=ln1_scale, ln1_bias=ln1_bias,
                            b_qkv=b_qkv, bo=bo, ln2_scale=ln2_scale,
                            ln2_bias=ln2_bias, b_fc=b_fc, b_proj=b_proj), {})
    if x.dim() != 3:
        raise ValueError(f"{op}: x is {tuple(x.shape)}, expected (B, L, D)")
    batch, seq, d_model = x.shape
    d_ff = w_fc.shape[-1]
    s_qkv = _check_vit_q8_product(op, "w_qkv", w_qkv, s_qkv, d_model)
    so = _check_vit_q8_product(op, "wo", wo, so, d_model)
    s_fc = _check_vit_q8_product(op, "w_fc", w_fc, s_fc, d_model)
    s_proj = _check_vit_q8_product(op, "w_proj", w_proj, s_proj, d_ff)
    weights = dict(w_qkv=w_qkv, s_qkv=s_qkv, wo=wo, so=so, w_fc=w_fc,
                   s_fc=s_fc, w_proj=w_proj, s_proj=s_proj)
    _check_tensors(op, x.device,
                   {name: _I8 if name.startswith("w") else _F32
                    for name in weights}, **weights)
    vec = (d_model,)
    _check_shapes(op, ln1_scale=(vecs["ln1_scale"], vec),
                  ln1_bias=(vecs["ln1_bias"], vec),
                  w_qkv=(w_qkv, (d_model, 3 * d_model)),
                  b_qkv=(vecs["b_qkv"], (3 * d_model,)),
                  wo=(wo, (d_model, d_model)), bo=(vecs["bo"], vec),
                  ln2_scale=(vecs["ln2_scale"], vec),
                  ln2_bias=(vecs["ln2_bias"], vec),
                  b_fc=(vecs["b_fc"], (d_ff,)),
                  w_proj=(w_proj, (d_ff, d_model)),
                  b_proj=(vecs["b_proj"], vec))
    _check_vit_widths(op, D=d_model, F=d_ff)
    head_dim = _vit_head_dim(op, seq, d_model, num_heads)
    rows, dev = batch * seq, x.device
    # through device memory, once each: the codes and row scales of each
    # product's input (one buffer, F wide), bf16 q, k and v, and the fp32
    # attention output, residual r1 and quickGELU hidden
    codes = torch.empty((rows, d_ff), dtype=_I8, device=dev)
    row_scales = torch.empty((rows, 1), dtype=_F32, device=dev)
    q, k, v = (torch.empty((rows, d_model), dtype=_BF16, device=dev)
               for _ in range(3))
    attn, r1 = (torch.empty((rows, d_model), dtype=_F32, device=dev)
                for _ in range(2))
    hidden = torch.empty((rows, d_ff), dtype=_F32, device=dev)
    out = torch.empty_like(x)
    order = ("ln1_scale", "ln1_bias", "w_qkv", "s_qkv", "b_qkv", "wo", "so",
             "bo", "ln2_scale", "ln2_bias", "w_fc", "s_fc", "b_fc", "w_proj",
             "s_proj", "b_proj")
    tensors = {**vecs, **{name: _k_major(t) if name.startswith("w") else t
                          for name, t in weights.items()}}
    _run(op, _launcher_of("vit_block_q8", op, 26, 7, 2),
         x.data_ptr(), *(tensors[name].data_ptr() for name in order),
         codes.data_ptr(), row_scales.data_ptr(), q.data_ptr(), k.data_ptr(),
         v.data_ptr(), attn.data_ptr(), r1.data_ptr(), hidden.data_ptr(),
         out.data_ptr(), batch, seq, num_heads, head_dim, d_ff, int(x_f32),
         int(params_f32), head_dim ** -0.5, eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_vit_block_q8.launches += 1
    if stages_out is not None:
        stages_out.update(attn=attn.view(x.shape), r1=r1.view(x.shape))
    return out


fused_vit_block_q8.launches = 0


def _attention_block_dtype(op: str, block_diag: bool,
                           compute_dtype: torch.dtype) -> torch.dtype:
    """The block's compute dtype: fp32 when block-diagonal (the Pallas
    kernel ignores ``compute_dtype`` there), else ``compute_dtype``, fp32
    or bf16 as JAX's ``_make_kernel`` takes."""
    if compute_dtype not in (_F32, _BF16):
        raise ValueError(f"{op}: compute_dtype {compute_dtype} is not "
                         f"torch.float32 or torch.bfloat16")
    return _F32 if block_diag else compute_dtype


def fused_attention_block_plain(
    x: torch.Tensor,             # (B, L, D) post-LN activations
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    num_heads: int,
    block_diag: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """softmax((x wq + bq) scale (x wk + bk)^T) (x wv + bv) wo + bo per head
    in the Pallas kernels' order, ``cd`` the compute dtype (fp32 when
    ``block_diag``): x and the weights cast to cd; each projection
    accumulated in fp32 plus its fp32 bias, cast to cd; ``q * cd(scale)``
    rounded in cd; fp32 scores, max and exp; ``p = cd(e / sum(e))``; PV in
    fp32 cast to cd; the out-projection in fp32 plus ``bo``, one cast to
    x's dtype. The caller adds the residual. With cd fp32 every cast is
    exact, so this is the block-diagonal kernel's all-fp32 function too
    (its -1e30 on other images' keys gives them exact zeros)."""
    cd = _attention_block_dtype("fused_attention_block", block_diag,
                                compute_dtype)
    xc = x.to(cd).float()

    def proj(a, w, b):
        return torch.matmul(a, w.to(cd).float()) + b.float()

    q = proj(xc, wq, bq).to(cd)
    q = q * torch.tensor((x.shape[-1] // num_heads) ** -0.5, dtype=cd)
    attn = _softmax_pv_f32(q, proj(xc, wk, bk).to(cd), proj(xc, wv, bv).to(cd),
                           num_heads, "normalised").to(cd)
    return proj(attn.float(), wo, bo).to(x.dtype)


# the fp32 chain's attention: the block kernel of csrc/attention_block.cu
# (one block an image and head, every row of the image: its fp32 Q, K, V
# and probabilities fit a block's shared memory at every head size) up to
# this length, csrc/attention_f32.cuh past it; the block kernel's route
ATTENTION_BLOCK_MAX_LEN = 128
F32_BLOCK = 3


def _attention_block_form(op: str, x: torch.Tensor, cd: torch.dtype,
                          weights: dict, biases: dict) -> tuple:
    """The form of a ``fused_attention_block`` CUDA call, as the Pallas
    kernels read their operands: x bf16 or fp32; the biases read as they
    are when all are bf16, else all fp32 (a bf16 one widened, exactly); the
    weights cast to the compute dtype ``cd``: for fp32, all bf16 (the
    products bf16) or else all fp32 (a bf16 one widened); for bf16, each
    cast to bf16 (a copy a call for an fp32 one). Any other dtype raises
    ValueError. Returns (w_f32, b_f32, weights, biases), each checked by
    ``_check_tensors``."""
    for name, t in {"x": x, **weights, **biases}.items():
        if t.dtype not in (_BF16, _F32):
            raise ValueError(f"{op}: {name} is {t.dtype}; the kernel takes "
                             "bfloat16 or float32")
    b_f32 = any(t.dtype == _F32 for t in biases.values())
    biases = {name: t.float() if b_f32 else t for name, t in biases.items()}
    w_f32 = cd == _F32 and any(t.dtype == _F32 for t in weights.values())
    weights = {name: t.float() if w_f32 else _bf16_weight(t)
               for name, t in weights.items()}
    dtypes = {"x": x.dtype,
              **{name: _F32 if b_f32 else _BF16 for name in biases},
              **{name: _F32 if w_f32 else _BF16 for name in weights}}
    _check_tensors(op, x.device, dtypes, x=x, **weights, **biases)
    return w_f32, b_f32, weights, biases


def fused_attention_block(
    x: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    num_heads: int,
    group: int = 16,
    block_diag: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The attention half of a CLIP block over post-LN x, without the
    residual, in the order of ``fused_attention_block_plain``. ``group`` is
    checked (it must divide B) and changes no result. CPU tensors take the
    plain version; CUDA tensors launch the kernel
    (``fused_attention_block.launches``, every form) or raise: the fp32
    chain when ``block_diag`` or ``compute_dtype`` is fp32 (the same
    function; x and the weights each bf16 or fp32, fp32 ones as three
    exact bf16 planes; its attention the block kernel up to 128 tokens,
    else csrc/attention_f32.cuh by ``vit_f32_route``, head sizes 64 and
    128), the bf16 chain otherwise (an fp32 x cast to bf16, the output
    written in x's dtype from the fp32 sum); the forms as
    ``_attention_block_form`` reads them."""
    op = "fused_attention_block"
    cd = _attention_block_dtype(op, block_diag, compute_dtype)
    _check_group(op, x.shape[0], group)
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                           num_heads, block_diag, cd)
    kernels.refuse_grad(op, x, wq, bq, wk, bk, wv, bv, wo, bo)
    w_f32, b_f32, ws, bs = _attention_block_form(
        op, x, cd, dict(wq=wq, wk=wk, wv=wv, wo=wo),
        dict(bq=bq, bk=bk, bv=bv, bo=bo))
    if x.dim() != 3:
        raise ValueError(f"{op}: x is {tuple(x.shape)}, expected (B, L, D)")
    batch, seq, d_model = x.shape
    vec, mat = (d_model,), (d_model, d_model)
    _check_shapes(op, **{name: (t, mat) for name, t in ws.items()},
                  **{name: (t, vec) for name, t in bs.items()})
    _check_vit_widths(op, D=d_model)
    rows, dev = batch * seq, x.device
    scale = (d_model // num_heads) ** -0.5
    x_f32 = x.dtype == _F32
    out = torch.empty_like(x)
    operands = [ws["wq"], bs["bq"], ws["wk"], bs["bk"], ws["wv"], bs["bv"],
                ws["wo"], bs["bo"]]
    if cd == _F32:
        head_dim = _vit_head_size(op, d_model, num_heads)
        if seq <= ATTENTION_BLOCK_MAX_LEN:
            route = F32_BLOCK
        else:
            head_dim = _vit_f32_head_size(op, d_model, num_heads)
            route = vit_f32_route(seq, head_dim)
        # through device memory, once each: fp32 x's and fp32 weights'
        # bf16 planes, the fp32 q, k, v, and the fp32 attention output as
        # three bf16 planes (lo | mid | hi, (M, 3 D)) whose products with
        # the weights' planes are exact
        empty = torch.empty((0,), dtype=_BF16, device=dev)
        x_planes = (torch.empty((rows, 3 * d_model), dtype=_BF16, device=dev)
                    if x_f32 else empty)
        w_planes = (torch.empty((4, 3 * d_model, d_model), dtype=_BF16,
                                device=dev) if w_f32 else empty)
        q, k, v = (torch.empty((rows, d_model), dtype=_F32, device=dev)
                   for _ in range(3))
        attn = torch.empty((rows, 3 * d_model), dtype=_BF16, device=dev)
        _run(op, _launcher_of("attention_block", op, 16, 8, 1),
             x.data_ptr(), *(t.data_ptr() for t in operands),
             x_planes.data_ptr(), w_planes.data_ptr(), q.data_ptr(),
             k.data_ptr(), v.data_ptr(), attn.data_ptr(), out.data_ptr(),
             batch, seq, num_heads, head_dim, int(x_f32), int(w_f32),
             int(b_f32), route, scale,
             torch.cuda.current_stream(dev).cuda_stream)
    else:
        # bf16 x (an fp32 one cast, as the Pallas kernel casts it), q, k, v
        # and attention output; the bf16 scale
        head_dim = _vit_head_dim(op, seq, d_model, num_heads)
        xb = x.to(_BF16)
        q, k, v, attn = (torch.empty((rows, d_model), dtype=_BF16,
                                     device=dev) for _ in range(4))
        scale = float(torch.tensor(scale, dtype=_BF16))
        _run(op, _launcher_of("attention_block", op + "_bf16", 14, 6, 1),
             xb.data_ptr(), *(t.data_ptr() for t in operands), q.data_ptr(),
             k.data_ptr(), v.data_ptr(), attn.data_ptr(), out.data_ptr(),
             batch, seq, num_heads, head_dim, int(x_f32), int(b_f32), scale,
             torch.cuda.current_stream(dev).cuda_stream)
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0


# ---------------------------------------------------------------------------
# GPT-2 whole block (ClipCap's teacher-forced forward): the plain version and
# the wrapper around csrc/gpt2_block.cu
#
# The Pallas kernel runs a group of G sequences as one (G L, G L) score
# matrix per head. A key is masked (-1e30) when it lies in another sequence
# of the group, is causally later or is invalid; a query row with a visible
# valid key gets exact zeros from every masked one. A row with none (a
# sequence that starts with padding) has all G L scores at exactly -1e30, so
# its softmax is uniform over the whole group and its output depends on G.
# The plain version computes the group's score matrix as the Pallas kernel
# does; the CUDA kernel works sequence by sequence and writes such rows in
# a pass of its own. Both take G as the JAX wrapper does.
# ---------------------------------------------------------------------------

# one GPT-2 layer's parameters, in the kernel's argument order
GPT2_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "attn_qkv", "attn_qkv_bias",
                   "attn_out", "attn_out_bias", "ln2_scale", "ln2_bias",
                   "mlp_fc", "mlp_fc_bias", "mlp_proj", "mlp_proj_bias")
GPT2_MASKED = -1e30
# the four products' weights, which the kernel takes in bf16
_GPT2_WEIGHTS = ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj")


def gpt2_block_group(batch: int, group: int = 4) -> int:
    """The JAX wrapper's group: ``group`` halved until it divides B."""
    while batch % group:
        group //= 2
    return max(group, 1)


def fused_gpt2_block_plain(
    x: torch.Tensor,             # (B, L, D) pre-LN residual stream
    mask: torch.Tensor,          # (B, L) key validity, > 0 for real tokens
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,   # (D, 3D), (3D,)
    w_out: torch.Tensor, b_out: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    group: int = 4,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The pre-LN causal GPT-2 block in the Pallas kernel's order of
    rounding, whatever x's dtype: ``h = bf16(LN1(x))``; ``qkv = h.w_qkv +
    b_qkv`` in fp32, q times the scale; the scores of q and k cast to bf16
    over each group of G sequences (G from ``gpt2_block_group``) plus the
    -1e30 mask; ``p = bf16(e / sum(e))``; PV with v cast to bf16, rounded to
    bf16; ``r1 = x + (attn.w_out + b_out)`` in fp32; ``h2 = bf16(LN2(r1))``;
    ``hid = bf16(tanh-gelu(h2.w_fc + b_fc))``; one cast of ``r1 +
    (hid.w_proj + b_proj)`` to x's dtype. Weights are rounded to bf16 as the
    JAX wrapper casts them."""
    bf = torch.bfloat16
    batch, seq, d_model = x.shape
    g = gpt2_block_group(batch, group)
    gl, head_dim = g * seq, d_model // num_heads
    x32 = x.reshape(batch // g, gl, d_model).float()

    def proj(a, w, b):
        return torch.matmul(a, _bf16_operand(w)) + b.float()

    def heads(t):  # (B/G, GL, D) -> bf16 values in fp32 (B/G, H, GL, dh)
        return t.reshape(batch // g, gl, num_heads, head_dim).transpose(1, 2) \
            .to(bf).float()

    h = _ln_f32(x32, ln1_scale, ln1_bias, eps).to(bf).float()
    qkv = proj(h, w_qkv, b_qkv)
    q = qkv[..., :d_model] * head_dim ** -0.5
    k, v = qkv[..., d_model:2 * d_model], qkv[..., 2 * d_model:]
    pos = torch.arange(gl, device=x.device)
    visible = ((pos[:, None] // seq == pos[None, :] // seq)
               & (pos[:, None] % seq >= pos[None, :] % seq))
    key_valid = mask.reshape(batch // g, 1, gl) > 0
    block_mask = torch.where(visible[None] & key_valid, 0.0, GPT2_MASKED)
    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) + block_mask[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(bf).float()
    attn = torch.matmul(p, heads(v)).transpose(1, 2).reshape(x32.shape)
    r1 = x32 + proj(attn.to(bf).float(), w_out, b_out)
    h2 = _ln_f32(r1, ln2_scale, ln2_bias, eps).to(bf).float()
    hid = _tanh_gelu(proj(h2, w_fc, b_fc)).to(bf).float()
    return (r1 + proj(hid, w_proj, b_proj)).reshape(x.shape).to(x.dtype)


def gpt2_attention_max_len(head_dim: int) -> int:
    """The longest sequence ``fused_gpt2_block``'s attention takes on the
    current card at this head size; 0 for an unsupported head size."""
    return _kernel_max_len("gpt2_block", "gpt2_attention_max_len", head_dim)


def fused_gpt2_block(
    x: torch.Tensor,
    mask: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,
    w_out: torch.Tensor, b_out: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int,
    group: int = 4,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The whole pre-LN causal GPT-2 block (tanh-gelu) over (B, L, D) x
    under the (B, L) key mask. ``group`` is the JAX wrapper's (halved until
    it divides B); it decides only the rows with no visible valid key. x is
    bf16 with every parameter bf16, or fp32 (the fp32 form: the four
    weights cast to bf16 here, as the JAX wrapper casts them, the
    LayerNorms and biases bf16 or fp32, widened to fp32 in the kernel);
    the output is in x's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel (``fused_gpt2_block.launches``, either form) or raise. The
    kernel is forward only: with grad enabled, an input that requires grad
    raises; the autograd form is ``fused_gpt2_block_vjp``."""
    op = "fused_gpt2_block"
    params = (ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out, ln2_scale,
              ln2_bias, w_fc, b_fc, w_proj, b_proj)
    if x.device.type == "cpu":
        return fused_gpt2_block_plain(x, mask, *params, num_heads, group, eps)
    kernels.refuse_grad(op, x, *params, vjp="fused_gpt2_block_vjp")
    f32 = x.dtype == _F32
    vector_dtype = _BF16
    if f32:
        for name, t in zip(GPT2_BLOCK_KEYS, params):
            if t.dtype not in (_BF16, _F32):
                raise ValueError(f"{op}: {name} is {t.dtype}; the fp32 form "
                                 "takes bfloat16 or float32 parameters")
        # the products' operands bf16; the vectors as they are when all are
        # bf16, else all fp32 (a bf16 one widened, which is exact)
        vector_dtype = _BF16 if all(
            t.dtype == _BF16 for name, t in zip(GPT2_BLOCK_KEYS, params)
            if name not in _GPT2_WEIGHTS) else _F32
        params = tuple(
            t.to(_BF16 if name in _GPT2_WEIGHTS else vector_dtype)
            .contiguous() for name, t in zip(GPT2_BLOCK_KEYS, params))
        (ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out, ln2_scale,
         ln2_bias, w_fc, b_fc, w_proj, b_proj) = params
    tensors = dict(zip(("x",) + GPT2_BLOCK_KEYS, (x,) + params))
    _check_tensors(op, x.device,
                   {name: (_F32 if f32 else _BF16) if name == "x" else _BF16
                    if name in _GPT2_WEIGHTS else vector_dtype
                    for name in tensors},
                   **tensors)
    if x.dim() != 3:
        raise ValueError(f"{op}: x is {tuple(x.shape)}, expected (B, L, D)")
    batch, seq, d_model = x.shape
    d_ff = w_fc.shape[-1]
    vec = (d_model,)
    _check_shapes(op, mask=(mask, (batch, seq)), ln1_scale=(ln1_scale, vec),
                  ln1_bias=(ln1_bias, vec),
                  attn_qkv=(w_qkv, (d_model, 3 * d_model)),
                  attn_qkv_bias=(b_qkv, (3 * d_model,)),
                  attn_out=(w_out, (d_model, d_model)),
                  attn_out_bias=(b_out, vec), ln2_scale=(ln2_scale, vec),
                  ln2_bias=(ln2_bias, vec), mlp_fc=(w_fc, (d_model, d_ff)),
                  mlp_fc_bias=(b_fc, (d_ff,)),
                  mlp_proj=(w_proj, (d_ff, d_model)),
                  mlp_proj_bias=(b_proj, vec))
    _check_vit_widths(op, D=d_model, F=d_ff)
    _check_norm_width(op, d_model)
    if num_heads <= 0 or d_model % num_heads:
        raise ValueError(
            f"{op}: width {d_model} is not a multiple of {num_heads} heads")
    head_dim = d_model // num_heads
    if head_dim not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{op}: head size {head_dim} is not one of "
                         f"{_SUPPORTED_HEAD_DIMS}")
    limit = gpt2_attention_max_len(head_dim)
    if seq > limit:
        raise ValueError(
            f"{op}: sequence length {seq} exceeds {limit}, the longest whose "
            f"score tile fits this card's shared memory at head size "
            f"{head_dim}")
    mask = mask.to(device=x.device, dtype=torch.int32).contiguous()
    rows, dev = batch * seq, x.device
    # through device memory, once each: bf16 h (LN1, then LN2), q, k, v and
    # the attention output; the fp32 residual r1; the bf16 tanh-gelu hidden
    h = torch.empty((rows, d_model), dtype=_BF16, device=dev)
    q, k, v, attn = (torch.empty((batch, seq, d_model), dtype=_BF16,
                                 device=dev) for _ in range(4))
    r1 = torch.empty((rows, d_model), dtype=_F32, device=dev)
    hidden = torch.empty((rows, d_ff), dtype=_BF16, device=dev)
    out = torch.empty_like(x)
    _run(op, _launcher_of("gpt2_block", op, 22, 8, 2),
         x.data_ptr(), mask.data_ptr(), *(t.data_ptr() for t in params),
         h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         attn.data_ptr(), r1.data_ptr(), hidden.data_ptr(), out.data_ptr(),
         batch, seq, num_heads, head_dim, d_ff,
         gpt2_block_group(batch, group), int(f32),
         int(vector_dtype == _F32), head_dim ** -0.5, eps,
         torch.cuda.current_stream(dev).cuda_stream)
    fused_gpt2_block.launches += 1
    return out


fused_gpt2_block.launches = 0


def _gpt2_block_reference(
    x: torch.Tensor, mask: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,
    w_out: torch.Tensor, b_out: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int, eps: float,
    *, wide: torch.dtype = torch.float32, narrow: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """JAX's ``_gpt2_block_reference`` (:961-995), which its custom VJP
    differentiates: the block of ``fused_gpt2_block_plain`` sequence by
    sequence, softmax normalised in ``wide`` before its cast to ``narrow``,
    and no averaging over the kernel's group on a row with no visible
    valid key (the -1e30 scores give that row a uniform softmax over its own
    keys). ``wide`` and ``narrow`` are fp32 and bf16 except in the float64
    gradient check."""
    batch, seq, d_model = x.shape
    head_dim = d_model // num_heads

    def operand(t):
        return t.to(narrow).to(wide)

    def mm(a, w):
        return torch.matmul(operand(a), operand(w))

    def heads(t):
        return t.reshape(batch, seq, num_heads, head_dim)

    x32 = x.to(wide)
    qkv = mm(_ln_f32(x32, ln1_scale, ln1_bias, eps), w_qkv) + b_qkv.to(wide)
    q, k, v = qkv.split(d_model, dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", operand(heads(q * head_dim ** -0.5)),
                     operand(heads(k)))
    causal = torch.ones((seq, seq), dtype=torch.bool, device=x.device).tril()
    visible = causal[None, None] & (mask[:, None, None, :] > 0)
    s = s + torch.where(visible, 0.0, GPT2_MASKED).to(wide)
    p = operand(torch.softmax(s, dim=-1))
    attn = torch.einsum("bhqk,bkhd->bqhd", p, operand(heads(v)))
    r1 = x32 + mm(attn.reshape(x.shape), w_out) + b_out.to(wide)
    hid = _tanh_gelu(mm(_ln_f32(r1, ln2_scale, ln2_bias, eps), w_fc)
                     + b_fc.to(wide))
    return (r1 + mm(hid, w_proj) + b_proj.to(wide)).to(x.dtype)


class _FusedGpt2BlockVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, *rest):
        params, (num_heads, eps) = rest[:-2], rest[-2:]
        ctx.save_for_backward(x, mask, *params)
        ctx.num_heads, ctx.eps = num_heads, eps
        return fused_gpt2_block(x, mask, *params, num_heads=num_heads,
                                eps=eps)

    @staticmethod
    def backward(ctx, d_out):
        x, mask, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        grads = _twin_grads(
            (needs[0],) + needs[2:2 + len(params)], (x, *params),
            lambda x_, *p_: _gpt2_block_reference(
                x_, mask, *p_, ctx.num_heads, ctx.eps), d_out)
        return (grads[0], None, *grads[1:], None, None)


def fused_gpt2_block_vjp(
    x: torch.Tensor, mask: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,
    w_out: torch.Tensor, b_out: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w_fc: torch.Tensor, b_fc: torch.Tensor,
    w_proj: torch.Tensor, b_proj: torch.Tensor,
    num_heads: int, eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable ``fused_gpt2_block`` (JAX ``fused_gpt2_block_vjp``,
    :999-1045; the wrapper's default group of 4): the wrapper forward (the
    kernel on CUDA tensors), the gradient through ``_gpt2_block_reference``,
    so ClipCap's loss reaches the mapper through the frozen GPT-2. ``mask``
    gets no gradient. No kernel runs in the backward."""
    return _FusedGpt2BlockVJP.apply(
        x, mask, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out, ln2_scale,
        ln2_bias, w_fc, b_fc, w_proj, b_proj, num_heads, eps)
