"""T5 encoder self-attention core: the CUDA kernel and its plain version.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
::t5_attention_core (:1105-1180). The kernel is
``csrc/t5_attention_core.cu``; its note gives the design and the bound.

The plain version follows the Pallas kernel's order of rounding, not that
of the JAX package's XLA twin ``_t5_attention_reference``: the kernel casts
the unnormalised probabilities to the input dtype before PV, sums the
denominator from those cast values and divides after PV. In bf16 that
order gives the kernel's results bit for bit, where the XLA twin's order
(normalise in fp32, then PV) differs by up to a bf16 ulp.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e9
_SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
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


def _launcher():
    fn = kernels.load("t5_attention_core").t5_attention_core_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def max_seq_len(head_dim: int) -> int:
    """The longest sequence the kernel takes on the current card: its
    (32, L) fp32 score tile lives in shared memory."""
    if head_dim not in _max_len_cache:
        fn = kernels.load("t5_attention_core").t5_attention_core_max_len
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        _max_len_cache[head_dim] = fn(head_dim)
    return _max_len_cache[head_dim]


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
    for name in ("q", "k", "v"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(
                f"t5_attention_core: {name} is {tensors[name].dtype}; the "
                "kernel takes bfloat16 only")
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
    if head_dim not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"t5_attention_core: head size {head_dim} is not one of "
            f"{_SUPPORTED_HEAD_DIMS}")
    if tuple(pos_bias.shape) != (num_heads, seq, seq):
        raise ValueError(
            f"t5_attention_core: pos_bias is {tuple(pos_bias.shape)}, "
            f"expected {(num_heads, seq, seq)}")
    if tuple(mask.shape) != (batch, seq):
        raise ValueError(
            f"t5_attention_core: mask is {tuple(mask.shape)}, expected "
            f"{(batch, seq)}")
    limit = max_seq_len(head_dim)
    if seq > limit:
        raise ValueError(
            f"t5_attention_core: sequence length {seq} exceeds {limit}, the "
            f"longest whose score tile fits this card's shared memory at "
            f"head size {head_dim}")
    return head_dim


def t5_attention_core(
    q: torch.Tensor,         # (B, L, H*dh) — UNSCALED (T5 convention)
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,  # (H, L, L) fp32
    mask: torch.Tensor,      # (B, L) int32 key-validity mask
    num_heads: int,
) -> torch.Tensor:
    """T5 encoder self-attention core: scores + position bias + key mask +
    softmax + PV. CPU tensors take the plain version; CUDA tensors launch
    the kernel (``t5_attention_core.launches`` counts those launches) or
    raise."""
    if q.device.type == "cpu":
        return t5_attention_core_plain(q, k, v, pos_bias, mask, num_heads)
    batch, seq, _ = q.shape
    head_dim = _check_kernel_inputs(q, k, v, pos_bias, mask, num_heads)
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_bias.data_ptr(),
        mask.data_ptr(), out.data_ptr(), batch, seq, num_heads, head_dim,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"t5_attention_core kernel launch failed: cudaError {rc}")
    t5_attention_core.launches += 1
    return out


t5_attention_core.launches = 0
