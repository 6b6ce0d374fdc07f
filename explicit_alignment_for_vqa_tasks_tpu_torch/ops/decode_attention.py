"""Decode-step cross-attention (one query token) over the stacked caches.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/decode_attention.py
(``cross_attention_decode``, pallas_call at :134, body :54-78); the CUDA
kernel is ``csrc/cross_attention_decode.cu``, whose note gives the design
and the bound. It takes bf16 caches, and fp32 ones (the compute dtype
``tpu.compute_dtype=float32`` gives), with q of the caches' dtype.

The plain version follows the Pallas kernel's order of rounding: q is cast
to the cache dtype, the scores are that cast q against the cache-dtype K
accumulated in fp32 (no 1/sqrt(dh) scale), masked keys add -1e9, the
softmax is fp32 and normalised BEFORE the probabilities are cast to the
cache dtype, and PV accumulates in fp32 before one cast to q's dtype. The
TPU kernel's block-diagonal query matrix only adds zero cross-head
products; the port computes per head. Its fp32 products run in true fp32
on the card: the port leaves ``torch.backends.cuda.matmul.allow_tf32`` at
its default, False.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e9
_SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
# the caches' dtype -> the kernel's entry point
_LAUNCHERS = {torch.bfloat16: "cross_attention_decode_launch",
              torch.float32: "cross_attention_decode_f32_launch"}


def cross_attention_decode_plain(
    q: torch.Tensor,        # (B, D) current-step cross queries, D = H*dh
    k_cache: torch.Tensor,  # (layers, B, L, D) — the whole stacked cache
    v_cache: torch.Tensor,  # (layers, B, L, D)
    mask: torch.Tensor,     # (B, L) encoder key-validity mask
    layer: int,             # which layer's cache to read
    num_heads: int,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch; (B, D) in q's dtype."""
    _, batch, seq, width = k_cache.shape
    head_dim = width // num_heads
    cd = k_cache.dtype
    k = k_cache[layer].reshape(batch, seq, num_heads, head_dim).float()
    v = v_cache[layer].reshape(batch, seq, num_heads, head_dim).float()
    qh = q.to(cd).float().reshape(batch, num_heads, head_dim)
    s = torch.einsum("blhd,bhd->bhl", k, qh)
    s = s + torch.where(mask[:, None, :] > 0, 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(cd)
    out = torch.einsum("bhl,blhd->bhd", p.float(), v)
    return out.reshape(batch, width).to(q.dtype)


def _launcher(symbol: str):
    fn = getattr(kernels.load("cross_attention_decode"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k_cache, v_cache, mask, layer, num_heads) -> int:
    op = "cross_attention_decode"
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache, "mask": mask}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(
                f"{op}: {name} is on {t.device}, the kernel needs every "
                f"input on q's CUDA device ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")
    if k_cache.dtype not in _LAUNCHERS:
        raise ValueError(
            f"{op}: k_cache is {k_cache.dtype}; the kernel takes bfloat16 or "
            "float32")
    for name in ("q", "v_cache"):
        if tensors[name].dtype != k_cache.dtype:
            raise ValueError(
                f"{op}: {name} is {tensors[name].dtype}, k_cache is "
                f"{k_cache.dtype}; the kernel takes q and the caches of one "
                "dtype (bfloat16 or float32)")
    if mask.dtype != torch.int32:
        raise ValueError(f"{op}: mask is {mask.dtype}, not int32")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"{op}: k_cache and v_cache must share one (layers, B, L, D) "
            f"shape, got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    layers, batch, seq, width = k_cache.shape
    if tuple(q.shape) != (batch, width):
        raise ValueError(
            f"{op}: q is {tuple(q.shape)}, expected {(batch, width)}")
    if tuple(mask.shape) != (batch, seq):
        raise ValueError(
            f"{op}: mask is {tuple(mask.shape)}, expected {(batch, seq)}")
    if not 0 <= layer < layers:
        raise ValueError(f"{op}: layer {layer} is outside 0..{layers - 1}")
    if width % num_heads:
        raise ValueError(
            f"{op}: width {width} is not a multiple of {num_heads} heads")
    head_dim = width // num_heads
    if head_dim not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{op}: head size {head_dim} is not one of "
            f"{_SUPPORTED_HEAD_DIMS}")
    return head_dim


def cross_attention_decode(
    q: torch.Tensor,        # (B, D)
    k_cache: torch.Tensor,  # (layers, B, L, D)
    v_cache: torch.Tensor,  # (layers, B, L, D)
    mask: torch.Tensor,     # (B, L) int32
    layer: int,
    num_heads: int,
) -> torch.Tensor:
    """(B, D) cross-attention output of one decode step for decoder layer
    ``layer``. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``cross_attention_decode.launches`` counts those launches) or
    raise."""
    if q.device.type == "cpu":
        return cross_attention_decode_plain(q, k_cache, v_cache, mask, layer,
                                            num_heads)
    kernels.refuse_grad("cross_attention_decode", q, k_cache, v_cache)
    head_dim = _check_kernel_inputs(q, k_cache, v_cache, mask, layer,
                                    num_heads)
    layers, batch, seq, _ = k_cache.shape
    out = torch.empty_like(q)
    rc = _launcher(_LAUNCHERS[k_cache.dtype])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        out.data_ptr(), layer, layers, batch, seq, num_heads, head_dim,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"cross_attention_decode kernel launch failed: cudaError {rc}")
    cross_attention_decode.launches += 1
    return out


cross_attention_decode.launches = 0
