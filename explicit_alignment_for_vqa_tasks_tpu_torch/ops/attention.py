"""The fp32 attention of the CLIP encoder's ``use_pallas`` option: the CUDA
kernel with its plain version.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/ops/attention.py
(``flash_attention``, :29-152), kernel ``csrc/flash_attention.cu`` over
``csrc/vit_attention_wgmma.cuh`` (two passes over the keys on wgmma and
TMA, any Lq and Lk; its note gives the design and the bound). The
interface is JAX's: (B, Lq, H, D)
pre-scaled queries, (B, Lk, H, D) keys and values, an optional additive
bias broadcastable to (B, H, Lq, Lk); the output is (B, Lq, H, D) in q's
dtype.

Order of rounding, the Pallas kernel's: q, k and v upcast to fp32; the bias
in fp32; ``s = q k^T + bias``; ``p = exp(s - max s)`` unnormalised in fp32;
``o = (p v) / sum(p)`` in fp32; one cast to q's dtype.

Padding, JAX's (:89-121): Lk is padded to a multiple of 128 (at least 8)
with keys whose value is 0 and whose score is exactly -1e9. They add
nothing to a row that has a key scored above -1e9, but a row whose bias
masks every key (each score near -1e9) counts them in its denominator; the
plain version pads the keys as JAX does, and the kernel counts them without
storing them. JAX also pads Lq to its query block; that changes no real row,
so neither version does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

Q_BLOCK = 256          # the JAX wrapper's default query block
KEY_MULTIPLE = 128     # Lk is padded to a multiple of this (at least 8)
PAD_SCORE = -1e9       # the padded keys' bias
_SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_key_len(lk: int) -> int:
    """The JAX wrapper's padded key length."""
    return _ceil_to(max(lk, 8), KEY_MULTIPLE)


def flash_attention_plain(
    q: torch.Tensor,                 # (B, Lq, H, D) pre-scaled queries
    k: torch.Tensor,                 # (B, Lk, H, D)
    v: torch.Tensor,                 # (B, Lk, H, D)
    bias: Optional[torch.Tensor] = None,   # broadcastable to (B, H, Lq, Lk)
) -> torch.Tensor:
    """softmax(q k^T + bias) v per (batch, head) in the Pallas kernel's order
    over JAX's padded keys (see the module note); (B, Lq, H, D) in q's
    dtype."""
    batch, lq, heads, _ = q.shape
    lk = k.shape[1]
    n_pad = padded_key_len(lk) - lk

    def heads_first(t, pad):   # (B, L, H, D) -> fp32 (B, H, L + pad, D)
        t = t.permute(0, 2, 1, 3).float()
        return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t

    s = torch.matmul(heads_first(q, 0), heads_first(k, n_pad).transpose(-1, -2))
    if bias is not None:
        full = torch.broadcast_to(bias.float(), (batch, heads, lq, lk))
        s = s + torch.nn.functional.pad(full, (0, n_pad), value=PAD_SCORE)
    elif n_pad:
        s[..., lk:] = PAD_SCORE
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()   # in place: B H Lq Lk
    o = torch.matmul(p, heads_first(v, n_pad)) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def _launcher():
    fn = kernels.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, bias) -> None:
    op = "flash_attention"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{op}: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{op}: {name} is {t.dtype}; the kernel takes "
                             f"torch.bfloat16 only")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous (B, L, H, D) "
                             f"tensor, not {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (
            q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    head_dim = q.shape[3]
    if head_dim not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{op}: head size {head_dim} is not one of "
                         f"{_SUPPORTED_HEAD_DIMS}")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{op}: bias is on {bias.device}, q on {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention over (B, L, H, D) pre-scaled q; returns (B, Lq, H, D)
    in q's dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``flash_attention.launches``), which takes bf16 q, k and v, or
    raise. The bias is read in place through broadcast strides."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    kernels.refuse_grad("flash_attention", q, k, v, bias)
    _check_inputs(q, k, v, bias)
    batch, lq, heads, head_dim = q.shape
    lk = k.shape[1]
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias = torch.broadcast_to(bias.float(), (batch, heads, lq, lk))
        strides = bias.stride()
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        batch, lq, lk, heads, head_dim, padded_key_len(lk) - lk, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
