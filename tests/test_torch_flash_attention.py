"""The port's flash_attention (the CLIP encoder's use_pallas attention):
flash_attention_plain against the JAX package's Pallas flash_attention
(interpret mode on the CPU) in fp32 and bf16, with no bias, a key-mask
bias, a causal bias, a per-(batch, head) bias, Lq != Lk (neither a multiple
of 8), Lq above the 256-row query block, and rows the bias masks entirely;
the wrapper on CPU tensors; and the CUDA kernel against the plain version
on the card, also at head sizes 32 and 128 and at 2,500 keys."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.ops import attention as tattn
from test_torch_vit_kernels import bf16_ulp_of  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HEADS, HEAD_DIM = 2, 16
# fp32: the same operations, fp32 sums in another order
# (tests/test_attention.py holds JAX's kernel to its XLA reference at 2e-5)
FP32_TOL = 2e-5
# bf16: every element within one bf16 ulp of JAX's and at least 99.9 % equal
MIN_EQUAL = 0.999


def make_qkv(seed=0, batch=2, lq=20, lk=20):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, lq, HEADS, HEAD_DIM)).astype(np.float32)
    k = rng.standard_normal((batch, lk, HEADS, HEAD_DIM)).astype(np.float32)
    v = rng.standard_normal((batch, lk, HEADS, HEAD_DIM)).astype(np.float32)
    return q * HEAD_DIM ** -0.5, k, v


def key_mask_bias(batch, lk, valid):
    """(B, 1, 1, Lk): 0 on each row's first valid[b] keys, -1e9 after."""
    bias = np.zeros((batch, 1, 1, lk), np.float32)
    for b, n in enumerate(valid):
        bias[b, ..., n:] = -1e9
    return bias


def run_jax(q, k, v, bias, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from explicit_alignment_for_vqa_tasks_tpu.ops.attention import (
        flash_attention,
    )

    jd = getattr(jnp, dtype)
    out = flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                          jnp.asarray(v, jd),
                          bias=None if bias is None else jnp.asarray(bias),
                          interpret=True)
    return np.asarray(out.astype(jnp.float32))


def run_port(fn, q, k, v, bias, dtype):
    td = TORCH_DTYPES[dtype]
    out = fn(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
             torch.from_numpy(v).to(td),
             None if bias is None else torch.from_numpy(bias))
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy()


def assert_close(got, want, dtype):
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= bf16_ulp_of(want)).all(), \
            np.abs(got - want).max()
        assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
        return
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def causal_bias(lq, lk):
    return np.where(np.tril(np.ones((lq, lk), bool)), 0.0, -1e9) \
        .astype(np.float32)[None, None]


CASES = {
    # name: (batch, lq, lk, bias(batch, lq, lk) or None)
    "no_bias": (2, 20, 20, lambda b, lq, lk: None),
    "key_mask": (3, 20, 20,
                 lambda b, lq, lk: key_mask_bias(b, lk, (20, 13, 4))),
    "causal": (2, 24, 24, lambda b, lq, lk: causal_bias(lq, lk)),
    "lq_ne_lk": (2, 13, 37, lambda b, lq, lk: None),
    "per_batch_head": (
        2, 20, 30, lambda b, lq, lk: np.random.default_rng(9).standard_normal(
            (b, HEADS, lq, lk)).astype(np.float32)),
    "long_queries": (1, 300, 140, lambda b, lq, lk: None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case, dtype):
    batch, lq, lk, make_bias = CASES[case]
    q, k, v = make_qkv(seed=len(case), batch=batch, lq=lq, lk=lk)
    bias = make_bias(batch, lq, lk)
    want = run_jax(q, k, v, bias, dtype)
    got = run_port(tattn.flash_attention_plain, q, k, v, bias, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_counts_the_padded_keys(dtype):
    """A row whose bias masks every key (-1e9): its scores and the padded
    keys' all sit near -1e9, so JAX's denominator counts the 128 - 20 padded
    keys (whose v is 0) and the row is the mean of v shrunk by 20 / 128;
    the plain version gives the same."""
    q, k, v = make_qkv(seed=3, batch=2, lq=20, lk=20)
    bias = key_mask_bias(2, 20, (20, 0))
    want = run_jax(q, k, v, bias, dtype)
    got = run_port(tattn.flash_attention_plain, q, k, v, bias, dtype)
    assert_close(got, want, dtype)
    mean_v = v[1].mean(axis=0)
    shrunk = mean_v * 20 / tattn.padded_key_len(20)
    np.testing.assert_allclose(got[1], np.broadcast_to(shrunk, got[1].shape),
                               rtol=0, atol=2e-2)


def test_padded_key_len_follows_jax():
    assert [tattn.padded_key_len(n) for n in (1, 8, 20, 128, 129, 577)] == [
        128, 128, 128, 128, 256, 640]


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = make_qkv(seed=4)
    bias = key_mask_bias(2, 20, (20, 9))
    before = tattn.flash_attention.launches
    for b in (None, bias):
        got = run_port(tattn.flash_attention, q, k, v, b, "bfloat16")
        want = run_port(tattn.flash_attention_plain, q, k, v, b, "bfloat16")
        np.testing.assert_array_equal(got, want)
    assert tattn.flash_attention.launches == before


# --- on the card: the CUDA kernel against the plain version -----------------

def cuda_qkv(batch, lq, lk, heads=16, head_dim=64, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = (randn(batch, lq, heads, head_dim) * head_dim ** -0.5).bfloat16()
    return q, randn(batch, lk, heads, head_dim).bfloat16(), \
        randn(batch, lk, heads, head_dim).bfloat16()


def assert_within_one_ulp(got, want):
    """Every element within one bf16 ulp of the larger of the two values
    (neighbours across a power of two), and at least the ulp of rms(want) /
    256: an output near zero is a sum of terms far larger than itself, and
    fp32 sums in another order move it by more than its own ulp (the rule
    of chip_smoke.py's flash_attention phase)."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    top = np.maximum(np.maximum(np.abs(g), np.abs(w)),
                     np.sqrt(np.mean(w ** 2)) / 256)
    assert (np.abs(g - w) <= bf16_ulp_of(top)).all(), np.abs(g - w).max()


# name: (batch, lq, lk, heads, head_dim, bias kind)
CUDA_CASES = {
    "none": (2, 577, 577, 16, 64, None),
    "key_mask": (3, 70, 200, 4, 64, "key_mask"),
    "causal": (2, 150, 150, 4, 64, "causal"),
    "lq_ne_lk": (2, 13, 237, 4, 64, None),
    "per_batch_head": (3, 70, 200, 4, 64, "per_batch_head"),
    "long_queries": (1, 300, 140, 4, 64, None),
    "fully_masked_row": (3, 70, 200, 4, 64, "fully_masked_row"),
    "head_dim_32": (2, 577, 577, 8, 32, None),
    "head_dim_128": (2, 577, 577, 8, 128, "per_batch_head"),
    # beyond the 1,664 keys whose (32, Lk) fp32 score tile fitted the
    # shared memory of the WMMA kernel this one replaced
    "long_keys": (2, 96, 2500, 4, 64, "key_mask"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_flash_attention_matches_plain_version(case):
    """ViT-L/14@336's 577 tokens and 16 heads of 64 on 2 images without a
    bias, and smaller cases under each bias kind, at Lq != Lk, Lq above
    JAX's 256-row query block, head sizes 32 and 128 and 2,500 keys: every
    element within one bf16 ulp of the plain version, one launch counted,
    q, k, v of two dtypes refused (all fp32 take the fp32 form:
    tests/test_torch_vit_whole_f32.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch, lq, lk, heads, head_dim, kind = CUDA_CASES[case]
    q, k, v = cuda_qkv(batch, lq, lk, heads=heads, head_dim=head_dim)
    bias = None
    if kind == "per_batch_head":
        bias = torch.randn((batch, heads, lq, lk), device="cuda")
    elif kind == "causal":
        bias = torch.from_numpy(causal_bias(lq, lk)).cuda()
    elif kind is not None:
        valid = [lk - 50 * b for b in range(batch)]
        valid[-1] = 0 if kind == "fully_masked_row" else 9
        bias = torch.from_numpy(key_mask_bias(batch, lk, valid)).cuda()
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    assert_within_one_ulp(got, tattn.flash_attention_plain(q, k, v, bias))
    with pytest.raises(ValueError, match="one dtype"):
        tattn.flash_attention(q.float(), k, v, bias)
