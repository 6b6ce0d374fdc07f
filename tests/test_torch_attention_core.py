"""The port's t5_attention_core against the JAX package's Pallas kernel
(interpret mode on the CPU), and the CUDA kernel against its plain version
on the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (
    t5_attention_core,
    t5_attention_core_plain,
)

# (batch, length, heads, head_dim, padded tails per row, fully masked rows)
CASES = {
    "padded_and_fully_masked": (3, 13, 4, 8, (0, 4, 0), (2,)),
    "odd_heads": (2, 11, 3, 8, (1, 0), ()),
    "five_heads_dh16": (2, 21, 5, 16, (0, 7), (1,)),
    "single_row": (1, 9, 2, 8, (0,), ()),
}

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(case, seed=0):
    batch, length, heads, head_dim, pads, masked = CASES[case]
    rng = np.random.default_rng(seed)
    width = heads * head_dim
    q, k, v = (rng.standard_normal((batch, length, width)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((heads, length, length)).astype(np.float32)
    mask = np.ones((batch, length), np.int32)
    for b, pad in enumerate(pads):
        if pad:
            mask[b, -pad:] = 0
    for b in masked:
        mask[b] = 0
    return q, k, v, bias, mask, heads


def run_jax(q, k, v, bias, mask, heads, dtype):
    # imported here, so that the gpu tests below also run where jax is
    # not installed
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops.fused_attention_block import (
        t5_attention_core as jax_t5_attention_core,
    )

    jdtype = getattr(jnp, dtype)
    out = jax_t5_attention_core(
        jnp.asarray(q, jdtype), jnp.asarray(k, jdtype), jnp.asarray(v, jdtype),
        jnp.asarray(bias), jnp.asarray(mask), heads, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def run_port(fn, q, k, v, bias, mask, heads, dtype):
    t = TORCH_DTYPES[dtype]
    out = fn(torch.from_numpy(q).to(t), torch.from_numpy(k).to(t),
             torch.from_numpy(v).to(t), torch.from_numpy(bias),
             torch.from_numpy(mask), heads)
    assert out.dtype == t and out.shape == q.shape
    return out.float().numpy()


# fp32: both sides accumulate in fp32 in other orders. bf16: within one
# bf16 ulp of the output (the orders of rounding are the same, so most
# elements agree bit for bit).
TOLERANCE = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=8e-3, atol=8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case, dtype):
    inputs = make_inputs(case)
    want = run_jax(*inputs, dtype)
    got = run_port(t5_attention_core_plain, *inputs, dtype)
    np.testing.assert_allclose(got, want, **TOLERANCE[dtype])


def test_fully_masked_row_is_uniform_mean_of_v():
    q, k, v, bias, mask, heads = make_inputs("padded_and_fully_masked")
    got = run_port(t5_attention_core_plain, q, k, v, bias, mask, heads,
                   "float32")
    np.testing.assert_allclose(
        got[2], np.broadcast_to(v[2].mean(axis=0), got[2].shape),
        rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    inputs = make_inputs("odd_heads")
    before = t5_attention_core.launches
    got = run_port(t5_attention_core, *inputs, "bfloat16")
    want = run_port(t5_attention_core_plain, *inputs, "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert t5_attention_core.launches == before


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_library_path_is_keyed_by_source_hash():
    path = kernels.library_path("t5_attention_core")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("t5_attention_core-")
    assert path == kernels.library_path("t5_attention_core")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length,heads,head_dim", [
    (4, 557, 32, 64),   # the main path's length and heads at T0-3B width
    (2, 37, 3, 16),
    (3, 130, 5, 128),
])
def test_cuda_kernel_matches_plain_version(batch, length, heads, head_dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    width = heads * head_dim

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    q = randn(batch, length, width, scale=0.5).bfloat16()
    k = randn(batch, length, width, scale=0.5).bfloat16()
    v = (torch.rand((batch, length, width), generator=gen, device="cuda")
         * 2 - 1).bfloat16()
    bias = randn(heads, length, length)
    mask = torch.ones((batch, length), dtype=torch.int32, device="cuda")
    mask[1, -length // 5:] = 0
    mask[batch - 1] = 0
    before = t5_attention_core.launches
    got = t5_attention_core(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    assert t5_attention_core.launches == before + 1
    want = t5_attention_core_plain(q, k, v, bias, mask, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)
    with pytest.raises(ValueError, match="bfloat16"):
        t5_attention_core(q.float(), k.float(), v.float(), bias, mask, heads)
    with pytest.raises(ValueError, match="int32"):
        t5_attention_core(q, k, v, bias, mask.bool(), heads)
