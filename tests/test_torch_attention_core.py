"""The port's t5_attention_core against the JAX package's Pallas kernel
(interpret mode on the CPU), and the CUDA kernel against its plain version
on the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as fab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (
    t5_attention_core,
    t5_attention_core_plain,
    t5_bias_tiles,
)

# (batch, length, heads, head_dim, padded tails per row, fully masked rows)
CASES = {
    "padded_and_fully_masked": (3, 13, 4, 8, (0, 4, 0), (2,)),
    "odd_heads": (2, 11, 3, 8, (1, 0), ()),
    "five_heads_dh16": (2, 21, 5, 16, (0, 7), (1,)),
    "single_row": (1, 9, 2, 8, (0,), ()),
    # masked keys 60-64 and 59-128 straddle the kernel's 64-key tiles
    "straddle_tile_65": (2, 65, 2, 16, (5, 0), ()),
    "straddle_tiles_129": (2, 129, 2, 16, (0, 70), (0,)),
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


@pytest.mark.parametrize("length", [13, 70, 129])
def test_bias_tiles_put_each_value_where_its_thread_reads_it(length):
    """t5_bias_tiles: bias[h, row, col] at float 4 (128 g + t) + 2 half + e
    of block (h, row // 64, col // 64), t = 32 w + 4 gid + tig for the
    block's row 16 w + 8 half + gid and column 8 g + 2 tig + e (wgmma's
    accumulator layout), an even number of 64-row blocks, zeros past L."""
    heads = 2
    bias = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (heads, length, length)).astype(np.float32))
    tiles = t5_bias_tiles(bias)
    blocks, keys = -(-length // 128) * 2, -(-length // 64)
    assert tiles.shape == (heads, blocks, keys, 8, 4, 8, 4, 2, 2)
    assert tiles.is_contiguous()
    flat = tiles.reshape(heads, blocks, keys, 4096)
    h, row, col = np.meshgrid(np.arange(heads), np.arange(length),
                              np.arange(length), indexing="ij")
    rr, cc = row % 64, col % 64
    t = 32 * (rr // 16) + 4 * (rr % 8) + (cc % 8) // 2
    at = 4 * (128 * (cc // 8) + t) + 2 * ((rr % 16) // 8) + cc % 2
    got = flat[h, row // 64, col // 64, at]
    np.testing.assert_array_equal(got.numpy(), bias.numpy())
    assert float(flat.abs().sum()) == pytest.approx(
        float(bias.abs().sum()), rel=1e-6)


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
@pytest.mark.parametrize("batch,length,heads,head_dim,edge", [
    (4, 557, 32, 64, None),   # the main path's length and heads at T0-3B width
    (2, 37, 3, 16, None),
    (3, 130, 5, 128, None),
    (2, 1, 3, 32, None),      # a single key
    (3, 65, 4, 64, 64),       # a key tile of one key; row 0 masked from 64
    (2, 1700, 2, 64, None),   # beyond the earlier shared-memory length cap
    (32, 557, 32, 64, None),  # the main path's shape
])
def test_cuda_kernel_matches_plain_version(batch, length, heads, head_dim,
                                           edge):
    """bf16: within 8e-3 (1 + |want|) of the plain version, one launch
    counted; the last row, fully masked, is the mean of v over all keys."""
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
    if edge is not None:
        mask[0, edge:] = 0
    mask[batch - 1] = 0
    before = t5_attention_core.launches
    got = t5_attention_core(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    assert t5_attention_core.launches == before + 1
    want = t5_attention_core_plain(q, k, v, bias, mask, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)
    # the bias tiles the encoder builds once for its layers: the same bits
    assert torch.equal(t5_attention_core(q, k, v, bias, mask, heads,
                                         t5_bias_tiles(bias)), got)
    uniform = v[batch - 1].float().mean(dim=0)
    torch.testing.assert_close(got[batch - 1].float(),
                               uniform.expand(length, -1), rtol=8e-3,
                               atol=8e-3)
    with pytest.raises(ValueError, match="one dtype"):
        t5_attention_core(q.float(), k, v, bias, mask, heads)
    with pytest.raises(ValueError, match="int32"):
        t5_attention_core(q, k, v, bias, mask.bool(), heads)


HELD = "t5_attention_core_f32_held_launch"
TWO_PASS = "t5_attention_core_f32_launch"
# the held route's longest L (csrc/attention_f32.cuh's note)
HELD_MAX_LEN = {64: 576, 128: 256}


@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_route_holds_score_rows_up_to_their_limit(head_dim):
    """Every L whose score rows fit a block's 232,448 bytes takes the held
    kernel, among them 1, 64, 65, 130 and the main path's 557 (at dh 64);
    one row more exceeds them, and every longer L takes the two-pass
    kernel."""
    limit = HELD_MAX_LEN[head_dim]
    assert fab.t5_f32_held_smem_bytes(limit, head_dim) <= 232448
    assert fab.t5_f32_held_smem_bytes(limit + 1, head_dim) > 232448
    for length in (1, 64, 65, 130, 557):
        if length <= limit:
            assert fab.t5_f32_route(length, head_dim) == HELD
    assert all(fab.t5_f32_route(length, head_dim) == HELD
               for length in range(1, limit + 1))
    assert all(fab.t5_f32_route(length, head_dim) == TWO_PASS
               for length in range(limit + 1, 4 * limit))


def f32_case(batch, length, heads, head_dim, edge, seed=0):
    """fp32 q, k, v, bias and mask on the card: row 1 padded by a fifth,
    row 0 masked from ``edge``, the last row fully masked."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    width = heads * head_dim

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    q = randn(batch, length, width, scale=0.5)
    k = randn(batch, length, width, scale=0.5)
    v = torch.rand((batch, length, width), generator=gen, device="cuda") * 2 - 1
    bias = randn(heads, length, length)
    mask = torch.ones((batch, length), dtype=torch.int32, device="cuda")
    if batch > 2:
        mask[1, -max(length // 5, 1):] = 0
    if edge is not None:
        mask[0, edge:] = 0
    mask[batch - 1] = 0
    return q, k, v, bias, mask, heads


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length,heads,head_dim,edge,route", [
    (32, 557, 32, 64, None, HELD),  # the main path's shape
    (4, 130, 5, 128, None, HELD),
    (2, 1, 3, 64, None, HELD),      # a single key
    (3, 65, 4, 64, 64, HELD),       # a tile of one key; row 0 masked from 64
    (2, 700, 2, 64, None, TWO_PASS),   # past the held rows' limit
    (2, 300, 3, 128, 150, TWO_PASS),
])
def test_cuda_f32_kernel_matches_plain_version(batch, length, heads,
                                               head_dim, edge, route):
    """fp32: within 1e-5 + 1e-5 |want| of the plain version by the route L
    gives, one launch counted; the last row, fully masked, is the mean of v
    over all keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert fab.t5_f32_route(length, head_dim) == route
    args = f32_case(batch, length, heads, head_dim, edge)
    before = t5_attention_core.launches
    got = t5_attention_core(*args)
    torch.cuda.synchronize()
    assert t5_attention_core.launches == before + 1
    want = t5_attention_core_plain(*args)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    v = args[2]
    torch.testing.assert_close(got[batch - 1],
                               v[batch - 1].mean(dim=0).expand(length, -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_cuda_f32_held_launcher_refuses_past_its_limit(head_dim):
    """Called directly, the held launcher takes L = its limit and matches
    the plain version; at one row more it returns cudaErrorInvalidValue and
    writes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launch = fab._launcher(HELD)
    stream = torch.cuda.current_stream().cuda_stream
    for length, rc_want in ((HELD_MAX_LEN[head_dim], 0),
                            (HELD_MAX_LEN[head_dim] + 1, 1)):
        q, k, v, bias, mask, heads = f32_case(2, length, 2, head_dim, 7)
        out = torch.full_like(q, float("nan"))
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), out.data_ptr(), 2, length, heads,
                    head_dim, stream)
        torch.cuda.synchronize()
        assert rc == rc_want
        if rc:
            assert bool(out.isnan().all())
        else:
            torch.testing.assert_close(
                out, t5_attention_core_plain(q, k, v, bias, mask, heads),
                rtol=1e-5, atol=1e-5)
