"""The port's int8 encoder kernels (fused_t5_ln_qkv_q8,
fused_oproj_residual_q8, fused_t5_ffn_q8): the plain versions against the
JAX package's Pallas kernels (interpret mode on the CPU), the wrappers on
CPU tensors, and the CUDA kernels against the plain versions on the card."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.models.t5 import (
    _quant_stacked_i8,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: both sides round after every operation in the same order, so only
# sums taken in another order (the norm's mean, a matmul) differ. bf16:
# within one bf16 ulp of the output. In both, at most 0.1 % of the
# elements may be off by more, by at most one activation code's step
# (code_step): the norm's sum order can move h / hs across a .5 boundary.
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
FLIP_FRACTION = 1e-3

BATCH, SEQ = 2, 8


def quant_stacked(w, groups):
    """One layer through the JAX package's _quant_stacked_i8."""
    jt5 = pytest.importorskip("explicit_alignment_for_vqa_tasks_tpu.models.t5")
    q, s = jt5._quant_stacked_i8(w[None], groups)
    return q[0], s[0]


def quant_legacy(w):
    """Per-output-channel (F,) scales, as quantize_weight_i8 gives them."""
    q, s = quant_stacked(w, 1)
    return q, s[0]


def weights(rng, shape, groups):
    w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    return quant_legacy(w) if groups == "legacy" else quant_stacked(w, groups)


def assert_q8_close(got, want, dtype, step):
    tol = TOL[dtype]
    err = np.abs(got - want)
    bound = tol + tol * np.abs(want)
    off = err > bound
    assert off.mean() <= FLIP_FRACTION, (
        f"{off.sum()} of {off.size} elements beyond {tol}; max err "
        f"{err.max()}")
    assert (err[off] <= bound[off] + step).all(), (err.max(), step)


def case_inputs(op, groups, seed=0):
    """numpy inputs of one op: activations, norm weight, int8 products."""
    rng = np.random.default_rng(seed)
    d_model, d_ff = 256, 512
    x = (rng.standard_normal((BATCH, SEQ, d_model)) * 2).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(d_model)).astype(np.float32)
    if op == "qkv":
        prods = [weights(rng, (d_model, d_model), groups) for _ in range(3)]
        return dict(x=x, lnw=lnw, prods=prods)
    if op == "oproj":
        attn = rng.standard_normal((BATCH, SEQ, d_model)).astype(np.float32)
        return dict(x=x, attn=attn,
                    prods=[weights(rng, (d_model, d_model), groups)])
    prods = [weights(rng, (d_model, d_ff), groups),
             weights(rng, (d_model, d_ff), groups),
             weights(rng, (d_ff, d_model), groups)]
    if op == "ffn_plain":
        prods[1] = (None, None)
    return dict(x=x, lnw=lnw, prods=prods)


def run_jax(op, inp, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    jd = getattr(jnp, dtype)
    flat = [None if a is None else jnp.asarray(a)
            for q, s in inp["prods"] for a in (q, s)]
    x = jnp.asarray(inp["x"], jd)
    if op == "qkv":
        outs = jfab.fused_t5_ln_qkv_q8(x, jnp.asarray(inp["lnw"], jd), *flat,
                                       interpret=True)
    elif op == "oproj":
        outs = (jfab.fused_oproj_residual_q8(
            x, jnp.asarray(inp["attn"], jd), *flat, interpret=True),)
    else:
        outs = (jfab.fused_t5_ffn_q8(x, jnp.asarray(inp["lnw"], jd), *flat,
                                     interpret=True),)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


def run_port(fn_name, op, inp, dtype):
    td = TORCH_DTYPES[dtype]
    fn = getattr(tfab, fn_name)
    flat = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for q, s in inp["prods"] for a in (q, s)]
    x = torch.from_numpy(inp["x"]).to(td)
    if op == "qkv":
        outs = fn(x, torch.from_numpy(inp["lnw"]).to(td), *flat)
    elif op == "oproj":
        outs = (fn(x, torch.from_numpy(inp["attn"]).to(td), *flat),)
    else:
        outs = (fn(x, torch.from_numpy(inp["lnw"]).to(td), *flat),)
    for o in outs:
        assert o.dtype == td and o.shape[:2] == (BATCH, SEQ)
    return [o.float().numpy() for o in outs]


PLAIN = {"qkv": "fused_t5_ln_qkv_q8_plain",
         "oproj": "fused_oproj_residual_q8_plain",
         "ffn_gated": "fused_t5_ffn_q8_plain",
         "ffn_plain": "fused_t5_ffn_q8_plain"}
WRAPPER = {"qkv": "fused_t5_ln_qkv_q8", "oproj": "fused_oproj_residual_q8",
           "ffn_gated": "fused_t5_ffn_q8", "ffn_plain": "fused_t5_ffn_q8"}


def code_step(inp):
    """One activation code's step through the largest weight, hs * 127 *
    max s_w, with hs bounded by the largest |h| over 127: sqrt(D) *
    max|w_ln| after the RMSNorm, the largest input without one."""
    if "lnw" in inp:
        amax = np.sqrt(inp["x"].shape[-1]) * np.abs(inp["lnw"]).max()
    else:
        amax = np.abs(inp["attn"]).max()
    s_max = max(float(np.max(s)) for q, s in inp["prods"] if q is not None)
    return float(amax) * s_max


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(PLAIN))
def test_plain_matches_pallas_kernel(op, dtype, groups):
    inp = case_inputs(op, groups)
    want = run_jax(op, inp, dtype)
    got = run_port(PLAIN[op], op, inp, dtype)
    for g, w in zip(got, want):
        assert_q8_close(g, w, dtype, code_step(inp))


@pytest.mark.parametrize("op", sorted(PLAIN))
def test_plain_takes_legacy_1d_scales(op):
    inp = case_inputs(op, "legacy", seed=1)
    assert inp["prods"][0][1].ndim == 1
    want = run_jax(op, inp, "float32")
    got = run_port(PLAIN[op], op, inp, "float32")
    for g, w in zip(got, want):
        assert_q8_close(g, w, "float32", code_step(inp))


@pytest.mark.parametrize("op", sorted(WRAPPER))
def test_wrapper_takes_plain_version_on_cpu(op):
    inp = case_inputs(op, 2, seed=2)
    fn = getattr(tfab, WRAPPER[op])
    before = fn.launches
    got = run_port(WRAPPER[op], op, inp, "bfloat16")
    want = run_port(PLAIN[op], op, inp, "bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fn.launches == before


def test_row_quant_is_bit_equal_to_jax():
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    rng = np.random.default_rng(3)
    h = (rng.standard_normal((16, 256)) * 3).astype(np.float32)
    h[3] = 0.0                       # the 1e-6 floor
    h[5, :7] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0]   # ties
    jparts = jfab._group_quant_rows_i8(jnp.asarray(h), 2)
    tparts = tfab._group_quant_rows_i8(torch.from_numpy(h), 2)
    for (jq, js), (tq, ts) in zip(jparts, tparts):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_tanh_gelu_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        tfab._tanh_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jfab._tanh_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_grouped_product_is_exact_in_fp32():
    """A group of 1040 codes of +-127 sums to 16,774,160 < 2^24: the fp32
    product must equal the integer product; the plain version keeps it
    exact above that size in float64."""
    for kg in (1040, 1100):
        hq = torch.full((2, kg), 127, dtype=torch.int8)
        w = torch.full((kg, 128), 127, dtype=torch.int8)
        w[0, 0] = 126
        got = tfab._mm_q8_grouped([(hq, torch.ones(2, 1))], w,
                                  torch.ones(1, 128))
        want = float(kg * 127 * 127 - 127)
        assert got.dtype == torch.float32
        assert got[0, 0].item() == np.float32(want)


def test_library_path_is_keyed_by_source_hash():
    path = kernels.library_path("int8_encoder")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("int8_encoder-")
    assert kernels.SOURCES["int8_encoder"] == "int8_encoder.cu"


def test_wrappers_refuse_tiles_the_kernel_cannot_take():
    w = torch.zeros((256, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfab._check_q8_product("op", "w", w, torch.ones(1, 100), 256, 1)
    k_dim = tfab.Q8_GROUP_MULTIPLE * 3
    w = torch.zeros((k_dim, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="-deep k steps"):
        tfab._check_q8_product("op", "w", w, torch.ones(2, 128), k_dim, 2)


# --- on the card: the CUDA kernels against the plain versions --------------

def cuda_case(op, rows, groups, d_model=2048, d_ff=5120, seed=0):
    """T0-3B widths on a few rows, bf16, weights quantized per group."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def quant(k, n):
        w = randn(1, k, n, scale=k ** -0.5)
        q, s = _quant_stacked_i8(w, groups)
        return q[0], s[0]

    x = randn(1, rows, d_model, scale=2.0).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    if op == "qkv":
        return (x, lnw, *quant(d_model, d_model), *quant(d_model, d_model),
                *quant(d_model, d_model))
    if op == "oproj":
        attn = randn(1, rows, d_model).bfloat16()
        return (x, attn, *quant(d_model, d_model))
    gate = quant(d_model, d_ff) if op == "ffn_gated" else (None, None)
    return (x, lnw, *quant(d_model, d_ff), *gate, *quant(d_ff, d_model))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64, 157])
@pytest.mark.parametrize("op", sorted(WRAPPER))
def test_cuda_kernel_matches_plain_version(op, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = cuda_case(op, rows, groups=8)
    fn, plain = getattr(tfab, WRAPPER[op]), getattr(tfab, PLAIN[op])
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        rel = ((g - w).norm() / w.norm()).item()
        assert rel <= 2e-3, rel
        rms = w.square().mean().sqrt()
        assert bool(((g - w).abs() <= 1.6e-2 * w.abs() + 1.6e-2 * rms).all())
    with pytest.raises(ValueError, match="bfloat16"):
        fn(args[0].float(), *args[1:])
