"""The port's int8 encoder kernels (fused_t5_ln_qkv_q8,
fused_oproj_residual_q8, fused_t5_ffn_q8): the plain versions against the
JAX package's Pallas kernels (interpret mode on the CPU), the wrappers on
CPU tensors, and the CUDA kernels against the plain versions on the card."""

from typing import Tuple

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
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import kernel_probe

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: both sides round after every operation in the same order, so only
# sums taken in another order (the norm's mean, a matmul) differ. bf16:
# within one bf16 ulp of the output.
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# An activation code can differ between the two packages only where |h /
# scale| lies near a .5 boundary: the norm's sum order moves h by an fp32
# ulp or two, and the tanh of the FFN's gelu differs by a few ulps between
# XLA and PyTorch, which 1 + tanh magnifies where gelu's input is negative.
# Which sum order each side takes may change from run to run (one tier-1
# run flipped a hidden code at |t| - 0.5 = 1e-5, 170 fp32 ulps away). So
# the ordinary cases move the few inputs whose activations lie within
# MARGIN (absolute, in code units: 1e-3 is more than 100 fp32 ulps of the
# largest code, 127, and far above any of those differences) of a
# boundary (settle_clear_of_boundaries) and then require equal codes; the
# flip bound (row_bounds: each row may move by what its possible flips can
# move it) is held on cases built to sit on a boundary, where a code is
# within NEAR_ULPS fp32 ulps of one.
MARGIN = 1e-3
NUDGE = 1.5e-2        # relative move of an input near a boundary
SCALE_NUDGE = 4e-3    # relative move of a weight column's scale
NEAR_ULPS = 16
GELU_SLOPE = 1.13   # the largest |d gelu_tanh / dx|, about 1.129
EPS = 1e-6

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


def near_boundary(t: np.ndarray) -> np.ndarray:
    """Where |t| lies within NEAR_ULPS fp32 ulps of a .5 boundary: the only
    places where two sums of h a few ulps apart can round to other codes."""
    a = np.abs(t).astype(np.float32)
    return np.abs(a - np.floor(a) - 0.5) <= NEAR_ULPS * np.spacing(a)


def within_margin(t: np.ndarray) -> np.ndarray:
    """Where |t| lies within MARGIN of a .5 boundary."""
    a = np.abs(t).astype(np.float64)
    return np.abs(a - np.floor(a) - 0.5) < MARGIN


def settle_clear_of_boundaries(stage_codes, nudges, max_rounds=64) -> int:
    """Move inputs until no activation of any quantization stage lies
    within MARGIN of a .5 boundary. ``stage_codes()`` gives each stage's
    unrounded codes t = h / scale, (rows, K), from the current inputs;
    ``nudges[i](mask)`` moves the inputs behind the marked elements of
    stage i. Later stages depend on earlier ones, so each round settles the
    first stage that has a near element and starts over. Returns the
    rounds taken."""
    for rounds in range(max_rounds):
        for t, nudge in zip(stage_codes(), nudges):
            near = within_margin(t)
            if near.any():
                nudge(near)
                break
        else:
            return rounds
    raise AssertionError("the inputs did not settle clear of the .5 code "
                         "boundaries")


def nudge_rows(a: np.ndarray, near: np.ndarray) -> None:
    """Scale the marked elements of a (..., K) input in place by 1 + NUDGE."""
    flat = a.reshape(near.shape)
    flat *= np.where(near, np.float32(1 + NUDGE), np.float32(1))


def nudge_columns(scale: np.ndarray, near: np.ndarray) -> None:
    """Scale the output columns of a weight's (G, N) or (N,) scales that
    feed a marked element by 1 + SCALE_NUDGE."""
    cols = near.any(axis=0)
    scale[..., cols] *= np.float32(1 + SCALE_NUDGE)


def assert_q8_close(got, want, dtype, bound):
    """Every element within the fp32 / bf16 tolerance plus its row's
    bound for flipped activation codes (row_bounds)."""
    tol = TOL[dtype]
    err = np.abs(got - want).reshape(bound.shape[0], -1)
    limit = tol + tol * np.abs(want).reshape(err.shape) + bound[:, None]
    assert (err <= limit).all(), (
        f"{(err > limit).sum()} of {err.size} elements beyond the bound; "
        f"max err {err.max()}, rows with a code flip allowed: "
        f"{int((bound > 0).sum())}")


def codes_of(parts, h):
    """(rows, K) unrounded codes h / scale of grouped quantization parts."""
    kg = parts[0][0].shape[-1]
    return np.concatenate([(h[:, g * kg:(g + 1) * kg] / hs).numpy()
                           for g, (_, hs) in enumerate(parts)], axis=1)


def settled_inputs(op, groups, dtype, seed=0):
    """case_inputs moved clear of the .5 code boundaries in ``dtype``: the
    activations (x, or attn for the out-projection) where the first
    quantization is near one, the FFN's gate (or up-product) scales where
    the hidden's is."""
    inp = case_inputs(op, groups, seed)
    for q, s in inp["prods"]:
        if s is not None:
            s.setflags(write=True)

    def stage_codes():
        return [codes_of(parts, h)
                for h, parts in port_stages(op, inp, dtype)[0]]

    first = inp["attn"] if op == "oproj" else inp["x"]
    hidden_scale = inp["prods"][1][1] if op == "ffn_gated" \
        else inp["prods"][0][1]
    settle_clear_of_boundaries(
        stage_codes, [lambda near: nudge_rows(first, near),
                      lambda near: nudge_columns(hidden_scale, near)])
    return inp


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


def port_stages(op, inp, dtype):
    """The port's activation quantizations of one op on the inputs cast to
    ``dtype``: [(h, parts)] for the normed input (or the attention output)
    and, for the FFN, the fp32 hidden, with the gate products a0, a1."""
    td = TORCH_DTYPES[dtype]
    prods = [(None if q is None else torch.from_numpy(q),
              None if s is None else tfab._as_group_scales(torch.from_numpy(s)))
             for q, s in inp["prods"]]
    if op == "oproj":
        h = torch.from_numpy(inp["attn"]).to(td).float().reshape(BATCH * SEQ, -1)
    else:
        x32 = torch.from_numpy(inp["x"]).to(td).float().reshape(BATCH * SEQ, -1)
        h = tfab._rms_norm_f32(x32, torch.from_numpy(inp["lnw"]).to(td), EPS)
    parts = tfab._group_quant_rows_i8(h, prods[0][1].shape[0])
    stages = [(h, parts)]
    extra = {}
    if op.startswith("ffn"):
        (w0, s0), (w1, s1), (wo, so) = prods
        a0 = tfab._mm_q8_grouped(parts, w0, s0)
        a1 = None if w1 is None else tfab._mm_q8_grouped(parts, w1, s1)
        hid = tfab._tanh_gelu(a0) * (1.0 if a1 is None else a1)
        stages.append((hid, tfab._group_quant_rows_i8(hid, so.shape[0])))
        extra = dict(a0=a0, a1=a1, wo=wo, so=so)
    return stages, prods, extra


def near_counts(h, parts):
    """(rows,) count of the positions near a .5 boundary, and the (rows,)
    largest group scale."""
    kg = parts[0][0].shape[-1]
    near = np.zeros(h.shape[0], np.int64)
    hs_max = np.zeros(h.shape[0], np.float32)
    for g, (_, hs) in enumerate(parts):
        t = (h[:, g * kg:(g + 1) * kg] / hs).numpy()
        near += near_boundary(t).sum(axis=1)
        hs_max = np.maximum(hs_max, hs[:, 0].numpy())
    return near, hs_max


def row_bounds(op, inp, dtype):
    """(rows,) how far each output row may move for the activation codes
    that can flip in it. One flipped code of a product moves each output
    of its row by at most hs * 127 * max(s) (a code step through the
    largest weight). For the FFN, a flip in the input codes moves a0 and
    a1 by at most n1 such steps; through gelu and the gate that bounds the
    hidden's change, and the requantized hidden's change (that change plus
    a rounding step of either side's scale) bounds the down product's."""
    stages, prods, extra = port_stages(op, inp, dtype)
    h, parts = stages[0]
    n1, hs1 = near_counts(h, parts)
    s_in = max(float(s.max()) for q, s in prods[:2 if op.startswith("ffn")
                                                else 3] if q is not None)
    step1 = hs1 * 127 * s_in
    if not op.startswith("ffn"):
        return n1 * step1
    hid, hparts = stages[1]
    n2, hs2 = near_counts(hid, hparts)
    so = extra["so"]
    bound = n2 * hs2 * 127 * float(so.max())
    if n1.any():
        da = torch.from_numpy((n1 * step1).astype(np.float32))[:, None]
        if extra["a1"] is None:
            dhid = (GELU_SLOPE * da).expand_as(extra["a0"])
        else:
            dhid = (GELU_SLOPE * da * (extra["a1"].abs() + da)
                    + tfab._tanh_gelu(extra["a0"]).abs() * da)
        hs_now = torch.from_numpy(hs2)[:, None]
        hs_flip = hs_now + dhid.amax(dim=1, keepdim=True) / 127
        f_dim = hid.shape[1]
        w_abs = (extra["wo"].float().abs()
                 * so.repeat_interleave(f_dim // so.shape[0], dim=0))
        dy = (dhid + hs_now + hs_flip) @ w_abs               # (rows, D)
        bound = bound + np.where(n1 > 0, dy.amax(dim=1).numpy(), 0.0)
    return bound


def jax_codes(op, inp, dtype):
    """The JAX package's codes for the port_stages quantizations, from the
    kernels' own expressions and helpers under jit (as the Pallas kernels
    run them)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    jd = getattr(jnp, dtype)
    flat = [(None if q is None else jnp.asarray(q),
             None if s is None else jfab._as_group_scales(jnp.asarray(s)))
            for q, s in inp["prods"]]

    def stages(x, lnw):
        x32 = x.reshape(BATCH * SEQ, -1).astype(jnp.float32)
        if op == "oproj":
            h = x32
        else:
            var = jnp.mean(jnp.square(x32), axis=-1, keepdims=True)
            h = x32 * jax.lax.rsqrt(var + EPS) * lnw.astype(jnp.float32)
        parts = jfab._group_quant_rows_i8(h, flat[0][1].shape[0])
        out = [[q for q, _ in parts]]
        if op.startswith("ffn"):
            (w0, s0), (w1, s1), (_, so) = flat
            hid = jfab._tanh_gelu(jfab._mm_q8_grouped(parts, w0, s0))
            if w1 is not None:
                hid = hid * jfab._mm_q8_grouped(parts, w1, s1)
            out.append([q for q, _ in jfab._group_quant_rows_i8(
                hid, so.shape[0])])
        return out

    x = inp["attn"] if op == "oproj" else inp["x"]
    lnw = inp.get("lnw", np.ones(x.shape[-1], np.float32))
    out = jax.jit(stages)(jnp.asarray(x, jd), jnp.asarray(lnw, jd))
    return [np.concatenate([np.asarray(q) for q in st], axis=1) for st in out]


def assert_codes_equal(op, inp, dtype):
    """The port's codes of every quantization stage equal JAX's."""
    stages, _, _ = port_stages(op, inp, dtype)
    for (h, parts), want in zip(stages, jax_codes(op, inp, dtype)):
        got = np.concatenate([q.numpy() for q, _ in parts], axis=1)
        np.testing.assert_array_equal(got, want)


def assert_codes_differ_only_near_boundaries(op, inp, dtype):
    """The port's codes equal JAX's except where |h / scale| is near a .5
    boundary; the FFN's hidden codes are compared in the rows whose input
    codes agree (a flipped input code moves the whole hidden row)."""
    stages, _, _ = port_stages(op, inp, dtype)
    same_rows = None
    for (h, parts), want in zip(stages, jax_codes(op, inp, dtype)):
        kg = parts[0][0].shape[-1]
        got = np.concatenate([q.numpy() for q, _ in parts], axis=1)
        near = np.concatenate([near_boundary(
            (h[:, g * kg:(g + 1) * kg] / hs).numpy())
            for g, (_, hs) in enumerate(parts)], axis=1)
        differ = got != want
        rows = slice(None) if same_rows is None else same_rows
        assert not (differ & ~near)[rows].any(), (
            f"{int((differ & ~near)[rows].sum())} codes differ away from a "
            ".5 boundary")
        same_rows = ~differ.any(axis=1)


def assert_plain_matches_with_equal_codes(op, inp, dtype):
    """Codes equal to JAX's at every stage, and every output within the
    dtype's tolerance of the Pallas kernel's."""
    want = run_jax(op, inp, dtype)
    got = run_port(PLAIN[op], op, inp, dtype)
    assert_codes_equal(op, inp, dtype)
    rows = want[0].shape[0] * want[0].shape[1]
    for g, w in zip(got, want):
        assert_q8_close(g, w, dtype, np.zeros(rows))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(PLAIN))
def test_plain_matches_pallas_kernel(op, dtype, groups):
    assert_plain_matches_with_equal_codes(
        op, settled_inputs(op, groups, dtype), dtype)


@pytest.mark.parametrize("op", sorted(PLAIN))
def test_plain_takes_legacy_1d_scales(op):
    inp = settled_inputs(op, "legacy", "float32", seed=1)
    assert inp["prods"][0][1].ndim == 1
    assert_plain_matches_with_equal_codes(op, inp, "float32")


def pin_to_boundary(op, inp, row=5, col=7, rounds=4):
    """Move one fp32 input so that its first-stage activation h / scale
    lies on a .5 boundary (within an ulp or two): the scale and, through
    the norm, h itself depend on the input, so a few fixed-point rounds."""
    first = inp["attn"] if op == "oproj" else inp["x"]
    flat = first.reshape(BATCH * SEQ, -1)
    for _ in range(rounds):
        (h, parts), *_ = port_stages(op, inp, "float32")[0]
        t = codes_of(parts, h)[row, col]
        target = np.copysign(np.floor(abs(t)) + 0.5, t)
        flat[row, col] *= np.float32(target / t)


@pytest.mark.parametrize("op", sorted(PLAIN))
def test_plain_stays_within_the_flip_bound_on_a_boundary(op):
    """A case built with one activation on a .5 boundary: the codes may
    differ from JAX's only near a boundary, and each output row stays
    within what its possible flips can move it."""
    inp = case_inputs(op, 2, seed=3)
    pin_to_boundary(op, inp)
    bound = row_bounds(op, inp, "float32")
    assert bound[5] > 0
    want = run_jax(op, inp, "float32")
    got = run_port(PLAIN[op], op, inp, "float32")
    assert_codes_differ_only_near_boundaries(op, inp, "float32")
    for g, w in zip(got, want):
        assert_q8_close(g, w, "float32", bound)


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


def test_row_quant_is_bit_equal_to_jitted_jax():
    """Under jit, as inside the Pallas kernels, XLA turns the scale's
    division by 127 into a product with the fp32 reciprocal: the port's
    scales and codes are bit-equal to that, not only to the eager ops."""
    jax = pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    rng = np.random.default_rng(4)
    h = (rng.standard_normal((4096, 256)) * 3).astype(np.float32)
    jparts = jax.jit(lambda a: jfab._group_quant_rows_i8(a, 2))(h)
    tparts = tfab._group_quant_rows_i8(torch.from_numpy(h), 2)
    for (jq, js), (tq, ts) in zip(jparts, tparts):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


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


# --- the gated FFN's one up-product (csrc/int8_encoder.cu) ------------------

@pytest.mark.parametrize("groups", [1, 8])
def test_gate_interleave_is_a_permutation(groups):
    """The wrapper's K-major (2 F, D) up-weight and (G, 2 F) scales:
    de-interleaving by eight rows gives wi_0^T, wi_1^T and their scales
    back exactly."""
    rng = np.random.default_rng(5)
    d_model, d_ff = 256, 384
    (w0, s0), (w1, s1) = ((torch.from_numpy(q), torch.from_numpy(s))
                          for q, s in (weights(rng, (d_model, d_ff), groups)
                                       for _ in range(2)))
    w_up, s_up = tfab._k_major_gated(w0, s0, w1, s1)
    assert w_up.shape == (2 * d_ff, d_model) and w_up.is_contiguous()
    assert s_up.shape == (groups, 2 * d_ff) and s_up.is_contiguous()
    w_pairs = w_up.reshape(d_ff // 8, 2, 8, d_model)
    s_pairs = s_up.reshape(groups, d_ff // 8, 2, 8)
    for i, (w, sc) in enumerate(((w0, s0), (w1, s1))):
        assert torch.equal(w_pairs[:, i].reshape(d_ff, d_model), w.t())
        assert torch.equal(s_pairs[:, :, i].reshape(groups, d_ff), sc)


def gated_hidden_tilewise(acc: torch.Tensor, tile: int) -> torch.Tensor:
    """The kernel's gated epilogue in plain PyTorch: ``acc`` is the (M, 2 F)
    product over the interleaved weight; in each tile of ``tile`` columns,
    chunk 2c (eight columns, a0) and chunk 2c + 1 (a1) give hidden columns
    n0 / 2 + 8 c .. + 7 as gelu(a0) * a1."""
    hid = torch.empty(acc.shape[0], acc.shape[1] // 2)
    for n0 in range(0, acc.shape[1], tile):
        for c in range(tile // 16):
            a0 = acc[:, n0 + 16 * c:n0 + 16 * c + 8]
            a1 = acc[:, n0 + 16 * c + 8:n0 + 16 * c + 16]
            hid[:, n0 // 2 + 8 * c:n0 // 2 + 8 * c + 8] = \
                tfab._tanh_gelu(a0) * a1
    return hid


@pytest.mark.parametrize("groups,tile", [(1, 256), (2, 128), (8, 128)])
def test_tilewise_gated_product_gives_the_plain_hidden(groups, tile):
    """The interleaved product, taken tile by tile as the kernel takes it
    (128 x 256 tiles for one group, else 128 x 128), gives
    fused_t5_ffn_q8_plain's fp32 hidden bit for bit."""
    inp = case_inputs("ffn_gated", groups, seed=6)
    stages, prods, _ = port_stages("ffn_gated", inp, "float32")
    parts = stages[0][1]
    (w0, s0), (w1, s1), _ = prods
    w_up, s_up = tfab._k_major_gated(w0, s0, w1, s1)
    got = gated_hidden_tilewise(tfab._mm_q8_grouped(parts, w_up.t(), s_up),
                                tile)
    want = tfab._t5_ffn_q8_hidden(parts, w0, s0, w1, s1)
    assert torch.equal(got, want)


# --- q/k/v as one stacked product (csrc/int8_encoder.cu) --------------------

def qkv_tilewise(acc: torch.Tensor, inner: int, tile: int) -> list:
    """The kernel's q | k | v epilogue in plain PyTorch: ``acc`` is the (M,
    3 inner) product over the stacked weight; each tile of ``tile`` columns
    goes, cast to bf16, to the one of q, k, v its first column falls in, at
    column n0 - part * inner."""
    outs = [torch.empty(acc.shape[0], inner, dtype=torch.bfloat16)
            for _ in range(3)]
    for n0 in range(0, acc.shape[1], tile):
        part = n0 // inner
        c0 = n0 - part * inner
        outs[part][:, c0:c0 + tile] = acc[:, n0:n0 + tile].bfloat16()
    return outs


@pytest.mark.parametrize("groups,tile", [(1, 256), (2, 128), (8, 128)])
def test_tilewise_stacked_qkv_gives_the_plain_projections(groups, tile):
    """The wrapper's K-major (3 inner, D) q | k | v weight and (G, 3 inner)
    scales, the product taken tile by tile as the kernel's epilogue routes
    it (128 x 256 tiles for one group, else 128 x 128), give
    fused_t5_ln_qkv_q8_plain's q, k and v bit for bit."""
    inp = case_inputs("qkv", groups, seed=7)
    stages, prods, _ = port_stages("qkv", inp, "bfloat16")
    w_qkv, s_qkv = tfab._k_major_stacked([w for w, _ in prods],
                                         [s for _, s in prods])
    inner, d_model = prods[0][0].shape[1], prods[0][0].shape[0]
    assert w_qkv.shape == (3 * inner, d_model) and w_qkv.is_contiguous()
    assert s_qkv.shape == (groups, 3 * inner) and s_qkv.is_contiguous()
    assert inner % tile == 0
    got = qkv_tilewise(tfab._mm_q8_grouped(stages[0][1], w_qkv.t(), s_qkv),
                       inner, tile)
    x = torch.from_numpy(inp["x"]).bfloat16()
    want = tfab.fused_t5_ln_qkv_q8_plain(
        x, torch.from_numpy(inp["lnw"]).bfloat16(),
        *(t for prod in prods for t in prod), EPS)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)


@pytest.mark.parametrize("op", ["qkv", "ffn_gated"])
def test_codes_out_holds_the_plain_quantizations(op):
    """codes_out, through the wrapper on CPU tensors: the activation codes
    and (row, group) scales of each quantization stage, joined over the
    groups as the kernel's scratch holds them."""
    inp = case_inputs(op, 2, seed=8)
    stages, _, _ = port_stages(op, inp, "bfloat16")
    codes_out = {}
    flat = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for q, s in inp["prods"] for a in (q, s)]
    x = torch.from_numpy(inp["x"]).bfloat16()
    getattr(tfab, WRAPPER[op])(x, torch.from_numpy(inp["lnw"]).bfloat16(),
                               *flat, EPS, codes_out=codes_out)
    prefixes = ["", "hidden_"][:len(stages)]
    assert sorted(codes_out) == sorted(p + k for p in prefixes
                                       for k in ("codes", "scales"))
    for prefix, (h, parts) in zip(prefixes, stages):
        codes, scales = codes_out[prefix + "codes"], codes_out[prefix + "scales"]
        assert codes.dtype == torch.int8 and codes.shape == h.shape
        assert scales.shape == (h.shape[0], len(parts))
        for g, (q, hs) in enumerate(parts):
            kg = q.shape[1]
            assert torch.equal(codes[:, g * kg:(g + 1) * kg], q)
            assert torch.equal(scales[:, g:g + 1], hs)


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
    # fp32 x takes the fp32 form (test_cuda_f32_forms_equal_plain); other
    # dtypes are refused
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fn(args[0].half(), *args[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("width", kernel_probe.Q8_WIDTHS)
@pytest.mark.parametrize("groups,depth", kernel_probe.Q8_GROUPS)
@pytest.mark.parametrize("rows", kernel_probe.Q8_ROWS)
def test_cuda_oproj_sweep(rows, groups, depth, width, record_property):
    """fused_oproj_residual_q8 on every shape class of
    csrc/q8_gemm_tma.cuh's loop (kernel_probe --q8-variants' sweep: rows
    below one tile, a ragged tile and the main path's; 1, 2 and 8 groups of
    64, 128 and 256 bytes; widths of one and two 128-column tiles and
    more): within compare_q8's rule of the plain version, one launch
    counted. The group depths are at most 1040, where the plain version's
    fp32 sums of int8 products are exact: the count of outputs that differ
    from plain is recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = kernel_probe.oproj_case(rows, groups, depth, width)
    fn = tfab.fused_oproj_residual_q8
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = tfab.fused_oproj_residual_q8_plain(*args)
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    assert ((g - w).norm() / w.norm()).item() <= 2e-3
    rms = w.square().mean().sqrt()
    assert bool(((g - w).abs() <= 1.6e-2 * w.abs() + 1.6e-2 * rms).all())
    record_property("differing", int((got != want).sum()))


def exact_norm_rows(gen, rows: int, width: int) -> Tuple[torch.Tensor, float]:
    """(rows, width) fp32 rows on the card, each a random permutation of one
    set of values, multiples of 1/8 below 2, half of them the negated other
    half: every row's sum is exactly 0 and its mean square is exact in any
    order of summation and the same in every row. Returns the rows and the
    norm's eps that brings the mean square to exactly 4 (whose square root
    and reciprocal square root are exact), so that a norm computed in any
    order is bit-equal on either side."""
    half = torch.randint(-15, 16, (width // 2,), generator=gen,
                         device="cuda").float() / 8
    values = torch.cat([half, -half])
    order = torch.argsort(torch.rand((rows, width), generator=gen,
                                     device="cuda"), dim=1)
    mean_square = float(values.square().sum()) / width
    return values[order], 4.0 - mean_square


def exact_ffn_case(rows: int, gated: bool, g_in: int, g_hid: int,
                   d_model: int = 2048, d_ff: int = 5120, seed: int = 0):
    """T0-3B widths on a few rows of exact_norm_rows, bf16, weights from the
    port's quantizer: (the FFN's arguments, eps)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def quant(k, n, groups):
        w = torch.randn((1, k, n), generator=gen, device="cuda") * k ** -0.5
        q, s = _quant_stacked_i8(w, groups)
        return q[0], s[0]

    x, eps = exact_norm_rows(gen, rows, d_model)
    lnw = (1 + 0.1 * torch.randn(d_model, generator=gen, device="cuda")
           ).bfloat16()
    gate = quant(d_model, d_ff, g_in) if gated else (None, None)
    return (x[None].bfloat16(), lnw, *quant(d_model, d_ff, g_in), *gate,
            *quant(d_ff, d_model, g_hid)), eps


@pytest.mark.gpu
@pytest.mark.parametrize("g_in,g_hid", [(8, 8), (8, 80), (1, 1)])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_ffn_q8_equals_plain(rows, gated, g_in, g_hid):
    """fused_t5_ffn_q8 bit-equal to its plain version (rtol = atol = 0) on
    inputs whose RMSNorm is exact in any order (exact_norm_rows): a ragged
    row tile, the gate interleaved into one up-product or gelu alone, 8
    input groups (128-column tiles) or 1 (256-column tiles), the hidden
    requantized in 8 groups of 640 columns or 80 of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, eps = exact_ffn_case(rows, gated, g_in, g_hid)
    before = tfab.fused_t5_ffn_q8.launches
    got = tfab.fused_t5_ffn_q8(*args, eps=eps)
    torch.cuda.synchronize()
    assert tfab.fused_t5_ffn_q8.launches == before + 1
    want = tfab.fused_t5_ffn_q8_plain(*args, eps=eps)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def exact_qkv_case(rows: int, d_model: int, inner: int, groups: int,
                   seed: int = 0):
    """fused_t5_ln_qkv_q8's arguments on rows of exact_norm_rows, bf16,
    weights from the port's quantizer: (the arguments, eps)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def quant():
        w = torch.randn((1, d_model, inner), generator=gen,
                        device="cuda") * d_model ** -0.5
        q, s = _quant_stacked_i8(w, groups)
        return q[0], s[0]

    x, eps = exact_norm_rows(gen, rows, d_model)
    lnw = (1 + 0.1 * torch.randn(d_model, generator=gen, device="cuda")
           ).bfloat16()
    return (x[None].bfloat16(), lnw, *quant(), *quant(), *quant()), eps


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,inner,groups", [
    (2048, 2048, 8), (2048, 2048, 1), (512, 512, 8), (1024, 640, 1)])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_qkv_q8_equals_plain(rows, d_model, inner, groups):
    """fused_t5_ln_qkv_q8 bit-equal to its plain version (rtol = atol = 0)
    on inputs whose RMSNorm is exact in any order (exact_norm_rows): a
    ragged row tile; T0-3B's 8 groups of 256 (128 x 128 tiles, two int32
    sets), one group (128 x 256 tiles), groups of 64 bytes (64-byte k
    steps), and one group over an inner width of 640 (128 x 128 tiles, one
    set), each column tile routed into q, k or v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, eps = exact_qkv_case(rows, d_model, inner, groups)
    fn = tfab.fused_t5_ln_qkv_q8
    before = fn.launches
    got = fn(*args, eps=eps)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = tfab.fused_t5_ln_qkv_q8_plain(*args, eps=eps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ln_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("op", ["qkv", "ffn_gated", "ffn_plain"])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_f32_forms_equal_plain(rows, op, ln_dtype):
    """The fp32 forms of fused_t5_ln_qkv_q8 and fused_t5_ffn_q8 (fp32 x,
    the norm's scale bf16 (widened by the wrapper) or fp32) bit-equal to
    their plain versions on exact_norm_rows at T0-3B widths and 8 groups:
    fp32 outputs, unrounded, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if op == "qkv":
        args, eps = exact_qkv_case(rows, 2048, 2048, 8)
    else:
        args, eps = exact_ffn_case(rows, op == "ffn_gated", 8, 8)
    lnw = args[1].float()
    if ln_dtype == "float32":  # a scale no bf16 holds
        lnw = lnw + 1e-3 * torch.rand(lnw.shape, device="cuda")
    args = (args[0].float(), lnw, *args[2:])
    fn, plain = getattr(tfab, WRAPPER[op]), getattr(tfab, PLAIN[op])
    before = fn.launches
    got = fn(*args, eps=eps)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, eps=eps)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_dtype,res_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_oproj_f32_forms_match_plain(rows, attn_dtype, res_dtype,
                                          record_property):
    """fused_oproj_residual_q8 with attn and residual each bf16 or fp32,
    the output in the residual's dtype as JAX writes it: bit-equal to the
    plain version (no norm in front, so no code sits on a boundary the two
    could round apart; the int8 products' sums are exact and the fp32
    epilogue is the same operations in the same order), one launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, wo, so = cuda_case("oproj", rows, groups=8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    residual, attn = (torch.randn((1, rows, 2048), generator=gen,
                                  device="cuda").to(TORCH_DTYPES[dt])
                      for dt in (res_dtype, attn_dtype))
    fn = tfab.fused_oproj_residual_q8
    before = fn.launches
    got = fn(residual, attn, wo, so)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = tfab.fused_oproj_residual_q8_plain(residual, attn, wo, so)
    assert got.dtype == want.dtype == residual.dtype
    assert bool(torch.isfinite(got).all())
    record_property("differing", int((got != want).sum()))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- the T5 weight quantizer ------------------------------------------------

def test_quant_stacked_i8_is_bit_equal_to_jax():
    """Random columns in 2 groups, an all-zero column (the 1e-8 floor) and
    columns of exact ties (scale 127 / 127 = 1, values k + 0.5), against
    the JAX package's numpy quantizer."""
    w = np.random.default_rng(0).standard_normal((2, 64, 48)).astype(
        np.float32) * 0.1
    w[:, :, 3] = 0.0
    w[0, :, 5] = 0.0
    w[0, :8, 5] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    w[1, 32:40, 6] = [-127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    jt5 = pytest.importorskip("explicit_alignment_for_vqa_tasks_tpu.models.t5")
    want_q, want_s = jt5._quant_stacked_i8(w, 2)
    got_q, got_s = _quant_stacked_i8(torch.from_numpy(w), 2)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s[0, 0, 3].item() == np.float32(1e-8) / np.float32(127.0)
    assert got_q[0, :8, 5].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    assert got_q[1, 32:40, 6].tolist() == [-127, 0, 2, 2, 0, -2, 126, -4]


@pytest.mark.gpu
def test_t5_quantizers_on_the_card_equal_the_cpu():
    """quantize_encoder_ffn / _attn and quantize_decoder_step give the same
    int8 codes and fp32 scales on the card as on the CPU, bit for bit (the
    scales divide by a tensor: a CUDA division by a Python scalar is a
    product with its reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5

    cfg = tt5.T5Config.small_test(d_model=256, d_kv=32, num_heads=8,
                                  d_ff=512, num_encoder_layers=2,
                                  num_decoder_layers=2)
    params = tt5.init_t5_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, torch.bfloat16)

    def cpu_copy(tree):
        return {k: cpu_copy(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    def flat(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from flat(val, f"{prefix}{key}/")
            else:
                yield prefix + key, val

    for quantize in (tt5.quantize_encoder_ffn, tt5.quantize_encoder_attn,
                     tt5.quantize_decoder_step):
        gpu = dict(flat(quantize(params)))
        cpu = dict(flat(quantize(cpu_copy(params))))
        assert gpu.keys() == cpu.keys()
        for key, val in gpu.items():
            assert torch.equal(val.cpu(), cpu[key]), (quantize.__name__, key)
