"""The port's bf16 encoder FFN kernel (fused_t5_ffn): the plain version
against the JAX package's Pallas kernel (interpret mode on the CPU), gated
and not, the wrapper on CPU tensors, t5_encode with fused_encoder_ffn
against the JAX package's, and the CUDA kernel against the plain version
on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Both sides round h and hid to bf16 at the same places and sum the fp32
# products in other orders (a few fp32 ulps apart). fp32 outputs: within
# 1e-5 of |x| ~ 2 outputs; bf16 outputs: one bf16 ulp of the output. On
# top of that, a value within NEAR_ULPS fp32 ulps of a bf16 rounding
# boundary can round the other way on the other side: the inputs have no
# such h (asserted; a flipped h would move a whole row), and each hid that
# is near one may move its output row by one bf16 ulp of itself times its
# largest |wo| (row_bounds).
TOLERANCE = {"float32": 1e-5, "bfloat16": 8e-3}
NEAR_ULPS = 16
BATCH, SEQ, D_MODEL, D_FF = 2, 8, 128, 256


def near_bf16_boundary(a: np.ndarray) -> np.ndarray:
    """Where an fp32 value lies within NEAR_ULPS ulps of the midpoint
    between its two neighbouring bf16 values."""
    a = np.ascontiguousarray(a, np.float32)
    bits = a.view(np.uint32) & np.uint32(0xFFFF0000)
    lower = bits.view(np.float32).astype(np.float64)
    upper = (bits + np.uint32(0x10000)).view(np.float32).astype(np.float64)
    return np.abs(a - (lower + upper) / 2) <= NEAR_ULPS * np.spacing(
        np.abs(a))


def row_bounds(x, lnw, wi_0, wi_1, wo, dtype):
    """(rows,) how far each output row may move for its hid values near a
    bf16 rounding boundary (port-side values)."""
    td = TORCH_DTYPES[dtype]
    x32 = torch.from_numpy(x).to(td).float().reshape(BATCH * SEQ, -1)
    h = tfab._rms_norm_f32(x32, torch.from_numpy(lnw).to(td), 1e-6)
    assert not near_bf16_boundary(h.numpy()).any(), \
        "pick inputs with no normed value at a bf16 rounding boundary"
    hb = h.bfloat16().float()
    hid = tfab._tanh_gelu(hb @ torch.from_numpy(wi_0))
    if wi_1 is not None:
        hid = hid * (hb @ torch.from_numpy(wi_1))
    hid = hid.numpy()
    ulp = np.abs(hid) * 2.0 ** -7          # a bf16 ulp is at most this
    wo_max = np.abs(wo).max(axis=1)        # (F,)
    return (near_bf16_boundary(hid) * ulp * wo_max).sum(axis=1)


def make_inputs(gated, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((BATCH, SEQ, D_MODEL)) * 2).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(D_MODEL)).astype(np.float32)

    def w(k, n):   # bf16-valued weights, as the Pallas wrapper casts them
        a = rng.standard_normal((k, n)) * k ** -0.5
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float() \
            .numpy()

    wi_0 = w(D_MODEL, D_FF)
    wi_1 = w(D_MODEL, D_FF) if gated else None
    return x, lnw, wi_0, wi_1, w(D_FF, D_MODEL)


def run_jax(x, lnw, wi_0, wi_1, wo, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    jd = getattr(jnp, dtype)
    out = jfab.fused_t5_ffn(
        jnp.asarray(x, jd), jnp.asarray(lnw, jd), jnp.asarray(wi_0),
        None if wi_1 is None else jnp.asarray(wi_1), jnp.asarray(wo),
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def run_port(fn, x, lnw, wi_0, wi_1, wo, dtype):
    td = TORCH_DTYPES[dtype]
    out = fn(torch.from_numpy(x).to(td), torch.from_numpy(lnw).to(td),
             torch.from_numpy(wi_0),
             None if wi_1 is None else torch.from_numpy(wi_1),
             torch.from_numpy(wo))
    assert out.dtype == td and tuple(out.shape) == x.shape
    return out.float().numpy()


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, gated):
    inputs = make_inputs(gated)
    want = run_jax(*inputs, dtype)
    got = run_port(tfab.fused_t5_ffn_plain, *inputs, dtype)
    tol = TOLERANCE[dtype]
    limit = (tol + tol * np.abs(want)).reshape(BATCH * SEQ, -1) \
        + row_bounds(*inputs, dtype)[:, None]
    err = np.abs(got - want).reshape(limit.shape)
    assert (err <= limit).all(), (err.max(), (err > limit).sum())


def test_plain_rounds_the_norm_to_bf16_for_fp32_inputs():
    """The Pallas kernel rounds h to bf16 whatever x's dtype: an fp32
    output differs from the unrounded FFN by far more than fp32 noise."""
    x, lnw, wi_0, wi_1, wo = make_inputs(True, seed=3)
    xt = torch.from_numpy(x)
    h = tfab._rms_norm_f32(xt, torch.from_numpy(lnw), 1e-6)
    hid = tfab._tanh_gelu(h @ torch.from_numpy(wi_0)) * (
        h @ torch.from_numpy(wi_1))
    unrounded = xt + hid @ torch.from_numpy(wo)
    got = tfab.fused_t5_ffn_plain(xt, torch.from_numpy(lnw),
                                  torch.from_numpy(wi_0),
                                  torch.from_numpy(wi_1),
                                  torch.from_numpy(wo))
    assert (got - unrounded).abs().max().item() > 1e-3


def test_wrapper_takes_plain_version_on_cpu():
    inputs = make_inputs(True, seed=1)
    before = tfab.fused_t5_ffn.launches
    got = run_port(tfab.fused_t5_ffn, *inputs, "bfloat16")
    want = run_port(tfab.fused_t5_ffn_plain, *inputs, "bfloat16")
    np.testing.assert_array_equal(got, want)
    assert tfab.fused_t5_ffn.launches == before


def test_library_path_is_keyed_by_source_hash():
    path = kernels.library_path("t5_ffn")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("t5_ffn-")
    assert kernels.SOURCES["t5_ffn"] == "t5_ffn.cu"


# --- t5_encode with fused_encoder_ffn, against JAX's --------------------------

@pytest.mark.parametrize("gated", [True, False])
def test_encode_with_fused_ffn_matches_jax(gated):
    """The same weights through both encoders with fused_encoder_ffn (and
    the attention kernel), fp32 activations: within 2e-3. The fused FFN
    rounds h and hid to bf16, so a value within fp32 ulps of a bf16
    rounding boundary may round the other way on either side and move
    outputs by up to about 1e-3 (test_plain_matches_pallas_kernel pins the
    arithmetic itself); the unfused FFN, which rounds elsewhere, is more
    than twice that away, and wrong wiring (gate, weights, eps) far more."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5
    from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
        t5_params_from_numpy,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5

    widths = dict(d_model=64, d_ff=128, num_heads=4, d_kv=16,
                  num_encoder_layers=2, num_decoder_layers=1,
                  is_gated_act=gated, fused_encoder_ffn=True,
                  fused_encoder_attention=True)
    jcfg = jt5.T5Config.small_test(**widths)
    tcfg = tt5.T5Config.small_test(**widths)
    jp = jt5.init_t5_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = t5_params_from_numpy(jax.tree.map(np.asarray, jp), torch.float32,
                              "cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(2, 2000, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, -3:] = 0
    want = np.asarray(jt5.t5_encode(jp, jcfg, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask)))
    before = tfab.fused_t5_ffn.launches
    got = tt5.t5_encode(tp, tcfg, input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask))
    assert tfab.fused_t5_ffn.launches == before     # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    # the fused FFN rounds h and hid to bf16: not the plain fp32 encoder
    plain = tt5.t5_encode(tp, dataclasses.replace(tcfg,
                                                  fused_encoder_ffn=False),
                          input_ids=torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask))
    assert (plain - got).abs().max().item() > 4e-3


# --- on the card: the CUDA kernel against the plain version ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("d_model,d_ff", [(2048, 5120), (640, 1664)])
@pytest.mark.parametrize("rows", [64, 157, 300])
@pytest.mark.parametrize("gated", [True, False])
def test_cuda_kernel_matches_plain_version(gated, rows, d_model, d_ff):
    """T0-3B widths (D 2048, F 5120: 256-wide tiles) and widths of 128-wide
    tiles (D 640, F 1664) on a few rows, the last 128-row tile ragged,
    bf16: relative Frobenius error within 2e-3 and every element within
    1.6e-2 of (|want| + rms(want)), as for the int8 kernels (an fp32 sum in
    another order can move a bf16 rounding of h or hid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(1, rows, d_model, scale=2.0).bfloat16()
    lnw = (1 + 0.1 * randn(d_model)).bfloat16()
    wi_0 = randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
    wi_1 = randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16() \
        if gated else None
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    before = tfab.fused_t5_ffn.launches
    got = tfab.fused_t5_ffn(x, lnw, wi_0, wi_1, wo)
    torch.cuda.synchronize()
    assert tfab.fused_t5_ffn.launches == before + 1
    assert not torch.backends.cuda.matmul.allow_tf32
    want = tfab.fused_t5_ffn_plain(x, lnw, wi_0, wi_1, wo).float()
    got = got.float()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2e-3, rel
    rms = want.square().mean().sqrt()
    assert bool(((got - want).abs() <= 1.6e-2 * (want.abs() + rms)).all())
    with pytest.raises(ValueError, match="bfloat16"):
        tfab.fused_t5_ffn(x.half(), lnw, wi_0, wi_1, wo)
