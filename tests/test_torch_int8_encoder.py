"""The port's int8 bulk-eval encoder (models/t5.py quantizers, calibration
and int8 t5_encode branches) against the JAX package's, on the same
weights, on the CPU (fp32, small widths)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    t5_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402

WIDTHS = dict(d_model=64, d_ff=128, num_heads=4, d_kv=16,
              num_encoder_layers=4, num_decoder_layers=2)


def jcfg(**kw):
    return jt5.T5Config.small_test(**WIDTHS, **kw)


def tcfg(**kw):
    return tt5.T5Config.small_test(**WIDTHS, **kw)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg(), jnp.float32)
    return jp, t5_params_from_numpy(to_numpy(jp), torch.float32, "cpu")


def ragged_batch(seed=1, batch=2, length=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 2000, (batch, length)).astype(np.int32)
    mask = (ids % 7 != 0).astype(np.int32)     # ragged, as the JAX tests
    mask[1, -5:] = 0
    return ids, mask


# --- quantizers -------------------------------------------------------------

@pytest.mark.parametrize("k_dim,requested", [
    (2048, "auto"), (5120, "auto"), (2816, "auto"), (64, "auto"),
    (128, "auto"), (64, 4), (256, 2),
])
def test_pick_groups_matches_jax(k_dim, requested):
    assert tt5._pick_groups(k_dim, requested) == jt5._pick_groups(
        k_dim, requested)


@pytest.mark.parametrize("requested", [5, 0])
def test_pick_groups_refuses_what_jax_refuses(requested):
    with pytest.raises(ValueError, match="must divide"):
        jt5._pick_groups(64, requested)
    with pytest.raises(ValueError, match="must divide"):
        tt5._pick_groups(64, requested)


def assert_q8_trees_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        if name == "ln":
            continue
        assert g.dtype == (torch.int8 if w.dtype == np.int8 else
                           torch.float32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("groups", ["auto", 2])
@pytest.mark.parametrize("which", ["ffn", "attn"])
def test_quantized_codes_and_scales_bit_equal_to_jax(params, which, groups):
    jp, tp = params
    key = "ffn_q8" if which == "ffn" else "self_attn_q8"
    jq = getattr(jt5, f"quantize_encoder_{which}")(jp, groups=groups)
    tq = getattr(tt5, f"quantize_encoder_{which}")(tp, groups=groups)
    assert_q8_trees_equal(tq["encoder"][key], jq["encoder"][key])
    # a new dict: the input params keep no q8 subtree
    assert key not in tp["encoder"]
    assert tq["encoder"]["ffn"] is tp["encoder"]["ffn"]


def test_quantized_bf16_weights_bit_equal_to_jax():
    jp = jt5.init_t5_params(jax.random.PRNGKey(3), jcfg(), jnp.bfloat16)
    tp = t5_params_from_numpy(to_numpy(jp), torch.bfloat16, "cpu")
    for which, key in (("ffn", "ffn_q8"), ("attn", "self_attn_q8")):
        jq = getattr(jt5, f"quantize_encoder_{which}")(jp)
        tq = getattr(tt5, f"quantize_encoder_{which}")(tp)
        assert_q8_trees_equal(tq["encoder"][key], jq["encoder"][key])


def test_smooth_factors_match_jax():
    rng = np.random.default_rng(0)
    w = [rng.normal(size=(2, 16, 24)).astype(np.float32) for _ in range(2)]
    act = rng.uniform(0.01, 30.0, size=(2, 16)).astype(np.float32)
    act[0, 3] = 0.0                 # the 1e-8 floor
    for alpha in (0.5, 0.8):
        want = jt5._smooth_factors(act, w, alpha)
        got = tt5._smooth_factors(torch.from_numpy(act),
                                  [torch.from_numpy(a) for a in w], alpha)
        # pow may differ from numpy's by an ulp
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("which", ["ffn", "attn"])
def test_smoothquant_fold_matches_jax(params, which):
    """With the same act_max: the smoothed norm within rtol 1e-6, and the
    codes equal wherever the smoothing factors agreed to the bit (at most
    one code step elsewhere)."""
    jp, tp = params
    rng = np.random.default_rng(4)
    act = rng.uniform(0.1, 8.0, size=(4, 64)).astype(np.float32)
    key = "ffn_q8" if which == "ffn" else "self_attn_q8"
    jq = getattr(jt5, f"quantize_encoder_{which}")(
        jp, act_max=act)["encoder"][key]
    tq = getattr(tt5, f"quantize_encoder_{which}")(
        tp, act_max=torch.from_numpy(act))["encoder"][key]
    np.testing.assert_allclose(tq["ln"].numpy(), np.asarray(jq["ln"]),
                               rtol=1e-6)
    for name in jq:
        if name == "ln":
            continue
        got, want = tq[name].numpy(), np.asarray(jq[name])
        if want.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


# --- calibration -------------------------------------------------------------

def test_calibrate_act_max_matches_jax(params):
    """Token ids and embeddings, ragged masks, the running max over two
    batches: within rtol 1e-5."""
    jp, tp = params
    ids, mask = ragged_batch()
    embeds = np.random.default_rng(2).standard_normal((2, 24, 64)).astype(
        np.float32)
    want = jt5.calibrate_encoder_act_max(
        jp, jcfg(), [(jnp.asarray(ids), jnp.asarray(mask)),
                     (jnp.asarray(embeds), jnp.asarray(mask[::-1]))])
    got = tt5.calibrate_encoder_act_max(
        tp, tcfg(int8_encoder_ffn=True),
        [(torch.from_numpy(ids), torch.from_numpy(mask)),
         (torch.from_numpy(embeds), torch.from_numpy(mask[::-1].copy()))])
    for k in ("attn", "ffn"):
        assert tuple(got[k].shape) == (4, 64) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5)
    t = (torch.from_numpy(ids), torch.from_numpy(mask))
    first = tt5.calibrate_encoder_act_max(tp, tcfg(), [t])
    alone = tt5.calibrate_encoder_act_max(
        tp, tcfg(), [(torch.from_numpy(ids[:1]), None)])
    both = tt5.calibrate_encoder_act_max(
        tp, tcfg(), [t, (torch.from_numpy(ids[:1]), None)])
    for k in both:
        torch.testing.assert_close(both[k], torch.maximum(first[k], alone[k]))


def test_calibration_ignores_masked_positions(params):
    _, tp = params
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[:, 8:] = 0
    spiked = embeds.copy()
    spiked[:, 8:] *= 1e3
    base, got = (tt5.calibrate_encoder_act_max(
        tp, tcfg(), [(torch.from_numpy(e), torch.from_numpy(mask))])
        for e in (embeds, spiked))
    for k in base:
        np.testing.assert_allclose(got[k].numpy(), base[k].numpy(),
                                   rtol=1e-5)


def test_calibration_needs_a_batch(params):
    _, tp = params
    with pytest.raises(ValueError, match=">= 1 batch"):
        tt5.calibrate_encoder_act_max(tp, tcfg(), [])


# --- the int8 encoder ----------------------------------------------------------

ENCODE_MODES = {
    "ffn": dict(int8_encoder_ffn=True),
    "ffn_fused_attention": dict(int8_encoder_ffn=True,
                                fused_encoder_attention=True),
    "ffn_and_attn": dict(int8_encoder_ffn=True, int8_encoder_attn=True,
                         fused_encoder_attention=True),
}


@pytest.mark.parametrize("mode", sorted(ENCODE_MODES))
def test_int8_encode_matches_jax(params, mode):
    """The JAX-quantized tree, carried across by convert.py, through both
    encoders: within 1e-5. The two sides sum the norm's mean of squares in
    other orders, so where an activation lands within an ulp of a .5 code
    boundary its code can differ and move a whole row (some random batches
    have such an activation); the batch here has none, and
    tests/test_torch_int8_kernels.py bounds what a flip does."""
    jp, _ = params
    flags = ENCODE_MODES[mode]
    jq = jt5.quantize_encoder_ffn(jp, groups=2)
    if flags.get("int8_encoder_attn"):
        jq = jt5.quantize_encoder_attn(jq)
    tq = t5_params_from_numpy(to_numpy(jq), torch.float32, "cpu")
    ids, mask = ragged_batch(seed=4)
    want = np.asarray(jt5.t5_encode(jq, jcfg(**flags), input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask)))
    got = tt5.t5_encode(tq, tcfg(**flags), input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_smoothed_int8_encode_matches_jax(params):
    """SmoothQuant-folded trees (ffn_q8["ln"], self_attn_q8["ln"]) take the
    norm override on both sides (a batch with no activation at a code
    boundary, as above)."""
    jp, _ = params
    ids, mask = ragged_batch(seed=3)
    stats = jt5.calibrate_encoder_act_max(
        jp, jcfg(), [(jnp.asarray(ids), jnp.asarray(mask))])
    jq = jt5.quantize_encoder_attn(
        jt5.quantize_encoder_ffn(jp, act_max=stats["ffn"]),
        act_max=stats["attn"])
    tq = t5_params_from_numpy(to_numpy(jq), torch.float32, "cpu")
    flags = ENCODE_MODES["ffn_and_attn"]
    want = np.asarray(jt5.t5_encode(jq, jcfg(**flags), input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask)))
    got = tt5.t5_encode(tq, tcfg(**flags), input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flags,match", [
    (dict(int8_encoder_ffn=True), "quantize_encoder_ffn"),
    (dict(int8_encoder_attn=True, fused_encoder_attention=True),
     "quantize_encoder_attn"),
    (dict(int8_encoder_attn=True), "fused_encoder_attention"),
])
def test_int8_modes_raise_as_jax_does(params, flags, match):
    jp, tp = params
    ids = np.zeros((1, 8), np.int32)
    if "quantize" not in match:  # quantized, but the flag combination is bad
        jp = jt5.quantize_encoder_attn(jp)
        tp = tt5.quantize_encoder_attn(tp)
    with pytest.raises(ValueError, match=match):
        jt5.t5_encode(jp, jcfg(**flags), input_ids=jnp.asarray(ids))
    with pytest.raises(ValueError, match=match):
        tt5.t5_encode(tp, tcfg(**flags), input_ids=torch.from_numpy(ids))
