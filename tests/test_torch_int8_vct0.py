"""The port's int8 VC-T0 path (models/vct0.py build-time quantization,
SmoothQuant calibration and int8 generate; convert.py's int8 leaves)
against the JAX package's, on the same weights, on the CPU (fp32, small
widths)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    t5_params_from_numpy,
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402

WIDTHS = dict(d_model=64, d_ff=128, num_heads=4, d_kv=16,
              num_encoder_layers=4, num_decoder_layers=2)


def jcfg(**kw):
    return jt5.T5Config.small_test(**WIDTHS, **kw)


def tcfg(**kw):
    return tt5.T5Config.small_test(**WIDTHS, **kw)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_q8_trees_equal(got: dict, want: dict):
    """Codes and scales bit-equal (the smoothed norms are not compared)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name == "ln":
            continue
        w = np.asarray(w)
        assert got[name].dtype == (torch.int8 if w.dtype == np.int8 else
                                   torch.float32), name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


S = 32099
MAPPER = dict(mapping_type="mlp", prefix_size=16, d_model=64,
              prefix_length=4, clip_length=4)
INT8 = dict(fused_encoder_attention=True, int8_encoder_ffn=True,
            int8_encoder_attn=True)


def vct0_configs(**flags):
    return (jvct0.VCT0Config(lm=jcfg(**flags),
                             mapper=jmap.MapperConfig(**MAPPER)),
            tvct0.VCT0Config(lm=tcfg(**flags),
                             mapper=tmap.MapperConfig(**MAPPER)))


def few_shot_batch(seed, num_shots=2, batch=3, length=14):
    rng = np.random.default_rng(seed)
    num_prefixes = num_shots + 1
    tokens = rng.integers(3, 30000, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    for b, pad in enumerate([0, 3, 1][:batch]):
        valid = length - pad
        tokens[b, valid:] = 0
        mask[b, valid:] = 0
        for g, j in enumerate(sorted(rng.choice(valid - 1, num_prefixes,
                                                replace=False))):
            tokens[b, j] = S - g
    prefix = rng.standard_normal((batch, num_prefixes, 16)).astype(np.float32)
    return prefix, tokens, mask


@pytest.fixture(scope="module")
def vct0_params():
    jc, _ = vct0_configs(**INT8)
    return jvct0.init_vct0_params(jax.random.PRNGKey(0), jc,
                                  param_dtype=jnp.float32)


def test_int8_generate_matches_jax(vct0_params):
    """Build-time quantization (the JAX factory's path) of the same LM;
    the JAX tree carried across: equal tokens, log-probs within 1e-4."""
    jc, tc = vct0_configs(**INT8)
    jp = dict(vct0_params)
    jp["lm"] = jt5.quantize_encoder_attn(jt5.quantize_encoder_ffn(jp["lm"]))
    tp = vct0_params_from_numpy(to_numpy(jp), torch.float32, "cpu")
    # a batch with no activation at a code boundary (see
    # tests/test_torch_int8_encoder.py::test_int8_encode_matches_jax)
    prefix, tokens, mask = few_shot_batch(1)
    jtok, jlp = jvct0.VCT0Model(jc, jp).generate(
        jnp.asarray(prefix), jnp.asarray(tokens), jnp.asarray(mask),
        num_shots=2, max_new_tokens=6)
    ttok, tlp = tvct0.VCT0Model(tc, tp).generate(
        prefix, tokens, mask, num_shots=2, max_new_tokens=6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-4)


def test_build_time_quantization_matches_jax_factory(vct0_params):
    _, tc = vct0_configs(**INT8)
    tp = vct0_params_from_numpy(to_numpy(vct0_params), torch.float32, "cpu")
    got = tvct0.quantize_int8_encoder(tp["lm"], tc.lm)
    want = jt5.quantize_encoder_attn(jt5.quantize_encoder_ffn(
        vct0_params["lm"]))
    for key in ("ffn_q8", "self_attn_q8"):
        assert_q8_trees_equal(got["encoder"][key], want["encoder"][key])
    assert "ffn_q8" not in tp["lm"]["encoder"]
    only_ffn = dataclasses.replace(tc.lm, int8_encoder_attn=False)
    assert "self_attn_q8" not in tvct0.quantize_int8_encoder(
        tp["lm"], only_ffn)["encoder"]


def test_calibrate_and_quantize_matches_jax(vct0_params):
    jc, tc = vct0_configs(**INT8)
    tp = vct0_params_from_numpy(to_numpy(vct0_params), torch.float32, "cpu")
    batches = [dict(zip(("prefix", "question_tokens", "question_mask"),
                        few_shot_batch(0)))]
    batches.append(dict(question_tokens=batches[0]["question_tokens"],
                        question_mask=batches[0]["question_mask"],
                        no_prefix=True))
    jmodel = jvct0.VCT0Model(jc, dict(vct0_params))
    want = jmodel.calibrate_and_quantize_int8(
        [{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in b.items()} for b in batches])
    tmodel = tvct0.VCT0Model(tc, tp)
    got = tmodel.calibrate_and_quantize_int8(batches)
    for k in ("attn", "ffn"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5)
    for key in ("ffn_q8", "self_attn_q8"):
        np.testing.assert_allclose(
            tmodel.params["lm"]["encoder"][key]["ln"].numpy(),
            np.asarray(jmodel.params["lm"]["encoder"][key]["ln"]), rtol=1e-5)
    # the calibrated model generates
    prefix, tokens, mask = few_shot_batch(2)
    tok, lp = tmodel.generate(prefix, tokens, mask, num_shots=2,
                              max_new_tokens=4)
    assert tok.shape == (3, 4) and bool(torch.isfinite(lp).all())


def test_calibrate_needs_an_int8_mode_and_refuses_unported(vct0_params):
    tp = vct0_params_from_numpy(to_numpy(vct0_params), torch.float32, "cpu")
    _, plain = vct0_configs(fused_encoder_attention=True)
    with pytest.raises(ValueError, match="int8 encoder mode"):
        tvct0.VCT0Model(plain, tp).calibrate_and_quantize_int8([])
    # every int8 mode is ported now: with the decode step too, what is
    # refused is a calibration without a batch, as JAX refuses it
    _, step = vct0_configs(int8_decoder_step=True, **INT8)
    with pytest.raises(ValueError, match=">= 1 batch"):
        tvct0.VCT0Model(step, tp).calibrate_and_quantize_int8([])


# --- convert.py --------------------------------------------------------------

def test_convert_keeps_int8_codes_and_fp32_scales():
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg(), jnp.float32)
    jq = jt5.quantize_encoder_attn(jt5.quantize_encoder_ffn(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
        act_max=np.full((4, 64), 2.0, np.float32)))
    tq = t5_params_from_numpy(to_numpy(jq), torch.bfloat16, "cpu")
    for key in ("ffn_q8", "self_attn_q8"):
        for name, want in jq["encoder"][key].items():
            want = np.asarray(want)
            got = tq["encoder"][key][name]
            if name.endswith("_s"):
                assert want.dtype == np.float32
                assert got.dtype == torch.float32, name
            elif want.dtype == np.int8:
                assert got.dtype == torch.int8, name
            else:   # the smoothed norm keeps the LM dtype
                assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    assert tq["encoder"]["ffn"]["wi_0"].dtype == torch.bfloat16
