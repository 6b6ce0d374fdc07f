"""The port's VC-T0 main generate path, mapper and prefix splice against
the JAX package's, on the same weights, on the CPU (small_test LM, fp32)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.ops import prefix_splice as jsplice  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import prefix_splice as tsplice  # noqa: E402

S = 32099
MAPPER = dict(mapping_type="mlp", prefix_size=16, d_model=32,
              prefix_length=4, clip_length=4)


def configs(fused):
    jcfg = jvct0.VCT0Config(
        lm=jt5.T5Config.small_test(fused_encoder_attention=fused),
        mapper=jmap.MapperConfig(**MAPPER))
    tcfg = tvct0.VCT0Config(
        lm=tt5.T5Config.small_test(fused_encoder_attention=fused),
        mapper=tmap.MapperConfig(**MAPPER))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    jcfg, _ = configs(True)
    jp = jvct0.init_vct0_params(jax.random.PRNGKey(0), jcfg,
                                param_dtype=jnp.float32)
    tp = vct0_params_from_numpy(jax.tree.map(np.asarray, jp), torch.float32,
                                "cpu")
    return jp, tp


def few_shot_batch(seed, num_shots=2, batch=3, length=14):
    """Prompts with num_shots + 1 sentinels, right-padded rows."""
    rng = np.random.default_rng(seed)
    num_prefixes = num_shots + 1
    tokens = rng.integers(3, 30000, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    pads = [0, 3, 1][:batch]
    for b in range(batch):
        valid = length - pads[b]
        tokens[b, valid:] = 0
        mask[b, valid:] = 0
        for g, j in enumerate(sorted(rng.choice(valid - 1, num_prefixes,
                                                replace=False))):
            tokens[b, j] = S - g
    prefix = rng.standard_normal((batch, num_prefixes, 16)).astype(np.float32)
    return prefix, tokens, mask


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_generate_matches_jax(params, fused, seed):
    jp, tp = params
    jcfg, tcfg = configs(fused)
    prefix, tokens, mask = few_shot_batch(seed)
    jmodel, tmodel = jvct0.VCT0Model(jcfg, jp), tvct0.VCT0Model(tcfg, tp)
    jtok, jlp = jmodel.generate(jnp.asarray(prefix), jnp.asarray(tokens),
                                jnp.asarray(mask), num_shots=2,
                                max_new_tokens=6)
    ttok, tlp = tmodel.generate(prefix, tokens, mask, num_shots=2,
                                max_new_tokens=6)
    assert ttok.dtype == torch.int32 and tlp.dtype == torch.float32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        tmodel.score_sequences(ttok, tlp).numpy(),
        np.asarray(jmodel.score_sequences(jtok, jlp)), rtol=1e-4, atol=1e-4)


def test_sequence_scores_equal():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 6, (4, 7)).astype(np.int32)
    lps = -rng.random((4, 7)).astype(np.float32)
    want = np.asarray(jvct0._decoding.sequence_scores(jnp.asarray(tokens),
                                                      jnp.asarray(lps)))
    got = tvct0._decoding.sequence_scores(torch.from_numpy(tokens),
                                          torch.from_numpy(lps))
    # equal up to the order of the fp32 sum
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_mapper_matches_jax(params):
    jp, tp = params
    jcfg, tcfg = configs(True)
    x = np.random.default_rng(6).standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(jvct0.project_prefix(jcfg, jp["mapper"], jnp.asarray(x)))
    got = tvct0.project_prefix(tcfg, tp["mapper"], torch.from_numpy(x))
    assert got.shape == (2, 3, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_init_matches_jax_tree_shapes():
    jcfg, tcfg = configs(True)
    jp = jvct0.init_vct0_params(jax.random.PRNGKey(1), jcfg)
    tp = tvct0.init_vct0_params(tcfg, seed=1, device="cpu")
    for name in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            assert tuple(tp["mapper"][name][leaf].shape) == \
                jp["mapper"][name][leaf].shape
            assert tp["mapper"][name][leaf].dtype == torch.float32
    bound = 16 ** -0.5
    assert tp["mapper"]["fc1"]["w"].abs().max() <= bound
    assert tp["lm"]["shared"].shape == jp["lm"]["shared"].shape


@pytest.mark.parametrize("kwargs", [
    dict(num_beams=2), dict(no_prefix=True), dict(prefill_chunks=2),
    dict(pass_examples_through_encoder_one_at_a_time=True),
    dict(decoder_input_ids=np.zeros((3, 2), np.int32)),
    dict(force_eos_at=np.ones((3,), np.int32)),
])
def test_unported_modes_raise(params, kwargs):
    _, tp = params
    _, tcfg = configs(True)
    prefix, tokens, mask = few_shot_batch(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvct0.VCT0Model(tcfg, tp).generate(prefix, tokens, mask, **kwargs)


@pytest.mark.parametrize("mapping_type", ["transformer", "perceiver"])
def test_unported_mappers_raise(mapping_type):
    cfg = tmap.MapperConfig(mapping_type=mapping_type)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmap.mapper_apply(cfg, {}, torch.zeros(1, 768))


# --- the prefix splice, on the cases of tests/test_prefix_splice.py -------

def splice_case(rows, n, P, D=4, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.asarray(rows, dtype=np.int32)
    B, L = tokens.shape
    text = rng.standard_normal((B, L, D)).astype(np.float32)
    prefix = rng.standard_normal((B, P, n, D)).astype(np.float32)
    mask = (tokens != 0).astype(np.int32)
    return tokens, text, prefix, mask, n, P


def random_splice_case(trial):
    rng = np.random.default_rng(1000 + trial)
    P = int(rng.integers(1, 5))
    n = int(rng.integers(1, 6))
    L = int(rng.integers(P + 2, P + 12))
    B = int(rng.integers(1, 4))
    tokens = rng.integers(10, 500, size=(B, L)).astype(np.int32)
    for b in range(B):
        for g, j in enumerate(sorted(rng.choice(L, size=P, replace=False))):
            tokens[b, j] = S - g
    text = rng.standard_normal((B, L, 4)).astype(np.float32)
    prefix = rng.standard_normal((B, P, n, 4)).astype(np.float32)
    mask = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    return tokens, text, prefix, mask, n, P


SPLICE_CASES = {
    "zero_shot": lambda: splice_case([[S, 11, 12, 13, 1]], n=3, P=1),
    "two_shot": lambda: splice_case(
        [[S, 11, 12, S - 1, 13, 14, S - 2, 15, 1],
         [S, 21, 22, S - 1, 23, 24, S - 2, 25, 1]], n=2, P=3),
    "padding_rows_differ": lambda: splice_case(
        [[S, 11, 12, 13, 1, 0, 0], [S, 21, 1, 0, 0, 0, 0]], n=4, P=1),
    "prefix_length_one": lambda: splice_case([[11, S, 12, 1]], n=1, P=1),
    "fewer_sentinels_than_prefixes": lambda: splice_case(
        [[S, 11, 12, 1], [11, 12, 13, 1]], n=2, P=2),
    **{f"random_{t}": (lambda t=t: random_splice_case(t)) for t in range(10)},
}


@pytest.mark.parametrize("case", sorted(SPLICE_CASES))
def test_prefix_splice_matches_jax(case):
    tokens, text, prefix, mask, n, P = SPLICE_CASES[case]()
    want, want_mask = jsplice.insert_prefix_into_input(
        tokens, text, prefix, mask, prefix_length=n, num_prefixes=P)
    got, got_mask = tsplice.insert_prefix_into_input(
        torch.from_numpy(tokens), torch.from_numpy(text),
        torch.from_numpy(prefix), torch.from_numpy(mask),
        prefix_length=n, num_prefixes=P)
    L = tokens.shape[1]
    assert got.shape[1] == tsplice.splice_output_length(L, n, P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
