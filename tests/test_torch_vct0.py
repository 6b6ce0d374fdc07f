"""The port's VC-T0 generate modes, mapper and prefix splice against the
JAX package's, on the same weights, on the CPU (small_test LM, fp32):
the main path, and each other mode (beam search, no_prefix, one-at-a-time,
a forced decoder prefix, prefix-only, chunked prefill, force_eos_at) with
equal tokens and log-probs within 1e-4; the mode combinations JAX refuses
refused alike; the pipelined paths raising with their ROADMAP item."""

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
    pads = [0, 3, 1, 2][:batch]
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


def one_at_a_time_batch(seed, segments=3, batch=3, length=9):
    """(B, S, L) prompts, segment i with its sentinel <extra_id_i>, some
    rows right-padded, and (B, S, 16) prefixes."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 30000, (batch, segments, length)).astype(
        np.int32)
    mask = np.ones((batch, segments, length), np.int32)
    for b in range(batch):
        for i in range(segments):
            valid = length - (b + i) % 3
            tokens[b, i, valid:] = 0
            mask[b, i, valid:] = 0
            tokens[b, i, rng.integers(valid - 1)] = S - i
    prefix = rng.standard_normal((batch, segments, 16)).astype(np.float32)
    return prefix, tokens, mask


def mode_inputs(mode, seed=0):
    """generate's keyword arguments for one mode (numpy arrays)."""
    if mode.startswith("one_at_a_time"):
        prefix, tokens, mask = one_at_a_time_batch(seed)
        kwargs = dict(pass_examples_through_encoder_one_at_a_time=True)
    else:
        prefix, tokens, mask = few_shot_batch(
            seed, batch=4 if mode == "prefill_chunks" else 3)
        kwargs = dict(num_shots=2)
    kwargs.update(prefix=prefix, question_tokens=tokens, question_mask=mask,
                  **MODES[mode])
    if mode == "prefix_only":
        kwargs.update(question_tokens=None, question_mask=None)
    return kwargs


MODES = {
    "beams": dict(num_beams=2),
    "beams_3": dict(num_beams=3),
    "no_prefix": dict(no_prefix=True),
    "no_prefix_beams": dict(no_prefix=True, num_beams=2),
    "prefill_chunks": dict(prefill_chunks=2),
    "one_at_a_time": {},
    "one_at_a_time_beams": dict(num_beams=2),
    "one_at_a_time_no_prefix": dict(no_prefix=True),
    "one_at_a_time_no_prefix_beams": dict(no_prefix=True, num_beams=3),
    "decoder_prefix": dict(decoder_input_ids=np.array(
        [[0, 5], [0, 6], [0, 7]], np.int32)),
    "force_eos_at": dict(force_eos_at=np.array([1, 3, 2], np.int32)),
    "prefix_only": {},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_modes_match_jax(params, mode):
    jp, tp = params
    jcfg, tcfg = configs(True)
    kwargs = mode_inputs(mode)
    jkwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()}
    jtok, jlp = jvct0.VCT0Model(jcfg, jp).generate(max_new_tokens=6,
                                                   **jkwargs)
    ttok, tlp = tvct0.VCT0Model(tcfg, tp).generate(max_new_tokens=6,
                                                   **kwargs)
    assert ttok.dtype == torch.int32 and tlp.dtype == torch.float32
    assert tuple(ttok.shape) == (len(kwargs["prefix"]), 6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-4)


def test_prefill_chunks_and_force_eos_at_keep_the_main_tokens(params):
    """Chunked prefill gives the unchunked tokens; force_eos_at cuts each
    row at its step and keeps the tokens before it."""
    _, tp = params
    _, tcfg = configs(True)
    model = tvct0.VCT0Model(tcfg, tp)
    kwargs = mode_inputs("prefill_chunks")
    del kwargs["prefill_chunks"]
    want = model.generate(max_new_tokens=6, **kwargs)
    got = model.generate(max_new_tokens=6, prefill_chunks=2, **kwargs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    steps = np.array([1, 3, 2, 6], np.int32)
    cut = model.generate(max_new_tokens=6, force_eos_at=steps, **kwargs)[0]
    for row, step in enumerate(steps):
        assert torch.equal(cut[row, :step], want[0][row, :step])
        assert not cut[row, step:].any()


@pytest.mark.parametrize("mode,extra", [
    ("beams", dict(force_eos_at=np.ones((3,), np.int32))),
    ("no_prefix", dict(prefill_chunks=3)),
    ("decoder_prefix", dict(num_beams=2)),
    ("prefix_only", dict(num_beams=2)),
    ("one_at_a_time", dict(force_eos_at=np.ones((3,), np.int32))),
])
def test_mode_combinations_refused_as_jax(params, mode, extra):
    jp, tp = params
    jcfg, tcfg = configs(True)
    kwargs = {**mode_inputs(mode), **extra}
    jkwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()}
    with pytest.raises(ValueError) as want:
        jvct0.VCT0Model(jcfg, jp).generate(**jkwargs)
    with pytest.raises(ValueError) as got:
        tvct0.VCT0Model(tcfg, tp).generate(**kwargs)
    assert str(got.value) == str(want.value)


def test_pipelined_generate_raises(params):
    """The JAX package's pipelined twins (a 3-D mesh's pipeline_ctx) wait
    for the multi-process port."""
    _, tp = params
    _, tcfg = configs(True)
    model = tvct0.VCT0Model(tcfg, tp)
    model.pipeline_ctx = ("mesh", 2, False)
    prefix, tokens, mask = few_shot_batch(0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        model.generate(prefix, tokens, mask, num_shots=2)


@pytest.mark.parametrize("mapping_type", ["transformer", "perceiver"])
def test_unported_mappers_raise(mapping_type):
    """These two mappers once raised naming their ROADMAP item; they are
    ported now (tests/test_torch_mappers.py holds them in full): neither
    raises, and each gives JAX's output on JAX's init within 1e-5."""
    kw = dict(MAPPER, mapping_type=mapping_type, num_layers=2, num_heads=4,
              dim_head=8)
    jp = jmap.init_mapper(jax.random.PRNGKey(1), jmap.MapperConfig(**kw))
    tp = vct0_params_from_numpy(
        {"lm": {}, "mapper": jax.tree.map(np.asarray, jp)}, torch.float32,
        "cpu")["mapper"]
    x = np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32)
    got = tmap.mapper_apply(tmap.MapperConfig(**kw), tp, torch.from_numpy(x))
    want = np.asarray(jmap.mapper_apply(jmap.MapperConfig(**kw), jp,
                                        jnp.asarray(x)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


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
