"""The port's ensemble generation (trainers/few_shot_vqa_executor.py::
ensemble_generate: the one-shot and prompt-permutation ensembles, members
scored by summed log-prob without ids {0, 1, 2}, the first best member
kept) on the CPU: against the JAX package's on the same tiny VC-T0 (the
small_test LM in fp32, equal picked tokens) at members_per_call 1, 2 and 3,
greedy and beam; batched equal to looped on a row-wise stub model; the
chunks' shapes; each one-shot member's shot paired with the test image."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    few_shot_vqa_executor as jexec,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    few_shot_vqa_executor as texec,
)

S = 32099
B, E, L, SIZE, T = 3, 3, 12, 16, 5
MAPPER = dict(mapping_type="mlp", prefix_size=SIZE, d_model=32,
              prefix_length=3, clip_length=3)


@pytest.fixture(scope="module")
def models():
    jcfg = jvct0.VCT0Config(
        lm=jt5.T5Config.small_test(fused_encoder_attention=True),
        mapper=jmap.MapperConfig(**MAPPER))
    tcfg = tvct0.VCT0Config(
        lm=tt5.T5Config.small_test(fused_encoder_attention=True),
        mapper=tmap.MapperConfig(**MAPPER))
    jp = jvct0.init_vct0_params(jax.random.PRNGKey(3), jcfg,
                                param_dtype=jnp.float32)
    tp = vct0_params_from_numpy(jax.tree.map(np.asarray, jp), torch.float32,
                                "cpu")
    return jvct0.VCT0Model(jcfg, jp), tvct0.VCT0Model(tcfg, tp)


def ensemble_inputs(mode, seed=0, members=E):
    """(B, E, L) prompts with their sentinels and the mode's embeddings:
    one_shot (B, E + 1, SIZE), each member one shot and the question;
    permutation (B, E, P, SIZE), each member P = 3 prefixes."""
    rng = np.random.default_rng(seed)
    prefixes = 2 if mode == "one_shot" else 3
    ids = rng.integers(3, 30000, (B, members, L)).astype(np.int32)
    mask = np.ones((B, members, L), np.int32)
    for b in range(B):
        for e in range(members):
            valid = L - (b + e) % 3
            ids[b, e, valid:] = 0
            mask[b, e, valid:] = 0
            spots = sorted(rng.choice(valid - 1, prefixes, replace=False))
            for g, j in enumerate(spots):
                ids[b, e, j] = S - g
    shape = ((B, members + 1, SIZE) if mode == "one_shot"
             else (B, members, prefixes, SIZE))
    return ids, mask, rng.standard_normal(shape).astype(np.float32)


def run(model, module, arrays, mode, as_array, **kwargs):
    ids, mask, clip = (as_array(a) for a in arrays)
    return np.asarray(module.ensemble_generate(
        model, ids, mask, clip, num_ensembles=E,
        num_shots=1 if mode == "one_shot" else None, no_prefix=False,
        max_new_tokens=T, mode=mode, **kwargs))


@pytest.mark.parametrize("mode,members_per_call,num_beams", [
    *[(mode, m, 1) for mode in ("one_shot", "permutation")
      for m in (1, 2, 3)],
    ("one_shot", 3, 2), ("permutation", 2, 2)])
def test_ensemble_generate_matches_jax(models, mode, members_per_call,
                                       num_beams):
    jmodel, tmodel = models
    arrays = ensemble_inputs(mode)
    kwargs = dict(members_per_call=members_per_call, num_beams=num_beams)
    want = run(jmodel, jexec, arrays, mode, jnp.asarray, **kwargs)
    got = run(tmodel, texec, arrays, mode, torch.from_numpy, **kwargs)
    assert got.shape == (B, T) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    looped = run(tmodel, texec, arrays, mode, torch.from_numpy,
                 num_beams=num_beams)
    np.testing.assert_array_equal(got, looped)


def test_the_pick_is_the_best_summed_log_prob(models):
    """Each question keeps the member whose tokens' summed log-probs
    (without ids 0, 1, 2) are highest, the first of equals."""
    _, tmodel = models
    ids, mask, clip = (torch.from_numpy(a)
                       for a in ensemble_inputs("permutation", seed=4))
    runs = [tmodel.generate(prefix=clip[:, e], question_tokens=ids[:, e],
                            question_mask=mask[:, e], max_new_tokens=T)
            for e in range(E)]
    scores = torch.stack([tmodel.score_sequences(*r) for r in runs], 1)
    best = scores.argmax(1)
    got = texec.ensemble_generate(
        tmodel, ids, mask, clip, num_ensembles=E, num_shots=None,
        no_prefix=False, max_new_tokens=T, mode="permutation")
    for b in range(B):
        np.testing.assert_array_equal(got[b], runs[best[b]][0][b].numpy())


class StubModel:
    """A row-wise stand-in for generate: each row's tokens and scores come
    from its own inputs alone, as with the real model, so batched and
    looped calls must agree exactly. Records each call's rows and prefix
    shape."""

    def __init__(self):
        self.calls = []

    def generate(self, prefix, question_tokens, question_mask,
                 no_prefix=False, num_shots=None, max_new_tokens=4,
                 num_beams=1):
        self.calls.append({"rows": int(question_tokens.shape[0]),
                           "prefix": prefix.clone()})
        rows = question_tokens.shape[0]
        base = question_tokens.long().sum(1, keepdim=True) % 97 + 3
        tokens = (base + torch.arange(max_new_tokens)[None]).to(torch.int32)
        score = torch.sin(prefix.reshape(rows, -1).sum(1, keepdim=True))
        return tokens, score.expand(rows, max_new_tokens)


def stub_inputs(mode, members=5):
    ids, mask, clip = ensemble_inputs(mode, seed=2, members=members)
    return torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(
        clip)


@pytest.mark.parametrize("members_per_call", [2, 3, 5, 99])
@pytest.mark.parametrize("mode", ["permutation", "one_shot"])
def test_batched_equals_looped(mode, members_per_call):
    ids, mask, clip = stub_inputs(mode)

    def picked(m):
        return texec.ensemble_generate(
            StubModel(), ids, mask, clip, num_ensembles=5,
            num_shots=1 if mode == "one_shot" else None, no_prefix=False,
            max_new_tokens=4, mode=mode, members_per_call=m)

    np.testing.assert_array_equal(picked(members_per_call), picked(1))


def test_chunk_shapes_and_call_count():
    ids, mask, clip = stub_inputs("permutation")
    stub = StubModel()
    texec.ensemble_generate(
        stub, ids, mask, clip, num_ensembles=5, num_shots=None,
        no_prefix=False, max_new_tokens=4, mode="permutation",
        members_per_call=2)
    # E = 5 in chunks of 2, 2, 1 members folded into the batch
    assert [c["rows"] for c in stub.calls] == [B * 2, B * 2, B]
    assert tuple(stub.calls[0]["prefix"].shape) == (B * 2, 3, SIZE)
    # question b's member j is row b * m + j
    torch.testing.assert_close(stub.calls[0]["prefix"].reshape(B, 2, 3, SIZE),
                               clip[:, :2], rtol=0, atol=0)


def test_one_shot_member_pairs_its_shot_with_the_test_image():
    ids, mask, clip = stub_inputs("one_shot")
    stub = StubModel()
    texec.ensemble_generate(
        stub, ids, mask, clip, num_ensembles=5, num_shots=1,
        no_prefix=False, max_new_tokens=4, mode="one_shot",
        members_per_call=2)
    got = torch.cat([c["prefix"].reshape(B, -1, 2, SIZE)
                     for c in stub.calls], dim=1)           # (B, E, 2, SIZE)
    for i in range(5):
        assert torch.equal(got[:, i, 0], clip[:, i])
        assert torch.equal(got[:, i, 1], clip[:, -1])
