"""The port's decode loops beside greedy (ops/decoding.py) against the JAX
package's, on the CPU on the same weights (a 3-decoder-layer T5 of vocab
128, fp32 unless a case says bf16; the JAX decode-attention kernel in
interpret mode): beam search at K = 1, 2, 3 with rows that finish at
different steps, ties, the forced decoder prefix, force_eos_at, and the
chunked prefill, equal to the unchunked decode in fp32 and in each int8
cross-KV layout.

Pass bars: equal tokens; fp32 token log-probs within 1e-5; int8 cross-KV
log-probs within rtol 1e-4, atol 1e-5 (tests/test_torch_int8_decode.py's
bound); bf16 log-probs within two bf16 ulps (rtol 2^-6, atol 1e-3): the
decode step's bf16 roundings fall differently in XLA and in PyTorch, which
moves a log-prob by about one ulp."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.ops import decoding as jdec  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    t5_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import decoding as tdec  # noqa: E402

DIMS = dict(vocab_size=128, d_model=64, d_kv=8, num_heads=8, d_ff=128,
            num_encoder_layers=2, num_decoder_layers=3,
            relative_attention_num_buckets=8,
            relative_attention_max_distance=16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L = 4, 12
INT8_LAYOUTS = ["unmerged", "merged", "transposed", None]


def configs(dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (jt5.T5Config(dtype=jd, **DIMS, **kw),
            tt5.T5Config(dtype=td, **DIMS, **kw))


def weights(eos_boost: float, zero_head: bool = False):
    """JAX params and their port copy. ``eos_boost`` scales the EOS column
    of the LM head, so that some rows finish early and others do not;
    ``zero_head`` makes every logit 0, so that every step is a tie."""
    jcfg, _ = configs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    jp["lm_head"] = jp["lm_head"].at[:, 1].multiply(eos_boost)
    if zero_head:
        jp["lm_head"] = jnp.zeros_like(jp["lm_head"])
    return jp, t5_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    torch.float32, "cpu")


@pytest.fixture(scope="module")
def params():
    return weights(eos_boost=8.0)


def batch(seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, -3:] = 0
    return ids, mask


def hidden(jp, dtype="float32", seed=7):
    """The JAX encoder's states of a batch (the decode loops' input)."""
    jcfg, _ = configs(dtype)
    ids, mask = batch(seed)
    h = jt5.t5_encode(jp, jcfg, input_ids=jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask))
    return h, torch.from_numpy(np.array(h.astype(jnp.float32))).to(
        DTYPES[dtype][1]), mask


def assert_decoded_equal(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=rtol, atol=atol)


def finish_steps(tokens) -> set:
    tokens = np.asarray(tokens)
    return {int(np.argmax(row == 1)) + 1 if (row == 1).any()
            else tokens.shape[1] for row in tokens}


@pytest.mark.parametrize("num_beams,fused_decode", [
    (1, False), (2, False), (3, False), (3, True)])
def test_beam_search_matches_jax(params, num_beams, fused_decode):
    jp, tp = params
    jcfg, tcfg = configs(fused_decode_attention=fused_decode)
    jh, th, mask = hidden(jp)
    want = jdec.beam_search_t5(jp, jcfg, jh, jnp.asarray(mask),
                               num_beams=num_beams, max_new_tokens=8)
    got = tdec.beam_search_t5(tp, tcfg, th, torch.from_numpy(mask),
                              num_beams=num_beams, max_new_tokens=8)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert_decoded_equal(got, want)
    if num_beams > 1:
        # some rows finish early, others run to the budget
        assert len(finish_steps(want[0])) > 1


def test_beam_search_unequal_finishes_at_larger_boost():
    """Most rows finish, at different steps, and the winner's per-token
    log-probs (score differences kept through every reorder) still agree."""
    jp, tp = weights(eos_boost=14.0)
    jcfg, tcfg = configs()
    jh, th, mask = hidden(jp, seed=3)
    want = jdec.beam_search_t5(jp, jcfg, jh, jnp.asarray(mask),
                               num_beams=3, max_new_tokens=8)
    got = tdec.beam_search_t5(tp, tcfg, th, torch.from_numpy(mask),
                              num_beams=3, max_new_tokens=8)
    assert_decoded_equal(got, want)
    assert len(finish_steps(want[0])) > 1


def test_beam_search_ties_go_to_the_lower_index():
    """Every logit 0: each step's K * V totals tie within a beam, and
    lax.top_k keeps the lowest indices (pad, EOS, token 2, ...)."""
    jp, tp = weights(eos_boost=1.0, zero_head=True)
    jcfg, tcfg = configs()
    jh, th, mask = hidden(jp)
    want = jdec.beam_search_t5(jp, jcfg, jh, jnp.asarray(mask),
                               num_beams=3, max_new_tokens=8)
    got = tdec.beam_search_t5(tp, tcfg, th, torch.from_numpy(mask),
                              num_beams=3, max_new_tokens=8)
    assert_decoded_equal(got, want)


def test_top_k_ties_match_lax_top_k():
    rng = np.random.default_rng(0)
    # few distinct values, so most of the top k are ties
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[0] = 0.0
    x[1, ::3] = -1e9
    for k in (1, 3, 7):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tdec.top_k_lowest_index_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_search_bf16_matches_jax(params):
    jp, _ = params
    jcfg, tcfg = configs("bfloat16")
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tb = t5_params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), jb), torch.bfloat16,
        "cpu")
    jh, th, mask = hidden(jb, "bfloat16")
    want = jdec.beam_search_t5(jb, jcfg, jh, jnp.asarray(mask), num_beams=2,
                               max_new_tokens=6)
    got = tdec.beam_search_t5(tb, tcfg, th, torch.from_numpy(mask),
                              num_beams=2, max_new_tokens=6)
    assert_decoded_equal(got, want, atol=1e-3, rtol=2 ** -6)


def test_beam1_equals_greedy(params):
    _, tp = params
    _, tcfg = configs()
    jp, _ = params
    _, th, mask = hidden(jp)
    greedy = tdec.greedy_decode_t5(tp, tcfg, th, torch.from_numpy(mask), 8)
    beam = tdec.beam_search_t5(tp, tcfg, th, torch.from_numpy(mask),
                               num_beams=1, max_new_tokens=8)
    torch.testing.assert_close(beam[0], greedy[0], rtol=0, atol=0)
    torch.testing.assert_close(beam[1], greedy[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("forced", [
    np.array([[0], [0], [0], [0]], np.int32),
    np.array([[0, 5, 6], [0, 7, 8], [0, 9, 10], [0, 11, 12]], np.int32),
])
def test_forced_decode_matches_jax(params, forced):
    jp, tp = params
    jcfg, tcfg = configs()
    jh, th, mask = hidden(jp)
    want = jdec.forced_decode_t5(jp, jcfg, jh, jnp.asarray(mask),
                                 jnp.asarray(forced), max_new_tokens=6)
    got = tdec.forced_decode_t5(tp, tcfg, th, torch.from_numpy(mask),
                                torch.from_numpy(forced), max_new_tokens=6)
    assert tuple(got[0].shape) == (B, 6)
    assert_decoded_equal(got, want)


def test_force_eos_at_matches_jax(params):
    jp, tp = params
    jcfg, tcfg = configs()
    jh, th, mask = hidden(jp)
    steps = np.array([2, 3, 1, 5], np.int32)
    want = jdec.greedy_decode_t5(jp, jcfg, jh, jnp.asarray(mask), 8,
                                 force_eos_at=jnp.asarray(steps))
    got = tdec.greedy_decode_t5(tp, tcfg, th, torch.from_numpy(mask), 8,
                                force_eos_at=torch.from_numpy(steps))
    assert_decoded_equal(got, want)
    # row b keeps its greedy tokens up to its step, then pad
    free = tdec.greedy_decode_t5(tp, tcfg, th, torch.from_numpy(mask), 8)
    for row, step in enumerate(steps):
        assert torch.equal(got[0][row, :step], free[0][row, :step])
        assert not got[0][row, step:].any()


def test_encode_and_greedy_decode_matches_jax(params):
    jp, tp = params
    jcfg, tcfg = configs()
    ids, mask = batch()
    emb = jt5.embed_tokens(jp, jcfg, jnp.asarray(ids))
    want = jdec.encode_and_greedy_decode_t5(jp, jcfg, emb, jnp.asarray(mask),
                                            max_new_tokens=6)
    got = tdec.encode_and_greedy_decode_t5(
        tp, tcfg, torch.from_numpy(np.array(emb)), torch.from_numpy(mask),
        max_new_tokens=6)
    assert_decoded_equal(got, want)


@pytest.mark.parametrize("layout,chunks", [
    ("fp32", 2), ("fp32", 4), *[(layout, 2) for layout in INT8_LAYOUTS]])
def test_chunked_prefill_equals_unchunked_and_jax(params, layout, chunks):
    jp, tp = params
    kw = {} if layout == "fp32" else dict(int8_cross_kv=True,
                                          int8_kv_layout=layout)
    jcfg, tcfg = configs(**kw)
    ids, mask = batch()
    emb = jt5.embed_tokens(jp, jcfg, jnp.asarray(ids))
    temb, tmask = torch.from_numpy(np.array(emb)), torch.from_numpy(mask)
    got = tdec.chunked_prefill_greedy_decode_t5(
        tp, tcfg, temb, tmask, max_new_tokens=6, prefill_chunks=chunks)
    unchunked = tdec.encode_and_greedy_decode_t5(tp, tcfg, temb, tmask,
                                                 max_new_tokens=6)
    torch.testing.assert_close(got[0], unchunked[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], unchunked[1], rtol=0, atol=0)
    want = jdec.chunked_prefill_greedy_decode_t5(
        jp, jcfg, emb, jnp.asarray(mask), max_new_tokens=6,
        prefill_chunks=chunks)
    if layout == "fp32":
        assert_decoded_equal(got, want)
    else:
        assert_decoded_equal(got, want, atol=1e-5, rtol=1e-4)


def test_chunk_cache_takes_the_full_batch_layout(params):
    """With the auto layout the chunks' cache is laid out for the full
    decode batch (transposed from 96 rows), as the decode step reads it,
    and equals JAX's chunk cache."""
    jp, tp = params
    jcfg, tcfg = configs(int8_cross_kv=True)
    jh, th, _ = hidden(jp)
    want = jt5.cross_kv_cache(jp, jcfg, jh[:2], layout_batch=96)
    out = {}
    for row0 in (0, 2):
        tt5.cross_kv_cache(tp, tcfg, th[:2], layout_batch=96, out=out,
                           row0=row0)
    assert tuple(out["cross_k"].shape) == (3, 96, 8, 8, L)
    for key, leaf in want.items():
        np.testing.assert_array_equal(out[key][:, :2].numpy(),
                                      np.asarray(leaf))
        np.testing.assert_array_equal(out[key][:, 2:4].numpy(),
                                      np.asarray(leaf))
    alone = tt5.cross_kv_cache(tp, tcfg, th[:2])
    assert tuple(alone["cross_k"].shape) == (3, 2, L, 8, 8)   # unmerged


def test_chunked_prefill_needs_chunks_that_divide_the_batch(params):
    jp, tp = params
    _, tcfg = configs()
    ids, mask = batch()
    emb = torch.from_numpy(np.array(jt5.embed_tokens(
        jp, configs()[0], jnp.asarray(ids))))
    with pytest.raises(ValueError, match="must divide batch"):
        tdec.chunked_prefill_greedy_decode_t5(
            tp, tcfg, emb, torch.from_numpy(mask), max_new_tokens=5,
            prefill_chunks=3)
