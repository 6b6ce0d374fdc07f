"""The port's T5 (models/t5.py) against the JAX package's on the same
weights, on the CPU at T5Config.small_test size (fp32)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    t5_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.device import (  # noqa: E402
    make_generator,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402

JCFG = jt5.T5Config.small_test()
TCFG = tt5.T5Config.small_test()


@pytest.fixture(scope="module")
def params():
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, t5_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    torch.float32, "cpu")


def padded_batch(seed=0, batch=3, length=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 32000, size=(batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    mask[0, -4:] = 0
    mask[2, -1:] = 0
    return ids, mask


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16)])
def test_relative_position_buckets_equal(bidirectional, buckets, max_distance):
    rel = np.arange(-2000, 2001, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, buckets, max_distance))
    got = tt5.relative_position_bucket(
        torch.from_numpy(rel).long(), bidirectional, buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < buckets


def test_position_bias_with_query_offset(params):
    jp, tp = params
    want = np.asarray(jt5.compute_position_bias(
        jp["decoder"]["rel_bias"], 1, 9, False, JCFG, query_offset=5))
    got = tt5.compute_position_bias(
        tp["decoder"]["rel_bias"], 1, 9, False, TCFG, query_offset=5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal((32,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jt5.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                   1e-6).astype(jnp.float32))
    got = tt5.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                       1e-6).float().numpy()
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_gelu_new():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        tt5.gelu_new(torch.from_numpy(x)).numpy(),
        np.asarray(jt5.gelu_new(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_lm_logits_bf16_is_unrounded_fp32():
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 1, 32)).astype(np.float32)
    head = rng.standard_normal((32, 50)).astype(np.float32)
    cfg_j = jt5.T5Config.small_test(vocab_size=50, dtype=jnp.bfloat16)
    cfg_t = tt5.T5Config.small_test(vocab_size=50, dtype=torch.bfloat16)
    want = np.asarray(jt5.lm_logits({"lm_head": jnp.asarray(head, jnp.bfloat16)},
                                    cfg_j, jnp.asarray(hidden, jnp.bfloat16)))
    got = tt5.lm_logits({"lm_head": torch.from_numpy(head).bfloat16()}, cfg_t,
                        torch.from_numpy(hidden).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_init_matches_jax_tree_shapes():
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), JCFG, jnp.bfloat16)
    tp = tt5.init_t5_params(make_generator(0, torch.device("cpu")), TCFG,
                            torch.bfloat16)
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            else:
                t_flat[prefix + (k,)] = v

    walk((), tp)
    assert len(t_flat) == len(j_leaves)
    for path, leaf in j_leaves:
        key = tuple(p.key for p in path)
        assert tuple(t_flat[key].shape) == leaf.shape, key
        assert t_flat[key].dtype == torch.bfloat16
    # fan-in scaled init: the q projections' std is (d * kv) ** -0.5
    q_std = t_flat[("encoder", "self_attn", "q")].float().std().item()
    assert abs(q_std / (32 * 8) ** -0.5 - 1) < 0.1


@pytest.mark.parametrize("fused", [False, True])
def test_encode_matches_jax(params, fused):
    jp, tp = params
    ids, mask = padded_batch()
    jcfg = dataclasses.replace(JCFG, fused_encoder_attention=fused)
    tcfg = dataclasses.replace(TCFG, fused_encoder_attention=fused)
    want = np.asarray(jt5.t5_encode(jp, jcfg, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask)))
    got = tt5.t5_encode(tp, tcfg, input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decode_step_logits_match_jax(params):
    jp, tp = params
    ids, mask = padded_batch(seed=3)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    hidden = np.array(jt5.t5_encode(jp, JCFG, input_ids=jnp.asarray(ids),
                                    attention_mask=jm))
    jcache = jt5.init_decode_cache(jp, JCFG, jnp.asarray(hidden), 5)
    tcache = tt5.init_decode_cache(tp, TCFG, torch.from_numpy(hidden), 5)
    tokens = np.array([0, 0, 0], np.int32)
    for step in range(3):
        jlogits, jcache = jt5.t5_decode_step(jp, JCFG, jnp.asarray(tokens),
                                             jcache, jm)
        tlogits, tcache = tt5.t5_decode_step(tp, TCFG,
                                             torch.from_numpy(tokens),
                                             tcache, tm)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        tokens = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert tcache["index"] == 3
    np.testing.assert_allclose(tcache["self_k"].numpy(),
                               np.asarray(jcache["self_k"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flag", sorted(tt5._NOT_PORTED))
def test_unported_options_raise(params, flag):
    _, tp = params
    ids, mask = padded_batch()
    cfg = dataclasses.replace(TCFG, **{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt5.t5_encode(tp, cfg, input_ids=torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask))
