"""The port's int8 decode side (models/t5.py: _resolve_kv_layout, the int8
cross_kv_cache layouts and their scale-folded decode cross-attention,
_matmul_w8, quantize_decoder_step and the W8A16 decode step;
models/vct0.py's decoder-step quantization; convert.py's step_q8 leaves)
against the JAX package's, on the same weights, on the CPU (fp32, small
widths).

The cross K/V projections here are exact: the encoder states and the
cross k/v weights are dyadic (multiples of 1/4 and 1/64, so every product
and sum is exact in fp32 in any order). Both packages then quantize the
same fp32 values and the int8 caches are bit-equal; with random states an
activation within an ulp of a .5 code boundary could take another code on
each side (tests/test_torch_int8_kernels.py bounds what that does)."""

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
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import decoding as tdec  # noqa: E402

# the JAX package's tests/test_int8_cross_kv.py configuration
WIDTHS = dict(vocab_size=128, d_model=64, d_kv=8, num_heads=8, d_ff=128,
              num_encoder_layers=2, num_decoder_layers=3,
              relative_attention_num_buckets=8,
              relative_attention_max_distance=16)
BATCH, LENC = 4, 12


def configs(**kw):
    return (jt5.T5Config(**WIDTHS, dtype=jnp.float32, **kw),
            tt5.T5Config(**WIDTHS, dtype=torch.float32, **kw))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def dyadic(rng, shape, scale, step):
    return (np.round(rng.standard_normal(shape) * scale) * step).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup():
    """JAX params (fp32, dyadic cross k/v, step_q8 added, bf16 weights
    kept), the same tree in the port, dyadic encoder states and a padded
    mask."""
    jcfg, _ = configs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(7)
    dec = dict(jp["decoder"])
    dec["cross_attn"] = dict(dec["cross_attn"])
    for name in ("k", "v"):
        dec["cross_attn"][name] = jnp.asarray(dyadic(rng, (3, 64, 64), 8,
                                                     1 / 64))
    jp = dict(jp, decoder=dec)
    jq = jt5.quantize_decoder_step(jp)
    hidden = np.clip(dyadic(rng, (BATCH, LENC, 64), 4, 1 / 4), -2, 2)
    mask = np.ones((BATCH, LENC), np.int32)
    mask[1, -4:] = 0
    mask[3, -1:] = 0
    return jq, t5_params_from_numpy(to_numpy(jq), torch.float32, "cpu"), \
        hidden, mask


# --- layouts and the int8 cache ----------------------------------------------

@pytest.mark.parametrize("layout,batch", [
    (None, 1), (None, 95), (None, 96), ("merged", 200), ("transposed", 2),
    ("unmerged", 128),
])
def test_resolve_kv_layout_matches_jax(layout, batch):
    jcfg, tcfg = configs(int8_cross_kv=True, int8_kv_layout=layout)
    want = jt5._resolve_kv_layout(jcfg, batch)
    assert tt5._resolve_kv_layout(tcfg, batch) == want
    assert want == (layout or ("transposed" if batch >= 96 else "unmerged"))


def test_resolve_kv_layout_refuses_what_jax_refuses():
    jcfg, tcfg = configs(int8_cross_kv=True, int8_kv_layout="diagonal")
    with pytest.raises(ValueError, match="int8_kv_layout must be"):
        jt5._resolve_kv_layout(jcfg, 4)
    with pytest.raises(ValueError, match="int8_kv_layout must be"):
        tt5._resolve_kv_layout(tcfg, 4)


CACHE_SHAPES = {   # (codes, scales) without the leading layer axis
    "unmerged": ((BATCH, LENC, 8, 8), (BATCH, 1, 8, 8)),
    "merged": ((BATCH, LENC, 64), (BATCH, 1, 64)),
    "transposed": ((BATCH, 8, 8, LENC), (BATCH, 1, 8, 8)),
}


@pytest.mark.parametrize("layout,layout_batch,resolved", [
    ("unmerged", None, "unmerged"), ("merged", None, "merged"),
    ("transposed", None, "transposed"), (None, 96, "transposed"),
])
def test_int8_cross_kv_cache_bit_equal_to_jax(setup, layout, layout_batch,
                                              resolved):
    jq, tq, hidden, _ = setup
    jcfg, tcfg = configs(int8_cross_kv=True, int8_kv_layout=layout)
    want = jt5.cross_kv_cache(jq, jcfg, jnp.asarray(hidden),
                              layout_batch=layout_batch)
    got = tt5.cross_kv_cache(tq, tcfg, torch.from_numpy(hidden),
                             layout_batch=layout_batch)
    assert sorted(got) == sorted(want) == [
        "cross_k", "cross_k_scale", "cross_v", "cross_v_scale"]
    codes, scales = CACHE_SHAPES[resolved]
    for name in ("k", "v"):
        assert got[f"cross_{name}"].dtype == torch.int8
        assert got[f"cross_{name}_scale"].dtype == torch.float32
        assert tuple(got[f"cross_{name}"].shape) == (3, *codes)
        assert tuple(got[f"cross_{name}_scale"].shape) == (3, *scales)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                      err_msg=key)


# --- W8A16: quantize_decoder_step and _matmul_w8 ------------------------------

@pytest.mark.parametrize("drop_bf16", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_quantize_decoder_step_bit_equal_to_jax(gated, drop_bf16):
    """At d_model 256 and d_ff 512 "auto" picks 2 groups for the D-deep
    products and 4 for wo."""
    widths = dict(WIDTHS, d_model=256, d_kv=32, d_ff=512,
                  num_decoder_layers=2, is_gated_act=gated)
    jp = jt5.init_t5_params(jax.random.PRNGKey(3),
                            jt5.T5Config(**widths, dtype=jnp.float32),
                            jnp.bfloat16)
    tp = t5_params_from_numpy(to_numpy(jp), torch.bfloat16, "cpu")
    want = jt5.quantize_decoder_step(jp, drop_bf16=drop_bf16)["decoder"]
    got = tt5.quantize_decoder_step(tp, drop_bf16=drop_bf16)["decoder"]
    assert sorted(got) == sorted(want)
    for sub in ("self_attn", "cross_attn", "ffn"):
        assert sorted(got[sub]) == sorted(want[sub]), sub
    assert sorted(got["step_q8"]) == sorted(want["step_q8"])
    for name, w in want["step_q8"].items():
        w = np.asarray(w)
        g = got["step_q8"][name]
        assert g.dtype == (torch.int8 if w.dtype == np.int8 else
                           torch.float32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got["step_q8"]["self_q_s"].shape[1] == 2
    assert got["step_q8"]["wo_s"].shape[1] == 4
    # a new dict: the input tree keeps its bf16 weights and no step_q8
    assert "step_q8" not in tp["decoder"]
    assert sorted(tp["decoder"]["ffn"]) == sorted(jp["decoder"]["ffn"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_w8_matches_jax(dtype):
    """The fp32 group partials and the fp32 scales: within the fp32 sum
    order (the products of x's values and the codes are exact). XLA on
    the CPU has no bf16 x bf16 -> fp32 dot, so a bf16 x goes to JAX as the
    fp32 of its values: the same products."""
    rng = np.random.default_rng(5)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((2, 3, 256)).astype(
        np.float32)).to(td)
    w8 = rng.integers(-127, 128, (256, 96)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, (2, 96)).astype(np.float32)
    want = np.asarray(jt5._matmul_w8(jnp.asarray(x.float().numpy()),
                                     jnp.asarray(w8), jnp.asarray(scale)))
    got = tt5._matmul_w8(x, torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --- the decode step ----------------------------------------------------------

DECODE_MODES = {
    "cross_kv_unmerged": dict(int8_cross_kv=True, int8_kv_layout="unmerged"),
    "cross_kv_merged": dict(int8_cross_kv=True, int8_kv_layout="merged"),
    "cross_kv_transposed": dict(int8_cross_kv=True,
                                int8_kv_layout="transposed"),
    "decoder_step": dict(int8_decoder_step=True),
    "both": dict(int8_cross_kv=True, int8_decoder_step=True),
}


@pytest.mark.parametrize("mode", sorted(DECODE_MODES))
def test_decode_step_logits_match_jax(setup, mode):
    """Three steps on the same encoder states, each side on its own cache
    (the int8 cross leaves bit-equal): logits within 1e-4, the step's K/V
    written alike."""
    jq, tq, hidden, mask = setup
    jcfg, tcfg = configs(**DECODE_MODES[mode])
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    jcache = jt5.init_decode_cache(jq, jcfg, jnp.asarray(hidden), 5)
    tcache = tt5.init_decode_cache(tq, tcfg, torch.from_numpy(hidden), 5)
    for key in jcache:
        if key.startswith("cross_"):
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(jcache[key]))
    tokens = np.zeros((BATCH,), np.int32)
    for step in range(3):
        jlogits, jcache = jt5.t5_decode_step(jq, jcfg, jnp.asarray(tokens),
                                             jcache, jm)
        tlogits, tcache = tt5.t5_decode_step(tq, tcfg,
                                             torch.from_numpy(tokens),
                                             tcache, tm)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        tokens = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    np.testing.assert_allclose(tcache["self_v"].numpy(),
                               np.asarray(jcache["self_v"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["cross_kv_unmerged", "decoder_step",
                                  "both"])
def test_greedy_tokens_match_jax(setup, mode):
    jq, tq, hidden, mask = setup
    jcfg, tcfg = configs(**DECODE_MODES[mode])
    want_tok, want_lp = jdec.greedy_decode_t5(
        jq, jcfg, jnp.asarray(hidden), jnp.asarray(mask), 6)
    got_tok, got_lp = tdec.greedy_decode_t5(
        tq, tcfg, torch.from_numpy(hidden), torch.from_numpy(mask), 6)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-4, atol=1e-5)


def test_layouts_decode_identically(setup):
    """As tests/test_int8_cross_kv.py:74-89 pins them in JAX: the same
    quantization in another storage; unmerged and merged bit-equal,
    transposed within 1e-5 (it takes the same products in another
    order)."""
    _, tq, hidden, mask = setup
    token = torch.zeros((BATCH,), dtype=torch.int32)
    outs = {}
    for layout in ("unmerged", "merged", "transposed"):
        _, tcfg = configs(int8_cross_kv=True, int8_kv_layout=layout)
        cache = tt5.init_decode_cache(tq, tcfg, torch.from_numpy(hidden), 6)
        outs[layout], _ = tt5.t5_decode_step(tq, tcfg, token, cache,
                                             torch.from_numpy(mask))
    torch.testing.assert_close(outs["merged"], outs["unmerged"], rtol=0,
                               atol=0)
    torch.testing.assert_close(outs["transposed"], outs["unmerged"],
                               rtol=1e-5, atol=1e-5)


def test_dropped_and_kept_trees_decode_identically(setup):
    """With drop_bf16 the step reads no dropped leaf: the same tokens and
    log-probs as the tree that keeps its bf16 weights."""
    _, tq, hidden, mask = setup
    _, tcfg = configs(int8_decoder_step=True, int8_cross_kv=True)
    dropped = tt5.quantize_decoder_step(tq, drop_bf16=True)
    assert sorted(dropped["decoder"]["self_attn"]) == []
    assert sorted(dropped["decoder"]["cross_attn"]) == ["k", "v"]
    assert sorted(dropped["decoder"]["ffn"]) == []
    runs = [tdec.greedy_decode_t5(p, tcfg, torch.from_numpy(hidden),
                                  torch.from_numpy(mask), 6)
            for p in (tq, dropped)]
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=0, atol=0)


def test_missing_step_q8_raises_as_jax_does(setup):
    jq, tq, hidden, mask = setup
    jcfg, tcfg = configs(int8_decoder_step=True)
    jp = dict(jq, decoder={k: v for k, v in jq["decoder"].items()
                           if k != "step_q8"})
    tp = dict(tq, decoder={k: v for k, v in tq["decoder"].items()
                           if k != "step_q8"})
    token = np.zeros((BATCH,), np.int32)
    jcache = jt5.init_decode_cache(jp, jcfg, jnp.asarray(hidden), 4)
    with pytest.raises(ValueError, match="quantize_decoder_step"):
        jt5.t5_decode_step(jp, jcfg, jnp.asarray(token), jcache,
                           jnp.asarray(mask))
    tcache = tt5.init_decode_cache(tp, tcfg, torch.from_numpy(hidden), 4)
    with pytest.raises(ValueError, match="quantize_decoder_step"):
        tt5.t5_decode_step(tp, tcfg, torch.from_numpy(token), tcache,
                           torch.from_numpy(mask))


# --- models/vct0.py and convert.py --------------------------------------------

def test_build_time_quantization_covers_the_decode_step(setup):
    """quantize_int8_encoder with int8_decoder_step: the model factory's
    quantize_decoder_step(drop_bf16=True), bit-equal to JAX's."""
    jq, tq, _, _ = setup
    plain_j = dict(jq, decoder={k: v for k, v in jq["decoder"].items()
                                if k != "step_q8"})
    plain_t = dict(tq, decoder={k: v for k, v in tq["decoder"].items()
                                if k != "step_q8"})
    _, tcfg = configs(int8_decoder_step=True)
    got = tvct0.quantize_int8_encoder(plain_t, tcfg)["decoder"]
    want = jt5.quantize_decoder_step(plain_j, drop_bf16=True)["decoder"]
    for sub in ("self_attn", "cross_attn", "ffn"):
        assert sorted(got[sub]) == sorted(want[sub]), sub
    for name, w in want["step_q8"].items():
        np.testing.assert_array_equal(got["step_q8"][name].numpy(),
                                      np.asarray(w), err_msg=name)
    assert "step_q8" not in plain_t["decoder"]


def test_convert_carries_step_q8_bit_equal():
    """A bf16 JAX tree with step_q8 (bf16 weights dropped) crosses over
    with every leaf bit-equal: int8 codes as int8, scales as fp32, the
    rest in the LM dtype."""
    jcfg, _ = configs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    jq = jt5.quantize_decoder_step(jp, drop_bf16=True)
    tq = t5_params_from_numpy(to_numpy(jq), torch.bfloat16, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert any(p[1].key == "step_q8" for p, _ in leaves
               if len(p) > 1)
    for path, want in leaves:
        got = tq
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        name = "/".join(p.key for p in path)
        if want.dtype == np.int8:
            assert got.dtype == torch.int8, name
        elif name.endswith("_s"):
            assert want.dtype == np.float32 and got.dtype == torch.float32, \
                name
        else:
            assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
