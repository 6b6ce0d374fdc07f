"""The port's GPT-2 (ClipCap's LM) against the JAX package's on the same
converted params at GPT2Config.small_test, in fp32 and bf16: the unfused
full-sequence forward, prefill and the KV-cached decode step, greedy
decoding; gpt2_params_from_hf on a local HF GPT2LMHeadModel, with HF's
logits as a third witness. (The fused block is in
tests/test_torch_gpt2_block.py.)"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import gpt2 as jgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import (  # noqa: E402
    hf_convert as jhf,
)
from explicit_alignment_for_vqa_tasks_tpu.ops import (  # noqa: E402
    decoding as jdecoding,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    gpt2_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import (  # noqa: E402
    hf_convert as thf,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    decoding as tdecoding,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same operations, fp32 sums in another order
FP32_TOL = 1e-5
# bf16: both sides round the residual stream and every product to bf16 at
# the same places, but XLA fuses bf16 elementwise chains (the gelu, the
# residual adds) with excess precision where PyTorch rounds after each
# operation; over 2 layers and the LM head the fp32 logits stay within
# BF16_LOGIT_TOL, a few bf16 ulps of the final hidden state.
BF16_LOGIT_TOL = 2e-2
# tests/test_gpt2_parity.py's tolerance against HF
HF_TOL = 2e-4
BATCH, LENGTH = 3, 10


@pytest.fixture(scope="module")
def lm():
    """JAX's small_test init (fp32) with random LayerNorms and biases, as
    numpy."""
    cfg = jgpt2.GPT2Config.small_test()
    tree = jax.tree.map(np.asarray, jgpt2.init_gpt2_params(
        jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.default_rng(1)
    for name, leaf in tree["blocks"].items():
        if "bias" in name or name.endswith("scale"):
            base = 1.0 if name.endswith("scale") else 0.0
            tree["blocks"][name] = (base + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32)
    return tree


def both(tree, dtype, **kw):
    jd, td = DTYPES[dtype]
    jcfg = jgpt2.GPT2Config.small_test(dtype=jd, **kw)
    tcfg = tgpt2.GPT2Config.small_test(dtype=td, **kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    tp = gpt2_params_from_numpy(tree, td, "cpu")
    return (jcfg, jp), (tcfg, tp)


def inputs(seed=0, batch=BATCH, length=LENGTH):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, mask


def assert_logits_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(lm, dtype):
    (jcfg, jp), (tcfg, tp) = both(lm, dtype)
    ids, mask = inputs()
    want = np.asarray(jgpt2.gpt2_forward(
        jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    got = tgpt2.gpt2_forward(tp, tcfg, input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (BATCH, LENGTH, 128)
    assert_logits_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_steps_match_jax(lm, dtype):
    """Prefill a padded prompt into a longer cache, then three steps; each
    step's logits against JAX's, and the caches too."""
    (jcfg, jp), (tcfg, tp) = both(lm, dtype)
    ids, mask = inputs(seed=2, length=6)
    max_len = 9
    full_mask = np.concatenate([mask, np.ones((BATCH, 3), np.int32)], 1)
    jembeds = jgpt2.gpt2_embed(jp, jcfg, jnp.asarray(ids))
    tembeds = tgpt2.gpt2_embed(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(tembeds.float().numpy(),
                               np.asarray(jembeds.astype(jnp.float32)),
                               rtol=0, atol=0)
    jcache = jgpt2.init_gpt2_cache(jcfg, BATCH, max_len)
    tcache = tgpt2.init_gpt2_cache(tcfg, BATCH, max_len)
    jl, jcache = jgpt2.gpt2_prefill(jp, jcfg, jembeds, jnp.asarray(mask),
                                    jcache)
    tl, tcache = tgpt2.gpt2_prefill(tp, tcfg, tembeds,
                                    torch.from_numpy(mask), tcache)
    assert tcache["index"] == int(jcache["index"]) == 6
    assert_logits_close(tl.numpy(), np.asarray(jl), dtype)
    tokens = np.array([[5, 7, 9], [11, 13, 15], [17, 19, 21]], np.int32)
    for t in range(3):
        jl, jcache = jgpt2.gpt2_decode_step(
            jp, jcfg, jnp.asarray(tokens[:, t]), jcache,
            jnp.asarray(full_mask))
        tl, tcache = tgpt2.gpt2_decode_step(
            tp, tcfg, torch.from_numpy(tokens[:, t]), tcache,
            torch.from_numpy(full_mask))
        assert_logits_close(tl.numpy(), np.asarray(jl), dtype)
    assert tcache["index"] == int(jcache["index"]) == 9
    for name in ("k", "v"):
        want = np.asarray(jcache[name].astype(jnp.float32))
        got = tcache[name].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=FP32_TOL,
                                       atol=FP32_TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=BF16_LOGIT_TOL)


def test_greedy_decode_matches_jax(lm):
    """fp32: the tokens equal JAX's and the log-probs agree within 1e-5.
    EOS is a token the rows reach early, so rows finish at different steps
    (EOS recorded with its log-prob, then EOS at log-prob 0)."""
    (jcfg, jp), (tcfg, tp) = both(lm, "float32")
    ids, mask = inputs(seed=3)
    jembeds = jgpt2.gpt2_embed(jp, jcfg, jnp.asarray(ids))
    tembeds = tgpt2.gpt2_embed(tp, tcfg, torch.from_numpy(ids))
    free, _ = jdecoding.greedy_decode_gpt2(jp, jcfg, jembeds,
                                           jnp.asarray(mask),
                                           max_new_tokens=8,
                                           eos_token_id=127)
    eos = int(np.asarray(free)[0, 2])
    want_tok, want_lp = (np.asarray(a) for a in jdecoding.greedy_decode_gpt2(
        jp, jcfg, jembeds, jnp.asarray(mask), max_new_tokens=8,
        eos_token_id=eos))
    got_tok, got_lp = tdecoding.greedy_decode_gpt2(
        tp, tcfg, tembeds, torch.from_numpy(mask), max_new_tokens=8,
        eos_token_id=eos)
    assert got_tok.dtype == torch.int32 and got_lp.dtype == torch.float32
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=FP32_TOL,
                               atol=FP32_TOL)
    assert (want_tok[0, 2:] == eos).all() and (want_lp[0, 3:] == 0).all()


def test_greedy_decode_defaults_to_the_config_eos(lm):
    """No row reaches GPT-2's EOS (50256) in a 128-token vocabulary: every
    step runs, as in JAX."""
    (jcfg, jp), (tcfg, tp) = both(lm, "float32")
    ids, mask = inputs(seed=4)
    want = np.asarray(jdecoding.greedy_decode_gpt2(
        jp, jcfg, jgpt2.gpt2_embed(jp, jcfg, jnp.asarray(ids)),
        jnp.asarray(mask), max_new_tokens=4)[0])
    got = tdecoding.greedy_decode_gpt2(
        tp, tcfg, tgpt2.gpt2_embed(tp, tcfg, torch.from_numpy(ids)),
        torch.from_numpy(mask), max_new_tokens=4)[0]
    np.testing.assert_array_equal(got.numpy(), want)


# --- the HF witness -----------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


def test_params_from_hf_match_jax_converter(hf_model):
    sd = hf_model.state_dict()
    cfg = tgpt2.GPT2Config.small_test()
    got, want = thf.gpt2_params_from_hf(sd, cfg), jhf.gpt2_params_from_hf(
        sd, jgpt2.GPT2Config.small_test())
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_hf_logits_witness(hf_model):
    """The port's forward on HF's converted weights against HF's logits (and
    against JAX's on the same tree), with token ids and with embeddings."""
    cfg = tgpt2.GPT2Config.small_test()
    tree = thf.gpt2_params_from_hf(hf_model.state_dict(), cfg)
    tp = gpt2_params_from_numpy(tree, torch.float32, "cpu")
    ids = np.random.default_rng(5).integers(0, 128, (2, 10))
    with torch.no_grad():
        want = hf_model(torch.from_numpy(ids)).logits.numpy()
        got = tgpt2.gpt2_forward(tp, cfg, input_ids=torch.from_numpy(ids))
        embeds = tgpt2.gpt2_embed(tp, cfg, torch.from_numpy(ids))
        got_embeds = tgpt2.gpt2_forward(tp, cfg, inputs_embeds=embeds)
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)
    np.testing.assert_allclose(got_embeds.numpy(), want, rtol=HF_TOL,
                               atol=HF_TOL)
    jax_logits = np.asarray(jgpt2.gpt2_forward(
        jax.tree.map(jnp.asarray, tree), jgpt2.GPT2Config.small_test(),
        input_ids=jnp.asarray(ids.astype(np.int32))))
    np.testing.assert_allclose(got.numpy(), jax_logits, rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_config_presets():
    small = tgpt2.GPT2Config.gpt2_small()
    assert (small.vocab_size, small.n_positions, small.d_model,
            small.num_layers, small.num_heads) == (50257, 1024, 768, 12, 12)
    assert small.dtype == torch.bfloat16 and not small.fused_block
    assert tgpt2.GPT2Config.small_test(fused_block=True).fused_block
    params = tgpt2.init_gpt2_params(torch.Generator().manual_seed(0),
                                    tgpt2.GPT2Config.small_test(),
                                    torch.float32)
    want = jax.tree.map(np.shape, jgpt2.init_gpt2_params(
        jax.random.PRNGKey(0), jgpt2.GPT2Config.small_test(), jnp.float32))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want
