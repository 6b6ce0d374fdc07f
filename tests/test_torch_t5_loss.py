"""The port's teacher-forced T5 against the JAX package's, on the same
weights (carried with convert.py), on the CPU at small widths:
shift_right, cross_entropy_loss, t5_decode's logits, and t5_forward_loss
with its gradient into the encoder input through the unfused encoder, the
attention kernel's route and the attention + FFN kernels' route (the
kernels' plain versions forward, their twins backward), with and without
remat. tests/test_torch_vct0_loss.py holds vct0_caption_loss."""

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

# fp32: the loss within LOSS_REL, each gradient within GRAD_RTOL of its
# largest element (sums in another order). The FFN kernel's route rounds
# its normed input and hidden to bf16 on both sides; a value that sits
# within fp32 ulps of a bf16 rounding boundary may round the other way on
# one side, so that route's gradients are held to the bf16 rule. bf16: the
# loss within BF16_LOSS_REL, the mapper gradient at cosine >= BF16_COSINE.
LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4
BF16_COSINE = 0.99
WIDTHS = dict(d_model=64, d_ff=128, num_heads=4, d_kv=16,
              num_encoder_layers=2, num_decoder_layers=2,
              relative_attention_num_buckets=8,
              relative_attention_max_distance=16)
ROUTES = {"unfused": {},
          "attention": dict(fused_encoder_attention=True),
          "attention_ffn": dict(fused_encoder_attention=True,
                                fused_encoder_ffn=True)}
BATCH, CAPTION = 3, 7
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(dtype="float32", **kw):
    jcfg = jt5.T5Config.small_test(dtype=JAX_DTYPES[dtype], **WIDTHS, **kw)
    tcfg = tt5.T5Config.small_test(dtype=TORCH_DTYPES[dtype], **WIDTHS, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def lm():
    jcfg, _ = configs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jp, t5_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    torch.float32, "cpu")


def labels(seed=0):
    """(B, T) caption ids with -100 padding of different lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 32000, (BATCH, CAPTION)).astype(np.int32)
    ids[0, -3:] = -100
    ids[2, -1:] = -100
    return ids


def assert_grad_close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_shift_right_matches_jax():
    jcfg, tcfg = configs()
    ids = labels()
    want = np.asarray(jt5.shift_right(jnp.asarray(ids), jcfg))
    got = tt5.shift_right(torch.from_numpy(ids), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == tcfg.decoder_start_token_id).all()


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((BATCH, CAPTION, 50)) * 3).astype(
        np.float32)
    ids = labels() % 50
    ids[labels() < 0] = -100
    jloss, jcount = jt5.cross_entropy_loss(jnp.asarray(logits),
                                           jnp.asarray(ids))
    tloss, tcount = tt5.cross_entropy_loss(torch.from_numpy(logits),
                                           torch.from_numpy(ids))
    assert int(tcount) == int(jcount) == (ids != -100).sum()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    # no valid label: the count is 0 and the loss 0 (divided by 1)
    none = np.full_like(ids, -100)
    assert float(tt5.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(none))[0]) == 0.0


def test_t5_decode_logits_match_jax(lm):
    jp, tp = lm
    jcfg, tcfg = configs()
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((BATCH, 5, 64)).astype(np.float32)
    enc_mask = np.ones((BATCH, 5), np.int32)
    enc_mask[1, -2:] = 0
    dec_ids = jt5.shift_right(jnp.asarray(labels()), jcfg)
    dec_mask = np.ones((BATCH, CAPTION), np.int32)
    dec_mask[0, -2:] = 0
    want = jt5.t5_decode(jp, jcfg, dec_ids, jnp.asarray(hidden),
                         jnp.asarray(enc_mask), jnp.asarray(dec_mask))
    got = tt5.t5_decode(tp, tcfg, torch.tensor(np.asarray(dec_ids)),
                        torch.from_numpy(hidden), torch.from_numpy(enc_mask),
                        torch.from_numpy(dec_mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_t5_decode_refuses_dropped_decoder_weights(lm):
    _, tp = lm
    _, tcfg = configs()
    dropped = tt5.quantize_decoder_step(tp, drop_bf16=True)
    with pytest.raises(ValueError, match="int8_decoder_step is an eval-only"):
        tt5.t5_decode(dropped, tcfg, torch.zeros((1, 2), dtype=torch.int64),
                      torch.zeros((1, 3, 64)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_t5_forward_loss_and_input_grad_match_jax(lm, route, remat):
    """fp32: the loss and its gradient in the encoder's input embeddings."""
    jp, tp = lm
    jcfg, tcfg = configs(remat=remat, **ROUTES[route])
    rng = np.random.default_rng(4)
    embeds = rng.standard_normal((BATCH, 5, 64)).astype(np.float32)
    mask = np.ones((BATCH, 5), np.int32)
    mask[2, -1:] = 0
    ids = labels()
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda e: jt5.t5_forward_loss(jp, jcfg, jnp.asarray(ids),
                                      inputs_embeds=e,
                                      attention_mask=jnp.asarray(mask))))(
        jnp.asarray(embeds))
    t_embeds = torch.tensor(embeds, requires_grad=True)
    tloss = tt5.t5_forward_loss(tp, tcfg, torch.from_numpy(ids),
                                inputs_embeds=t_embeds,
                                attention_mask=torch.from_numpy(mask))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_REL["float32"])
    assert_grad_close(t_embeds.grad.numpy(), np.asarray(jgrad),
                      GRAD_RTOL if route != "attention_ffn" else 2.0 ** -8)
