"""The port's ClipCap against the JAX package's on the same converted params
(GPT2Config.small_test with an mlp mapper): embed_with_prefix, clipcap_loss
with and without the fused GPT-2 block (JAX's Pallas kernel in interpret
mode, the port's plain version), ClipCaptionModel.generate with 2-D and 3-D
prefixes, and ClipCapConfig.from_model_args on the shipped
configs/vqa2/clip_cap.jsonnet."""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clipcap as jcc  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import gpt2 as jgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models.mappers import (  # noqa: E402
    MapperConfig as JMapperConfig,
)
from explicit_alignment_for_vqa_tasks_tpu.utils.jsonnet_eval import (  # noqa: E402
    evaluate_file,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clipcap_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clipcap as tcc  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (  # noqa: E402
    MapperConfig,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32: the same operations, fp32 sums in another order
FP32_TOL = 1e-5
PREFIX_SIZE, PREFIX_LENGTH = 16, 3
BATCH, LENGTH = 4, 9


def configs(fused=False):
    mapper = dict(mapping_type="mlp", prefix_size=PREFIX_SIZE, d_model=32,
                  prefix_length=PREFIX_LENGTH, clip_length=PREFIX_LENGTH)
    return (jcc.ClipCapConfig(
                lm=jgpt2.GPT2Config.small_test(fused_block=fused),
                mapper=JMapperConfig(**mapper)),
            tcc.ClipCapConfig(
                lm=tgpt2.GPT2Config.small_test(fused_block=fused),
                mapper=MapperConfig(**mapper)))


@pytest.fixture(scope="module")
def model():
    """JAX's ClipCap init (fp32), with random LayerNorms and biases, as the
    JAX tree and the port's."""
    jcfg, _ = configs()
    tree = jax.tree.map(np.asarray, jcc.init_clipcap_params(
        jax.random.PRNGKey(0), jcfg, param_dtype=jnp.float32))
    rng = np.random.default_rng(1)
    for name, leaf in tree["lm"]["blocks"].items():
        if "bias" in name or name.endswith("scale"):
            base = 1.0 if name.endswith("scale") else 0.0
            tree["lm"]["blocks"][name] = (base + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32)
    return (jax.tree.map(jnp.asarray, tree),
            clipcap_params_from_numpy(tree, torch.float32, "cpu"))


def batch(seed=0):
    """Prefixes, right-padded token ids, their mask and answer labels (-100
    on the question and the padding)."""
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((BATCH, PREFIX_SIZE)).astype(np.float32)
    ids = rng.integers(0, 128, (BATCH, LENGTH)).astype(np.int32)
    mask = np.ones((BATCH, LENGTH), np.int32)
    for b, valid in enumerate((9, 7, 5, 8)):
        mask[b, valid:] = 0
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    labels[:, :3] = -100
    return prefix, ids, mask, labels


def test_embed_with_prefix_matches_jax(model):
    jp, tp = model
    jcfg, tcfg = configs()
    prefix, ids, mask, _ = batch()
    want_e, want_m = jcc.embed_with_prefix(
        jcfg, jp["lm"], jp["mapper"], jnp.asarray(prefix), jnp.asarray(ids),
        jnp.asarray(mask))
    got_e, got_m = tcc.embed_with_prefix(
        tcfg, tp["lm"], tp["mapper"], torch.from_numpy(prefix),
        torch.from_numpy(ids), torch.from_numpy(mask))
    assert got_e.shape == (BATCH, PREFIX_LENGTH + LENGTH, 32)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("fused", [False, True])
def test_loss_matches_jax(model, fused):
    """The teacher-forced loss, fp32, through the plain block and through
    the fused block (12 positions: the kernel's plain version here)."""
    jp, tp = model
    jcfg, tcfg = configs(fused)
    prefix, ids, mask, labels = batch(seed=2)
    want = float(jcc.clipcap_loss(
        jp["mapper"], jp["lm"], jcfg, jnp.asarray(prefix), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(labels)))
    before = tfab.fused_gpt2_block.launches
    got = tcc.ClipCaptionModel(tcfg, tp).forward_loss(prefix, ids, mask,
                                                      labels)
    assert tfab.fused_gpt2_block.launches == before   # CPU: plain version
    assert got.dim() == 0 and got.dtype == torch.float32
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got.item(), want, rtol=FP32_TOL, atol=0)


def test_loss_without_valid_labels_is_zero(model):
    """max(count, 1): no valid label gives a loss of 0, as in JAX."""
    _, tp = model
    _, tcfg = configs()
    prefix, ids, mask, labels = batch(seed=3)
    labels[:] = -100
    got = tcc.clipcap_loss(tp["mapper"], tp["lm"], tcfg,
                           torch.from_numpy(prefix), torch.from_numpy(ids),
                           torch.from_numpy(mask), torch.from_numpy(labels))
    assert got.item() == 0.0


@pytest.mark.parametrize("prefix_dims", [2, 3])
def test_generate_matches_jax(model, prefix_dims):
    """Greedy tokens equal JAX's and log-probs within 1e-5 (fp32); a 3-D
    prefix (B, P, prefix_size) takes its last image on both sides."""
    jp, tp = model
    jcfg, tcfg = configs()
    prefix, ids, mask, _ = batch(seed=4)
    if prefix_dims == 3:
        others = np.random.default_rng(5).standard_normal(
            (BATCH, 2, PREFIX_SIZE)).astype(np.float32)
        prefix = np.concatenate([others, prefix[:, None]], axis=1)
    want_tok, want_lp = (np.asarray(a) for a in jcc.ClipCaptionModel(
        jcfg, jp).generate(jnp.asarray(prefix), jnp.asarray(ids),
                           jnp.asarray(mask), max_new_tokens=6,
                           eos_token_id=3))
    got_tok, got_lp = tcc.ClipCaptionModel(tcfg, tp).generate(
        prefix, ids, mask, max_new_tokens=6, eos_token_id=3)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_generate_runs_no_block_kernel(model):
    _, tp = model
    _, tcfg = configs(fused=True)
    prefix, ids, mask, _ = batch(seed=6)
    before = tfab.fused_gpt2_block.launches
    calls = []
    real = tfab.fused_gpt2_block_plain
    tfab.fused_gpt2_block_plain = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        tcc.ClipCaptionModel(tcfg, tp).generate(prefix, ids, mask,
                                                max_new_tokens=3)
    finally:
        tfab.fused_gpt2_block_plain = real
    assert calls == [] and tfab.fused_gpt2_block.launches == before


def test_from_model_args_on_the_shipped_config():
    """configs/vqa2/clip_cap.jsonnet's model_args give the same config in
    both packages: GPT-2 small, the mlp mapper, 512 -> 10 x 768."""
    cfg = evaluate_file(os.path.join(REPO, "configs/vqa2/clip_cap.jsonnet"))
    args = cfg["model_config"]["model_args"]
    got = tcc.ClipCapConfig.from_model_args(args)
    want = jcc.ClipCapConfig.from_model_args(args)
    assert dataclasses.asdict(got.mapper) == dataclasses.asdict(want.mapper)
    assert (got.mapper.mapping_type, got.mapper.prefix_size,
            got.prefix_length, got.mapper.d_model) == ("mlp", 512, 10, 768)
    lm_fields = [f.name for f in dataclasses.fields(got.lm) if f.name != "dtype"]
    assert {f: getattr(got.lm, f) for f in lm_fields} == {
        f: getattr(want.lm, f) for f in lm_fields}
    assert got.freeze_lm and tcc.build_clipcap_prefix(got, {"lm": {
        "wte": torch.zeros(1)}}).cfg.freeze_lm
    assert not tcc.build_clipcap_model(got, {"lm": {
        "wte": torch.zeros(1)}}).cfg.freeze_lm
    # the defaults when model_args is empty
    assert tcc.ClipCapConfig.from_model_args({}).mapper == \
        tcc.ClipCapConfig.from_model_args(args).mapper
