"""The port's Transformer and Perceiver mappers against the JAX package's,
on the CPU in fp32: the init trees' keys and shapes, each mapper's output
on JAX's params (carried with convert.py), and its gradient through the
caption loss of VC-T0 (T5 small_test) and of ClipCap (GPT-2 small_test),
each within 1e-5 of the largest value; VC-T0's perceiver latents drawn
from the vocabulary; and both mappers selected by the config override
``model_config.model_args.mapping_type`` through the model factory."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import clipcap as jcc  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import gpt2 as jgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clipcap_params_from_numpy,
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clipcap as tcc  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import mappers as tmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.models import vct0 as tvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.model_factory import (  # noqa: E402
    build_model_from_config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.optimization import (  # noqa: E402
    tree_leaves,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.config_system import (  # noqa: E402
    process_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: the same operations, sums in another order
REL = 1e-5
PREFIX_SIZE, PREFIX_LENGTH, CLIP_LENGTH = 16, 3, 4
MAPPING_TYPES = ("transformer", "perceiver")


def mapper_kwargs(mapping_type):
    return dict(mapping_type=mapping_type, prefix_size=PREFIX_SIZE,
                d_model=32, prefix_length=PREFIX_LENGTH,
                clip_length=CLIP_LENGTH, num_layers=2, num_heads=4,
                dim_head=8)


def model_configs(kind, mapping_type):
    kw = mapper_kwargs(mapping_type)
    if kind == "vct0":
        return (jvct0.VCT0Config(lm=jt5.T5Config.small_test(),
                                 mapper=jmap.MapperConfig(**kw)),
                tvct0.VCT0Config(lm=tt5.T5Config.small_test(),
                                 mapper=tmap.MapperConfig(**kw)))
    return (jcc.ClipCapConfig(lm=jgpt2.GPT2Config.small_test(),
                              mapper=jmap.MapperConfig(**kw)),
            tcc.ClipCapConfig(lm=tgpt2.GPT2Config.small_test(),
                              mapper=tmap.MapperConfig(**kw)))


def jax_params(kind, jcfg):
    """JAX's init (fp32) with LayerNorms moved off 1 and 0, so that every
    parameter of the mapper reaches the output, as numpy."""
    init = jvct0.init_vct0_params if kind == "vct0" \
        else jcc.init_clipcap_params
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg,
                                         param_dtype=jnp.float32))
    rng = np.random.default_rng(3)

    def perturb(node):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            elif "_scale" in name or "_bias" in name:
                base = 1.0 if "_scale" in name else 0.0
                node[name] = (base + 0.1 * rng.standard_normal(leaf.shape)
                              ).astype(np.float32)

    perturb(tree["mapper"])
    carry = vct0_params_from_numpy if kind == "vct0" \
        else clipcap_params_from_numpy
    return tree, carry(tree, torch.float32, "cpu")


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def flat(tree, prefix=""):
    """{dotted key: leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


@pytest.mark.parametrize("mapping_type", MAPPING_TYPES)
def test_init_tree_matches_jax(mapping_type):
    """The same keys and shapes as JAX's init, every leaf fp32; the
    LayerNorms at 1 and 0."""
    kw = mapper_kwargs(mapping_type)
    want = flat(jax.eval_shape(
        lambda k: jmap.init_mapper(k, jmap.MapperConfig(**kw)),
        jax.random.PRNGKey(0)))
    got = flat(tmap.init_mapper(torch.Generator().manual_seed(0),
                                tmap.MapperConfig(**kw)))
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[key].shape), key
        assert leaf.dtype == torch.float32
        if key.endswith("_scale"):
            assert bool((leaf == 1).all())
        if key.endswith("_bias") and "ln" in key:
            assert bool((leaf == 0).all())


@pytest.mark.parametrize("kind", ["vct0", "clipcap"])
@pytest.mark.parametrize("mapping_type", MAPPING_TYPES)
def test_mapper_output_matches_jax(kind, mapping_type):
    jcfg, tcfg = model_configs(kind, mapping_type)
    tree, tp = jax_params(kind, jcfg)
    x = np.random.default_rng(0).standard_normal(
        (5, PREFIX_SIZE)).astype(np.float32)
    want = jmap.mapper_apply(jcfg.mapper, jax.tree.map(jnp.asarray,
                                                       tree["mapper"]),
                             jnp.asarray(x))
    got = tmap.mapper_apply(tcfg.mapper, tp["mapper"], torch.from_numpy(x))
    assert got.shape == (5, PREFIX_LENGTH * 32)
    close(got, want)
    # a leading (B, P) shape, as project_prefix passes
    x3 = x[:4].reshape(2, 2, PREFIX_SIZE)
    close(tmap.mapper_apply(tcfg.mapper, tp["mapper"], torch.from_numpy(x3)),
          jmap.mapper_apply(jcfg.mapper, jax.tree.map(jnp.asarray,
                                                      tree["mapper"]),
                            jnp.asarray(x3)))


def caption_batch(kind, seed=0, batch=4, length=7):
    rng = np.random.default_rng(seed)
    clip = rng.standard_normal((batch, PREFIX_SIZE)).astype(np.float32)
    vocab = 120
    ids = rng.integers(3, vocab, (batch, length)).astype(np.int32)
    labels = ids.astype(np.int64).copy()
    mask = np.ones((batch, length), np.int32)
    for b, valid in enumerate((7, 5, 6, 3)[:batch]):
        mask[b, valid:] = 0
        labels[b, valid:] = -100
    labels[:, :2] = -100
    return clip, ids, mask, labels


@pytest.mark.parametrize("kind", ["vct0", "clipcap"])
@pytest.mark.parametrize("mapping_type", MAPPING_TYPES)
def test_caption_loss_gradient_matches_jax(kind, mapping_type):
    """The loss and every mapper gradient of the frozen LM's caption loss
    (VC-T0's prefix-only T5 loss; ClipCap's answer loss)."""
    jcfg, tcfg = model_configs(kind, mapping_type)
    tree, tp = jax_params(kind, jcfg)
    clip, ids, mask, labels = caption_batch(kind)
    jtree = jax.tree.map(jnp.asarray, tree)
    if kind == "vct0":
        jloss, jgrads = jax.value_and_grad(jvct0.vct0_caption_loss)(
            jtree["mapper"], jtree["lm"], jcfg, jnp.asarray(clip),
            jnp.asarray(labels))
    else:
        jloss, jgrads = jax.value_and_grad(jcc.clipcap_loss)(
            jtree["mapper"], jtree["lm"], jcfg, jnp.asarray(clip),
            jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
    leaves = tree_leaves(tp["mapper"])
    for leaf in leaves:
        leaf.requires_grad_(True)
    if kind == "vct0":
        loss = tvct0.vct0_caption_loss(tp["mapper"], tp["lm"], tcfg,
                                       torch.from_numpy(clip),
                                       torch.from_numpy(labels))
    else:
        loss = tcc.clipcap_loss(tp["mapper"], tp["lm"], tcfg,
                                torch.from_numpy(clip),
                                torch.from_numpy(ids),
                                torch.from_numpy(mask),
                                torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    want = flat(jax.tree.map(np.asarray, jgrads))
    got = flat(tp["mapper"])
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert leaf.grad is not None, key
        close(leaf.grad, want[key])


def test_vct0_perceiver_latents_are_vocabulary_rows():
    """The perceiver's latents are prefix_length rows of the LM's shared
    embedding, as JAX's init_vct0_params samples them."""
    _, tcfg = model_configs("vct0", "perceiver")
    params = tvct0.init_vct0_params(tcfg, seed=0, device="cpu",
                                    param_dtype=torch.float32)
    latents = params["mapper"]["latents"]
    shared = params["lm"]["shared"]
    assert latents.shape == (PREFIX_LENGTH, 32)
    for row in latents:
        assert bool((shared == row).all(dim=1).any())
    # the clipcap perceiver keeps JAX's normal latents
    _, ccfg = model_configs("clipcap", "perceiver")
    cparams = tcc.init_clipcap_params(ccfg, seed=0, device="cpu",
                                      param_dtype=torch.float32)
    assert not bool((cparams["lm"]["wte"][:, None]
                     == cparams["mapper"]["latents"][None]).all(-1).any())


def config_args(config):
    return argparse.Namespace(
        config=os.path.join(REPO, "configs", config), mode="train",
        experiment_name="mappers", reset=False, num_shots=0, no_prefix=0,
        pass_examples_through_encoder_one_at_a_time=0,
        num_permutations_of_in_context_examples=0, sample_templates=0,
        ensemble_one_shots=0, in_context_examples_fpath="", modules=[],
        tags=[], test_batch_size=-1, test_evaluation_name="", opts=[])


@pytest.mark.parametrize("config,lm_config,kind", [
    ("conceptual_captions/conceptual_captions.jsonnet",
     {"d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 64,
      "num_encoder_layers": 2, "num_decoder_layers": 2}, "vct0"),
    ("vqa2/clip_cap.jsonnet",
     {"vocab_size": 256, "n_positions": 64, "d_model": 32, "num_layers": 2,
      "num_heads": 4}, "clipcap"),
])
@pytest.mark.parametrize("mapping_type", MAPPING_TYPES)
def test_config_override_builds_and_trains(config, lm_config, kind,
                                           mapping_type, tmp_path):
    """``model_config.model_args.mapping_type`` selects the mapper through
    the shipped config (8 layers and 8 heads, JAX's MapperConfig
    defaults); an AdamW step on the caption loss moves every leaf."""
    cfg = process_config(config_args(config))
    cfg.EXPERIMENT_FOLDER = str(tmp_path)
    mc = cfg.model_config
    mc.ConfigClass = "T5_test" if kind == "vct0" else "GPT2_test"
    mc.lm_config = lm_config
    mc.pretrained = 0
    mc.model_args.mapping_type = mapping_type
    mc.model_args.prefix_size = PREFIX_SIZE
    mc.model_args.prefix_length = PREFIX_LENGTH
    cfg.tpu.compute_dtype = cfg.tpu.params_dtype = "float32"
    model, got_kind = build_model_from_config(cfg, device="cpu")
    assert got_kind == kind
    assert model.cfg.mapper.mapping_type == mapping_type
    assert (model.cfg.mapper.num_layers, model.cfg.mapper.num_heads) == (8, 8)
    leaves = tree_leaves(model.params["mapper"])
    before = [t.clone() for t in leaves]
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.AdamW(leaves, lr=1e-3)
    clip, ids, mask, labels = caption_batch(kind)
    if kind == "vct0":
        loss = tvct0.vct0_caption_loss(
            model.params["mapper"], model.params["lm"], model.cfg,
            torch.from_numpy(clip), torch.from_numpy(labels))
    else:
        loss = model.forward_loss(clip, ids, mask, labels)
    assert bool(torch.isfinite(loss))
    loss.backward()
    optimizer.step()
    for old, new in zip(before, leaves):
        assert not torch.equal(old, new.detach())
    # the config's own tree matches JAX's keys and shapes
    jmapper = jmap.MapperConfig(**{
        f.name: getattr(model.cfg.mapper, f.name)
        for f in dataclasses.fields(tmap.MapperConfig)})
    want = flat(jax.eval_shape(lambda k: jmap.init_mapper(k, jmapper),
                               jax.random.PRNGKey(0)))
    got = flat(model.params["mapper"])
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
