"""The port's data- and tensor-parallel mapper training against the JAX
package's one-process step on the union batch, on the CPU.

Four gloo ranks (spawned once, tests/torch_mesh_ranks.py) train VC-T0's
mapper through ``VCT0Executor.training_step`` on (data 2, model 2): each
data rank its half of an 8-row batch of captions of unequal lengths, the
T5 split over the model axis (its encoder attention through row 1's
autograd form, at 2 heads a rank). Held to:

  * the loss: the global batch's token-weighted cross-entropy (each rank's
    numerator over the valid tokens summed over the data axes), within
    1e-6 relative of JAX's ``vct0_caption_loss`` on the union batch;
  * the mapper gradients (summed over the data axes, the model axis's
    input gradients all-reduced by ``copy_to_model``) within
    1e-5 (1 + |want|) of JAX's;
  * the mapper and the optimizer's moments bit-identical on every rank
    after two steps;
  * a shard one batch short takes as many steps as the long one (a null
    step of -100 labels), and the ranks stay equal;
  * the checkpoint rank 0 writes restores in a (data 1, model 2) run and
    in one process to the same mapper and the same loss.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
)

import torch_mesh_ranks as ranks  # noqa: E402

PREFIX = 16
MAPPER = dict(mapping_type="mlp", prefix_size=PREFIX, d_model=32,
              prefix_length=3, clip_length=3)
PORT_LM = dict(fused_encoder_attention=True)
ROWS, TARGET = 8, 6


def caption_rows(rng, rows):
    labels = rng.integers(3, 1000, size=(rows, TARGET)).astype(np.int64)
    for r in range(rows):
        labels[r, 2 + r % (TARGET - 1):] = -100
    clip = rng.standard_normal((rows, PREFIX)).astype(np.float32)
    return {"clip": clip, "labels": labels}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jvct0.VCT0Config(lm=jt5.T5Config.small_test(),
                            mapper=jmap.MapperConfig(**MAPPER))
    params = jvct0.init_vct0_params(jax.random.PRNGKey(1), jcfg,
                                    param_dtype=jnp.float32)
    rng = np.random.default_rng(5)
    union = caption_rows(rng, ROWS)
    short = [[caption_rows(rng, 4) for _ in range(3)],
             [caption_rows(rng, 4) for _ in range(2)]]
    ckpt = tmp_path_factory.mktemp("dp_ckpt")
    got = ranks.run_ranks(ranks.dp_worker, 4,
                          tmp_path_factory.mktemp("dp_ranks"),
                          jax.tree.map(np.asarray, params), PORT_LM, MAPPER,
                          union, short, str(ckpt))
    loss, grads = jax.value_and_grad(jvct0.vct0_caption_loss)(
        params["mapper"], params["lm"], jcfg, jnp.asarray(union["clip"]),
        jnp.asarray(union["labels"]))
    return dict(params=params, union=union, got=got, ckpt=str(ckpt),
                loss=float(loss), grads=grads)


def leaves(tree):
    """A tree's leaves in the port's order (tree_leaves: sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [np.asarray(tree)]


def test_loss_is_the_union_batch_loss(run):
    for rec in run["got"]:
        assert abs(rec["losses"][0] - run["loss"]) <= 1e-6 * abs(run["loss"])


def test_mapper_gradients_match_jax(run):
    want = leaves(run["grads"])
    for rec in run["got"]:
        assert len(rec["grads"]) == len(want)
        for g, w in zip(rec["grads"], want):
            assert np.all(np.abs(g - w) <= 1e-5 * (1 + np.abs(w)))


def test_mapper_and_moments_bit_identical_across_ranks(run):
    first = run["got"][0]
    for rec in run["got"][1:]:
        for a, b in zip(leaves(rec["mapper"]), leaves(first["mapper"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rec["moments"], first["moments"]):
            np.testing.assert_array_equal(a, b)
    # the steps moved the mapper
    assert not np.array_equal(leaves(first["mapper"])[0],
                              leaves(run["params"]["mapper"])[0])


def test_short_shard_takes_as_many_steps(run):
    got = run["got"]
    assert sorted({r["short_local"] for r in got}) == [2, 3]
    assert all(r["short_steps"] == 3 for r in got)
    for rec in got[1:]:
        for a, b in zip(leaves(rec["short_mapper"]),
                        leaves(got[0]["short_mapper"])):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_restores_across_topologies(run):
    """Rank 0 of the data-2 run wrote it; ranks 0 and 1 of a model-2 run
    and this one process restore the same mapper and give the same loss."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm

    saved = run["got"][0]["short_mapper"]
    restored = [r for r in run["got"] if "restored" in r]
    assert len(restored) == 2
    for rec in restored:
        for a, b in zip(leaves(rec["restored"]), leaves(saved)):
            np.testing.assert_array_equal(a, b)
        assert rec["restored_loss"] == restored[0]["restored_loss"]
    assert pm.active_mesh() is None
    ex = ranks.train_executor(jax.tree.map(np.asarray, run["params"]),
                              PORT_LM, MAPPER)
    state = dict(tckpt.load_checkpoint(
        tckpt.get_checkpoint_model_path(run["ckpt"])))
    state.pop("epoch", None)
    ex.load_trainable_state(state)
    for a, b in zip(leaves(ranks.numpy_tree(ex.model.params["mapper"])),
                    leaves(saved)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        loss = float(ex._loss(ranks._batch(run["union"])))
    assert abs(loss - restored[0]["restored_loss"]) <= 1e-6 * abs(loss)
    for a, b in zip(restored[0]["restored_mu"], ex.optimizer.mu):
        np.testing.assert_array_equal(a, b.numpy())
