"""Mapper training through the port's executor against the JAX package's,
on the CPU at the tiny T5_test size in fp32: the Conceptual Captions
loader's batches (parquet written with pyarrow), VCT0Executor.train() for
2 epochs on the same weights (carried with convert.py) with its per-step
losses, checkpoint index, model_00 / model_01 and final mapper, and a run
resumed from model_00 against the uninterrupted one.

Both packages' SimpleTokenizers number words in the order they first meet
them. The val split (2 batches) holds every word of the train split, so
the two-batch sanity validation before training numbers them all, in the
same order on both sides; the loaders collate on one thread each."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu import main as jmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    checkpointing as jckpt,
)
from explicit_alignment_for_vqa_tasks_tpu.utils.config_system import (  # noqa: E402
    process_config as jprocess_config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import (  # noqa: E402
    DATA_LOADERS,
    EXECUTORS,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.optimization import (  # noqa: E402
    tree_leaves,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.config_system import (  # noqa: E402
    process_config as tprocess_config,
)
from test_e2e import REPO_ROOT, build_executor  # noqa: E402

PREFIX_SIZE = 16
CC_CONFIG = os.path.join(REPO_ROOT, "configs", "conceptual_captions",
                         "conceptual_captions.jsonnet")
LM_CONFIG = ("{'d_model':32,'d_kv':8,'num_heads':4,'d_ff':64,"
             "'num_encoder_layers':2,'num_decoder_layers':2,"
             "'relative_attention_num_buckets':8,"
             "'relative_attention_max_distance':16}")
# fp32 on both sides: losses, index metrics and mappers within REL
REL = 1e-5
N_TRAIN, N_VAL, BATCH = 16, 8, 4


def write_cc(tmp_path):
    """16 train rows whose captions reuse the 8 val rows' words."""
    rng = np.random.default_rng(1)

    def table(n):
        return pa.table({
            "image_url": [[f"http://img/{i}"] for i in range(n)],
            "caption": [[f"a photo of object {i % N_VAL} ."]
                        for i in range(n)],
            "clip_embeddings": [
                rng.standard_normal(PREFIX_SIZE).astype(np.float32).tolist()
                for _ in range(n)],
        })

    pq.write_table(table(N_TRAIN), tmp_path / "cc_train.parquet")
    pq.write_table(table(N_VAL), tmp_path / "cc_val.parquet")


def cc_argv(tmp_path, folder, *opts, epochs=2, accumulate=3):
    return [
        CC_CONFIG, "--mode", "train", "--experiment_name", "cc",
        "--disable_wandb", "--disable_tensorboard", "--opts",
        f"EXPERIMENT_FOLDER={tmp_path}/{folder}",
        f"TENSORBOARD_FOLDER={tmp_path}/{folder}_tb",
        f"cache.default_folder={tmp_path}/{folder}_cache",
        "model_config.TokenizerClass=SimpleTokenizer",
        "model_config.ConfigClass=T5_test",
        f"model_config.lm_config={LM_CONFIG}",
        "model_config.pretrained=0",
        f"model_config.model_args.prefix_size={PREFIX_SIZE}",
        "model_config.model_args.prefix_length=2",
        "tpu.compute_dtype=float32", "tpu.params_dtype=float32",
        f"train.epochs={epochs}", f"train.batch_size={BATCH}",
        f"valid.batch_size={BATCH}", "valid.step_size=0",
        f"train.additional.gradient_accumulation_steps={accumulate}",
        "data_loader.additional.max_target_length=4",
        "data_loader.additional.num_workers=1",
        "data_loader.additional.num_workers_test=1",
        "data_loader.dataset_modules.module_dict.LoadConceptualCaptions"
        f".config.train={tmp_path}/cc_train.parquet",
        "data_loader.dataset_modules.module_dict.LoadConceptualCaptions"
        f".config.val={tmp_path}/cc_val.parquet",
        *opts,
    ]


def configs(tmp_path, folder, opts=(), **kw):
    argv = cc_argv(tmp_path, folder, *opts, **kw)
    return (jprocess_config(jmain.parse_args_sys(argv)),
            tprocess_config(tmain.parse_args_sys(argv)))


def port_executor(config):
    loader = DATA_LOADERS.get(config.data_loader.type)(config)
    loader.build_dataset()
    loader.set_dataloader()
    return EXECUTORS.get(config.train.type)(config, loader, device="cpu")


def record_losses(executor):
    losses = []
    step = executor.training_step

    def recording(batch, batch_idx):
        out = step(batch, batch_idx)
        losses.append(float(out["loss"]))
        return out

    executor.training_step = recording
    return losses


def assert_tree_close(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL * np.abs(w).max()


def test_cc_loader_batches_match_jax(tmp_path):
    write_cc(tmp_path)
    jconfig, tconfig = configs(tmp_path, "loader")
    from explicit_alignment_for_vqa_tasks_tpu.registry import (
        DATA_LOADERS as JDATA_LOADERS,
    )
    loaders = []
    for registry, config in ((JDATA_LOADERS, jconfig),
                             (DATA_LOADERS, tconfig)):
        loader = registry.get(config.data_loader.type)(config)
        loader.build_dataset()
        loader.set_dataloader()
        loaders.append(loader)
    jl, tl = loaders
    assert len(tl.train_dataloader) == N_TRAIN // BATCH
    assert len(tl.test_dataloader) == N_VAL // BATCH
    for epoch in (0, 1):
        batches = []
        for loader in (jl, tl):
            loader.train_dataloader.set_epoch(epoch)
            batches.append(list(loader.test_dataloader)
                           + list(loader.train_dataloader))
        for jb, tb in zip(*batches):
            assert tb.image_urls == jb.image_urls
            assert tb.captions == jb.captions
            for key in ("clip_embeddings", "labels", "labels_attention_mask"):
                np.testing.assert_array_equal(tb[key], jb[key])
            assert (tb.labels == -100).any() or tb.labels.shape[1] == 32


def test_train_matches_jax(tmp_path):
    """2 epochs of 4 steps, the mean of 3 micro-steps' gradients a
    applied update, on the JAX executor's weights."""
    write_cc(tmp_path)
    jconfig = configs(tmp_path, "jax")[0]
    tconfig = configs(tmp_path, "torch")[1]
    jexec = build_executor(jconfig)
    texec = port_executor(tconfig)
    params = vct0_params_from_numpy(jax.tree.map(np.asarray,
                                                 jexec.model.params),
                                    torch.float32, "cpu")
    texec.model.params["lm"] = params["lm"]
    texec.load_trainable_state({"mapper": params["mapper"]})
    jlosses, tlosses = record_losses(jexec), record_losses(texec)
    jexec.train()
    texec.train()
    assert len(tlosses) == 2 * N_TRAIN // BATCH
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)
    assert texec.optimizer.applied == 2 * N_TRAIN // BATCH // 3
    indexes = []
    for config in (jconfig, tconfig):
        with open(os.path.join(config.saved_model_path,
                               "checkpoint_index.json")) as fh:
            indexes.append(json.load(fh))
    jindex, tindex = indexes
    assert tindex["epochs"] == jindex["epochs"] == ["model_00", "model_01"]
    assert tindex["last"] == jindex["last"] and \
        tindex["best"] == jindex["best"]
    np.testing.assert_allclose(tindex["best_metric"], jindex["best_metric"],
                               rtol=REL)
    for name in ("model_00", "model_01"):
        want = jckpt.load_checkpoint(os.path.join(jconfig.saved_model_path,
                                                  name))
        got = tckpt.load_checkpoint(os.path.join(tconfig.saved_model_path,
                                                 name))
        assert int(got["epoch"]) == int(np.asarray(want["epoch"]))
        assert_tree_close(got["mapper"], want["mapper"])
        assert set(got["opt_state"]) == {"mu", "nu", "acc", "mini_step",
                                         "applied"}
    assert_tree_close(texec.model.params["mapper"],
                      jexec.model.params["mapper"])


def test_resume_from_model_00_equals_the_uninterrupted_run(tmp_path):
    """One epoch, a new executor resuming from model_00 for the second
    (the optimizer mid-accumulation at the break: 4 steps, k = 3): the
    final mapper and optimizer state equal those of 2 epochs in one run."""
    write_cc(tmp_path)
    whole = port_executor(configs(tmp_path, "whole")[1])
    whole.train()
    first = port_executor(configs(tmp_path, "parts", epochs=1)[1])
    first.train()
    assert first.optimizer.mini_step == 1
    resumed = port_executor(configs(tmp_path, "parts")[1])
    assert resumed.maybe_load_checkpoint().endswith("model_00")
    assert resumed.current_epoch == 1
    resumed.train()
    for got, want in zip(tree_leaves(resumed.model.params["mapper"]),
                         tree_leaves(whole.model.params["mapper"])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    state, want = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert (state["applied"], state["mini_step"]) == (want["applied"],
                                                      want["mini_step"])
    for got, w in zip(state["nu"], want["nu"]):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
