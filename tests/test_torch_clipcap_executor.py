"""The port's ClipCapExecutor against the JAX package's, on the CPU at
tests/test_e2e.py::TestClipCapEndToEnd's tiny settings (GPT2_test, 32
wide, 2 layers, fp32, SimpleTokenizer, buckets [32, 64]) on
configs/vqa2/clip_cap.jsonnet: per-step losses and the trained mapper
within 1e-5 on the JAX executor's weights (carried with convert.py), the
checkpoints, a checkpoint loaded back, answers.pkl and the test metrics
equal; ``_answer_labels`` on its edge rows and the resized token table,
each as one parametrised test; and ``main --mode train`` then ``--mode
test`` through the port's CLI."""

import logging
import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu import main as jmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    checkpointing as jckpt,
)
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    clipcap_executor as jexecutor,
)
from explicit_alignment_for_vqa_tasks_tpu.utils.config_system import (  # noqa: E402
    process_config as jprocess_config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    clipcap_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.registry import (  # noqa: E402
    DATA_LOADERS,
    EXECUTORS,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    clipcap_executor as texecutor,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers.optimization import (  # noqa: E402
    tree_leaves,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.config_system import (  # noqa: E402
    process_config as tprocess_config,
)
from test_e2e import PREFIX_SIZE, REPO_ROOT, build_executor, write_vqa_fixtures  # noqa: E402

CLIP_CAP = os.path.join(REPO_ROOT, "configs", "vqa2", "clip_cap.jsonnet")
# fp32 on both sides: losses and mappers within REL of the largest value
REL = 1e-5
LM_CONFIG = ("{'vocab_size':33000,'n_positions':128,'d_model':32,"
             "'num_layers':2,'num_heads':4}")
EPOCHS, ACCUMULATE = 2, 2


def clipcap_argv(tmp_path, fixtures, folder, mode="train", *opts):
    """tests/test_e2e.py::TestClipCapEndToEnd's settings as a command
    line (2 epochs, the mean of 2 micro-steps an update), with its own
    experiment and cache folders; the loaders collate on one thread."""
    vqa_paths = (
        "{'question_files':{'train':'%s','val':'%s'},"
        "'annotation_files':{'train':'%s','val':'%s'}}"
    ) % (fixtures["train_q"], fixtures["val_q"],
         fixtures["train_a"], fixtures["val_a"])
    return [
        CLIP_CAP, "--mode", mode, "--experiment_name", "clipcap",
        "--disable_wandb", "--disable_tensorboard", "--opts",
        f"EXPERIMENT_FOLDER={tmp_path}/{folder}",
        f"TENSORBOARD_FOLDER={tmp_path}/{folder}_tb",
        f"cache.default_folder={tmp_path}/{folder}_cache",
        "model_config.TokenizerClass=SimpleTokenizer",
        "model_config.ConfigClass=GPT2_test",
        f"model_config.lm_config={LM_CONFIG}",
        "model_config.pretrained=0",
        f"model_config.model_args.prefix_size={PREFIX_SIZE}",
        "model_config.model_args.prefix_length=2",
        "tpu.compute_dtype=float32", "tpu.params_dtype=float32",
        "tpu.length_buckets=[32,64]",
        "data_loader.additional.max_source_length=64",
        "data_loader.additional.max_decoder_source_length=64",
        "data_loader.additional.max_target_length=8",
        "data_loader.additional.num_workers=1",
        "data_loader.additional.num_workers_test=1",
        f"train.epochs={EPOCHS}", "train.batch_size=2", "valid.batch_size=2",
        "valid.step_size=0",
        f"train.additional.gradient_accumulation_steps={ACCUMULATE}",
        "data_loader.dataset_modules.module_dict.LoadVQA2Data.config"
        f".vqa_data_path={vqa_paths}",
        "data_loader.dataset_modules.module_dict.LoadVQA2Data.config"
        f".image_data_path={{'train':'{tmp_path}','val':'{tmp_path}'}}",
        "data_loader.dataset_modules.module_dict.LoadClipEmbeddings"
        f".config={{'train':'{fixtures['embeddings']}',"
        f"'val':'{fixtures['embeddings']}'}}",
        *opts,
    ]


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


def read_answers(path):
    with open(os.path.join(path, "answers.pkl"), "rb") as fh:
        return pickle.load(fh)


def test_train_and_test_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    fixtures = write_vqa_fixtures(tmp_path)
    # the config's learning rate without its 5000 warmup steps, so that
    # the 3 updates move the mapper
    fast = ("train.additional.warmup_steps=1",)
    jconfig = jprocess_config(jmain.parse_args_sys(
        clipcap_argv(tmp_path, fixtures, "jax", "train", *fast)))
    tconfig = tprocess_config(tmain.parse_args_sys(
        clipcap_argv(tmp_path, fixtures, "torch", "train", *fast)))
    for config, folder in ((jconfig, "jax"), (tconfig, "torch")):
        config.results_path = str(tmp_path / f"{folder}_results")
    jexec = build_executor(jconfig)
    texec = port_executor(tconfig)
    assert texec.tokenizer.pad_token_id == jexec.tokenizer.pad_token_id
    params = clipcap_params_from_numpy(
        jax.tree.map(np.asarray, jexec.model.params), torch.float32, "cpu")
    texec.model.params["lm"] = params["lm"]
    texec.load_trainable_state({"mapper": params["mapper"]})
    initial = [t.detach().clone()
               for t in tree_leaves(texec.model.params["mapper"])]
    jlosses, tlosses = record_losses(jexec), record_losses(texec)
    jexec.train()
    texec.train()
    steps = EPOCHS * len(texec.train_dataloader)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)
    assert texec.optimizer.applied == steps // ACCUMULATE
    assert_tree_close(texec.model.params["mapper"],
                      jexec.model.params["mapper"])
    moved = max(float(np.abs(np.asarray(want) - start.numpy()).max())
                for want, start in zip(tree_leaves(
                    jexec.model.params["mapper"]), initial))
    assert moved > 1e-5
    # the checkpoints: the same epochs; each mapper within REL of JAX's
    for epoch in range(EPOCHS):
        name = f"model_{epoch:02d}"
        got = tckpt.load_checkpoint(os.path.join(tconfig.saved_model_path,
                                                 name))
        want = jckpt.load_checkpoint(os.path.join(jconfig.saved_model_path,
                                                  name))
        assert int(got["epoch"]) == int(np.asarray(want["epoch"])) == epoch
        assert_tree_close(got["mapper"], want["mapper"])
    # the last checkpoint loads back into a fresh executor
    fresh = port_executor(tconfig)
    fresh.model.params["lm"] = params["lm"]
    assert fresh.maybe_load_checkpoint().endswith(f"model_{EPOCHS - 1:02d}")
    for got, want in zip(tree_leaves(fresh.model.params["mapper"]),
                         tree_leaves(texec.model.params["mapper"])):
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
    # the eval: the same answers.pkl and metrics
    jconfig.mode = tconfig.mode = "test"
    jmetrics, tmetrics = jexec.test(), texec.test()
    assert "test_evaluation/accuracy_overall" in tmetrics
    assert tmetrics == jmetrics
    want = read_answers(jconfig.results_path)
    assert read_answers(tconfig.results_path) == want
    assert len(want) == 4


LABEL_ROWS = {
    # right padding after the answer: the first pad is the EOS target
    "right_padded": [5, 6, 9, 7, 8, 0, 0, 0],
    # left padding: the pads before the BOS stay masked
    "left_padded": [0, 0, 5, 9, 7, 8, 0, 0],
    # no BOS: the whole row is masked
    "no_bos": [5, 6, 7, 8, 0, 0, 0, 0],
    # no pad: every token after the BOS is a target
    "no_pad": [5, 9, 7, 8, 6, 5, 7, 8],
    # two BOS: the first one counts
    "two_bos": [5, 9, 7, 9, 8, 0, 0, 0],
    # the BOS last
    "bos_last": [5, 6, 7, 8, 6, 5, 7, 9],
}


@pytest.mark.parametrize("row", sorted(LABEL_ROWS))
def test_answer_labels_match_jax(row):
    ids = np.asarray([LABEL_ROWS[row], LABEL_ROWS["right_padded"]],
                     dtype=np.int32)
    fake = SimpleNamespace(tokenizer=SimpleNamespace(pad_token_id=0,
                                                     bos_token_id=9))
    want = jexecutor.ClipCapExecutor._answer_labels(fake, ids)
    got = texecutor.answer_labels(ids, pad_id=0, bos_id=9)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [0, 1, 5])
def test_resized_wte_matches_jax(extra, dtype):
    """The tied table grown by the JAX package's numpy draws, in wpe's
    dtype; the config's vocab_size follows; no growth without new
    tokens."""
    from explicit_alignment_for_vqa_tasks_tpu.models import (
        clipcap as jcc,
        gpt2 as jgpt2,
    )
    from explicit_alignment_for_vqa_tasks_tpu.models.mappers import (
        MapperConfig as JMapperConfig,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import (
        clipcap as tcc,
        gpt2 as tgpt2,
    )
    from explicit_alignment_for_vqa_tasks_tpu_torch.models.mappers import (
        MapperConfig,
    )

    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jcc.ClipCapConfig(lm=jgpt2.GPT2Config.small_test(),
                             mapper=JMapperConfig(d_model=32))
    tree = jcc.init_clipcap_params(jax.random.PRNGKey(0), jcfg,
                                   param_dtype=jdtype)
    vocab = jcfg.lm.vocab_size
    jself = SimpleNamespace(
        tokenizer=_Sized(vocab + extra),
        model=SimpleNamespace(cfg=jcfg, params=tree))
    tparams = clipcap_params_from_numpy(jax.tree.map(np.asarray, tree),
                                        tdtype, "cpu")
    tself = SimpleNamespace(
        tokenizer=_Sized(vocab + extra),
        model=SimpleNamespace(
            cfg=tcc.ClipCapConfig(lm=tgpt2.GPT2Config.small_test(),
                                  mapper=MapperConfig(d_model=32)),
            params=tparams))
    jexecutor.ClipCapExecutor._maybe_resize_embeddings(jself)
    texecutor.ClipCapExecutor._maybe_resize_embeddings(tself)
    got = tself.model.params["lm"]["wte"]
    want = np.asarray(jself.model.params["lm"]["wte"]).astype(np.float32)
    assert got.dtype == tdtype
    assert tuple(got.shape) == want.shape == (vocab + extra, 32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert tself.model.cfg.lm.vocab_size == jself.model.cfg.lm.vocab_size \
        == vocab + extra


def test_cli_train_then_test(tmp_path, monkeypatch):
    """``main --mode train`` on clip_cap.jsonnet, then ``--mode test`` from
    its last checkpoint, through the port's CLI on the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        fixtures = write_vqa_fixtures(tmp_path)
        executor, metrics = tmain.run(
            clipcap_argv(tmp_path, fixtures, "cli", "train", "train.epochs=1"),
            device="cpu")
        assert metrics == {}
        assert isinstance(executor, texecutor.ClipCapExecutor)
        saved = executor.config.saved_model_path
        assert os.path.isfile(os.path.join(saved, "model_00",
                                           "trainable_state.pt"))
        trained = [t.detach().clone()
                   for t in tree_leaves(executor.model.params["mapper"])]
        executor, metrics = tmain.run(
            clipcap_argv(tmp_path, fixtures, "cli", "test"), device="cpu")
        assert "test_evaluation/accuracy_overall" in metrics
        # the test run's mapper is the trained one, from model_00
        for got, want in zip(tree_leaves(executor.model.params["mapper"]),
                             trained):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        answers = read_answers(executor.config.results_path)
        assert len(answers) == 4
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
