"""The port's CLI (main.run) and checkpointing (trainers/checkpointing.py)
against the JAX package's, on the CPU at the tiny T5_test size: ``--mode
test`` writes an answers.pkl equal to the JAX package's main.run on the
same weights, data and seed, for SimpleTokenizer and the committed subword
fixture, with the JAX executor's metrics; ``--mode train`` on the few-shot
config stops with the JAX package's error and on ClipCap's config trains;
a multi-process launch raises with its ROADMAP item; torch checkpoints
keep the JAX package's index, aliases and resolution, an Orbax
checkpoint is refused with the name of its converter, and --mode test runs
from the converters' checkpoints."""

import json
import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu import main as jmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import checkpointing as jckpt  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import checkpointing as tckpt  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import few_shot_vqa_executor as texec  # noqa: E402
from test_e2e import (  # noqa: E402
    PREFIX_SIZE,
    REPO_ROOT,
    build_executor,
    make_test_config,
    use_fixture_tokenizer,
    write_vqa_fixtures,
)
from test_torch_clipcap_executor import clipcap_argv  # noqa: E402
from test_torch_eval_e2e import jax_params  # noqa: E402

LM_CONFIG = ("{'d_model':32,'d_kv':8,'num_heads':4,'d_ff':64,"
             "'num_encoder_layers':2,'num_decoder_layers':2,"
             "'relative_attention_num_buckets':8,"
             "'relative_attention_max_distance':16}")


def argv(tmp_path, fixtures, folder, *opts, mode="test"):
    """tests/test_e2e.py::TestCLITestMode's command line, with its own
    experiment and cache folders."""
    vqa_paths = (
        "{'question_files':{'train':'%s','val':'%s'},"
        "'annotation_files':{'train':'%s','val':'%s'}}"
    ) % (fixtures["train_q"], fixtures["val_q"],
         fixtures["train_a"], fixtures["val_a"])
    return [
        "configs/vqa2/few_shot_vqa_hotpotqa.jsonnet",
        "--mode", mode, "--experiment_name", "cli_test",
        "--num_shots", "2",
        "--in_context_examples_fpath", fixtures["rices"],
        "--disable_wandb", "--disable_tensorboard",
        "--opts",
        f"EXPERIMENT_FOLDER={tmp_path}/{folder}",
        f"TENSORBOARD_FOLDER={tmp_path}/{folder}_tb",
        f"cache.default_folder={tmp_path}/{folder}_cache",
        "model_config.TokenizerClass=SimpleTokenizer",
        "model_config.ConfigClass=T5_test",
        f"model_config.lm_config={LM_CONFIG}",
        "model_config.pretrained=0",
        f"model_config.model_args.prefix_size={PREFIX_SIZE}",
        "model_config.model_args.prefix_length=2",
        "tpu.compute_dtype=float32",
        "tpu.params_dtype=float32",
        "tpu.length_buckets=[64,128,256]",
        "data_loader.additional.max_source_length=256",
        "data_loader.additional.max_target_length=8",
        "data_loader.additional.num_workers_test=1",
        "valid.batch_size=2",
        "data_loader.dataset_modules.module_dict.LoadVQA2Data.config"
        f".vqa_data_path={vqa_paths}",
        "data_loader.dataset_modules.module_dict.LoadVQA2Data.config"
        f".image_data_path={{'train':'{tmp_path}','val':'{tmp_path}'}}",
        "data_loader.dataset_modules.module_dict.LoadClipEmbeddings"
        f".config={{'train':'{fixtures['embeddings']}',"
        f"'val':'{fixtures['embeddings']}'}}",
        *opts,
    ]


def saved_model(tmp_path, folder):
    return f"{tmp_path}/{folder}/cli_test/train/saved_model"


def read_answers(tmp_path, folder):
    path = f"{tmp_path}/{folder}/cli_test/test/test_evaluation/answers.pkl"
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture
def cli_env(monkeypatch):
    """main.run's initialization replaces the excepthook, the root
    logger's level and its console handler, all put back afterwards; the
    CLI's config paths are relative to the repo."""
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield monkeypatch
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.mark.parametrize("tokenizer", ["simple", "fixture"])
def test_cli_test_mode_equals_jax(tmp_path, cli_env, tokenizer):
    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=5)
    opts = []
    jconfig = make_test_config(tmp_path, fixtures)
    jconfig.data_loader.additional.num_workers_test = 1
    if tokenizer == "fixture":
        jconfig = use_fixture_tokenizer(jconfig)
        opts = ["model_config.TokenizerClass=T5TokenizerFast",
                "model_config.TokenizerModelVersion="
                f"{jconfig.model_config.TokenizerModelVersion}",
                "model_config.model_args.sentinel_base="
                f"{jconfig.model_config.model_args.sentinel_base}"]
    # the JAX executor on the same config: the weights both runs use (its
    # params come from the config's seed, as JAX's main.run builds them)
    jexecutor = build_executor(jconfig)
    jmetrics = jexecutor.test()
    params = jax_params(jexecutor)
    jckpt.save_checkpoint(saved_model(tmp_path, "jax"), 0,
                          jexecutor.trainable_state())
    tckpt.save_checkpoint(saved_model(tmp_path, "torch"), 0,
                          {"mapper": params["mapper"]})

    jmain.run(argv(tmp_path, fixtures, "jax", *opts))

    build = texec.build_model_from_config

    def carried(config, device=None):
        assert device == "cpu"
        model, kind = build(config, device=device)
        model.params["lm"] = params["lm"]
        return model, kind

    cli_env.setattr(texec, "build_model_from_config", carried)
    executor, metrics = tmain.run(argv(tmp_path, fixtures, "torch", *opts),
                                  device="cpu")
    want = read_answers(tmp_path, "jax")
    assert read_answers(tmp_path, "torch") == want
    assert len(want) == 5
    assert "test_evaluation/accuracy_overall" in metrics
    assert metrics == jmetrics
    assert executor.model.device.type == "cpu"
    assert os.path.isfile(f"{tmp_path}/torch/cli_test/config.json")
    assert os.path.isfile(f"{tmp_path}/torch/cli_test/test/info.log")


def test_cli_train_mode_raises(tmp_path, cli_env):
    """--mode train on the few-shot config: the eval executor's no-op
    training step over the VQA2 train split, whose questions the fixture's
    in-context file does not hold; the port stops where the JAX package
    does, with its error. On ClipCap's config the train run completes."""
    fixtures = write_vqa_fixtures(tmp_path)
    # a train run has no results_path: the sanity validation writes its
    # answers.pkl into the working directory (in both packages)
    cli_env.chdir(tmp_path)
    errors = []
    for folder, run in (("jax", jmain.run),
                        ("torch", lambda a: tmain.run(a, device="cpu"))):
        train_argv = argv(tmp_path, fixtures, folder, "train.epochs=1",
                          mode="train")
        train_argv[0] = os.path.join(REPO_ROOT, train_argv[0])
        with pytest.raises(KeyError) as raised:
            run(train_argv)
        errors.append(str(raised.value))
    assert errors[0] == errors[1]
    assert "no in-context examples for question" in errors[1]
    # ClipCap's executor is ported: its train run completes, one epoch
    # written as model_00 (tests/test_torch_clipcap_executor.py holds it
    # against the JAX package)
    executor, metrics = tmain.run(
        clipcap_argv(tmp_path, fixtures, "clip_cap", "train",
                     "train.epochs=1"), device="cpu")
    assert metrics == {} and executor.global_step > 0
    assert os.path.isfile(os.path.join(executor.config.saved_model_path,
                                       "model_00", "trainable_state.pt"))


def test_cli_refuses_more_than_one_process(tmp_path, cli_env):
    """A run over two processes trains or evaluates on a (data, model) mesh
    (tests/test_torch_dp_train.py, tests/test_torch_multiprocess_eval.py);
    the pipelined mesh (tpu.mesh.pipe > 1) over them raises before any
    process group or data, naming its ROADMAP item."""
    fixtures = write_vqa_fixtures(tmp_path)
    cli_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tmain.run(argv(tmp_path, fixtures, "torch", "tpu.mesh.pipe=2",
                       mode="train"), device="cpu")


def test_cli_without_checkpoint_raises(tmp_path, cli_env):
    fixtures = write_vqa_fixtures(tmp_path)
    with pytest.raises(FileNotFoundError, match="requires a checkpoint"):
        tmain.run(argv(tmp_path, fixtures, "torch"), device="cpu")


def mapper_state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"mapper": {"w": torch.randn(3, 4, generator=gen),
                       "b": torch.randn(4, generator=gen)}}


def test_checkpoint_round_trip_and_index_equal_jax(tmp_path):
    path = str(tmp_path / "saved")
    for epoch, metric in ((0, 2.0), (1, 1.0), (2, 3.0)):
        tckpt.save_checkpoint(path, epoch, mapper_state(epoch),
                              metric_value=metric, metric_mode="min")
    for epoch in range(3):
        state = tckpt.load_checkpoint(os.path.join(path, f"model_{epoch:02d}"))
        assert state.pop("epoch") == epoch
        want = mapper_state(epoch)["mapper"]
        assert sorted(state["mapper"]) == sorted(want)
        for key in want:
            assert torch.equal(state["mapper"][key], want[key])
    with open(os.path.join(path, "checkpoint_index.json")) as fh:
        index = json.load(fh)
    assert index == {"epochs": ["model_00", "model_01", "model_02"],
                     "best": "model_01", "best_metric": 1.0,
                     "last": "model_02"}
    for kwargs in ({}, {"load_best_model": True}, {"load_epoch": 0},
                   {"load_epoch": 7}, {"load_model_path": "/x/model_05"},
                   {"load_best_model": True, "load_epoch": 2}):
        got = tckpt.get_checkpoint_model_path(path, **kwargs)
        assert got == jckpt.get_checkpoint_model_path(path, **kwargs)
    assert tckpt.get_checkpoint_model_path(str(tmp_path / "none")) is None


def test_orbax_checkpoint_is_refused(tmp_path):
    path = jckpt.save_checkpoint(
        str(tmp_path / "saved"), 0,
        {"mapper": {"w": np.ones((2, 2), np.float32)}})
    assert tckpt.get_checkpoint_model_path(str(tmp_path / "saved")) == path
    with pytest.raises(ValueError, match="convert_orbax_checkpoint"):
        tckpt.load_checkpoint(path)


@pytest.mark.parametrize("converter", ["orbax", "reference"])
def test_cli_test_mode_loads_converted_checkpoints(tmp_path, cli_env,
                                                   converter):
    """main --mode test from a checkpoint the port converted: a JAX Orbax
    checkpoint (mapper, optax state, epoch) through
    tools/convert_orbax_checkpoint.py, or a reference Lightning checkpoint
    through tools/convert_reference_checkpoint.py. The run loads the
    mapper bit for bit and answers every question."""
    import jax.numpy as jnp
    import optax

    from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (
        convert_orbax_checkpoint,
        convert_reference_checkpoint,
    )

    fixtures = write_vqa_fixtures(tmp_path, n_val_imgs=5)
    saved = saved_model(tmp_path, "torch")
    gen = torch.Generator().manual_seed(6)
    hidden, width = 32, 64         # the config's mlp: d_model 32, 2 prefixes
    mapper = {"fc1": {"w": torch.randn(PREFIX_SIZE, hidden, generator=gen),
                      "b": torch.randn(hidden, generator=gen)},
              "fc2": {"w": torch.randn(hidden, width, generator=gen),
                      "b": torch.randn(width, generator=gen)}}
    if converter == "orbax":
        params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), mapper)
        jckpt.save_checkpoint(str(tmp_path / "jax_saved"), 0, {
            "mapper": params, "opt_state": optax.adamw(1e-3).init(params),
            "epoch": np.asarray(0)})
        convert_orbax_checkpoint.convert(str(tmp_path / "jax_saved"), saved)
    else:
        ckpt = str(tmp_path / "model_00.ckpt")
        torch.save({"state_dict": {
            f"model.clip_project.model.{i}.{kind}":
                mapper[layer]["w"].T if kind == "weight" else mapper[layer]["b"]
            for i, layer in ((0, "fc1"), (2, "fc2"))
            for kind in ("weight", "bias")}}, ckpt)
        convert_reference_checkpoint.convert(ckpt, "mlp",
                                             f"{saved}/model_00")
    executor, metrics = tmain.run(argv(tmp_path, fixtures, "torch"),
                                  device="cpu")
    for name, layer in mapper.items():
        for key, want in layer.items():
            assert torch.equal(executor.model.params["mapper"][name][key],
                               want)
    assert len(read_answers(tmp_path, "torch")) == 5
    assert "test_evaluation/accuracy_overall" in metrics
