"""The port's CLI (main.run --mode train) on the shipped Conceptual
Captions config against the JAX package's main.run, on the same weights
(the port's model factory wrapped to carry the JAX model's), at the tiny
T5_test size in fp32: the checkpoint index and model_00's mapper; and
tools/bench_train.py on the CPU at small widths: the JAX bench's metric
names and config keys, a finite loss, every clock read after a
synchronize."""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu import main as jmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    checkpointing as jckpt,
)
from explicit_alignment_for_vqa_tasks_tpu.trainers.model_factory import (  # noqa: E402
    build_model_from_config as jbuild_model,
)
from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models.t5 import (  # noqa: E402
    T5Config,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    bench_train,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    checkpointing as tckpt,
    vct0_executor,
)
from test_torch_train_e2e import (  # noqa: E402
    REL,
    assert_tree_close,
    cc_argv,
    write_cc,
)
from test_e2e import REPO_ROOT  # noqa: E402


@pytest.fixture
def cli_env(monkeypatch):
    """main.run's initialization replaces the excepthook and the root
    logger's level and handlers, all put back afterwards."""
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield monkeypatch
    root.handlers[:] = handlers
    root.setLevel(level)


def test_cli_train_matches_jax(tmp_path, cli_env):
    write_cc(tmp_path)
    jargv = cc_argv(tmp_path, "jax", epochs=1, accumulate=2)
    jmain.run(jargv)
    jconfig = jmain.process_config(jmain.parse_args_sys(jargv))
    params = vct0_params_from_numpy(
        jax.tree.map(np.asarray, jbuild_model(jconfig)[0].params),
        torch.float32, "cpu")
    build = vct0_executor.build_model_from_config

    def carried(config, device=None):
        assert device == "cpu"
        model, kind = build(config, device=device)
        model.params["lm"] = params["lm"]
        for name, layer in params["mapper"].items():
            for key, value in layer.items():
                model.params["mapper"][name][key] = value.clone()
        return model, kind

    cli_env.setattr(vct0_executor, "build_model_from_config", carried)
    executor, metrics = tmain.run(
        cc_argv(tmp_path, "torch", epochs=1, accumulate=2), device="cpu")
    assert metrics == {} and executor.optimizer.applied == 2
    assert executor.model.device.type == "cpu"
    saved = {}
    for folder in ("jax", "torch"):
        path = f"{tmp_path}/{folder}/cc/train/saved_model"
        with open(f"{path}/checkpoint_index.json") as fh:
            saved[folder] = (path, json.load(fh))
    (jpath, jindex), (tpath, tindex) = saved["jax"], saved["torch"]
    assert tindex["epochs"] == jindex["epochs"] == ["model_00"]
    np.testing.assert_allclose(tindex["best_metric"], jindex["best_metric"],
                               rtol=REL)
    assert_tree_close(tckpt.load_checkpoint(f"{tpath}/model_00")["mapper"],
                      jckpt.load_checkpoint(f"{jpath}/model_00")["mapper"])
    assert os.path.isfile(f"{tmp_path}/torch/cc/config.json")
    assert os.path.isfile(f"{tmp_path}/torch/cc/train/info.log")


def root_bench_source() -> str:
    with open(os.path.join(REPO_ROOT, "bench_train.py")) as fh:
        return fh.read()


@pytest.mark.parametrize("model,base,keys", [
    ("vct0", T5Config.small_test(), "fused_attention"),
    ("clipcap", GPT2Config.small_test(), "fused_block")])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_bench_train_on_the_cpu(monkeypatch, model, base, keys, fused):
    events = []
    monkeypatch.setattr(bench_train, "synchronize",
                        lambda dev: events.append("sync"))
    clock = iter(range(100))

    class Time:
        @staticmethod
        def perf_counter():
            events.append("clock")
            return float(next(clock))

    monkeypatch.setattr(bench_train, "time", Time)
    args = bench_train.build_parser().parse_args(
        ["--model", model, "--batch", "4", "--caption_len", "8", "--steps",
         "2", "--fused_attention", fused])
    result = bench_train.bench(args, base, device="cpu")
    source = root_bench_source()
    assert f'"metric": "{result["metric"]}"' in source
    assert result["metric"] == bench_train.METRICS[model]
    assert set(result["config"]) == {"batch", "caption_len",
                                     "prefix_length", "final_loss", keys}
    for key in result["config"]:
        assert f'"{key}"' in source
    assert result["config"][keys] is (fused == "1")
    assert np.isfinite(result["config"]["final_loss"])
    assert result["value"] > 0 and result["device"]["name"] == "cpu"
    assert events.count("clock") == 4
    assert all(events[i - 1] == "sync" for i, e in enumerate(events)
               if e == "clock")
