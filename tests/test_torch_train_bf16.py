"""Mapper training in bf16 (the shipped configs' compute and param dtype)
through the port's executor against the JAX package's, on the CPU at the
tiny T5_test size: one epoch on the same weights, every step's loss and
the validation loss within BF16_LOSS_REL (bf16 roundings in other orders;
tests/test_torch_train_e2e.py holds the fp32 run within 1e-5)."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (  # noqa: E402
    vct0_params_from_numpy,
)
from test_e2e import build_executor  # noqa: E402
from test_torch_train_e2e import (  # noqa: E402
    BATCH,
    N_TRAIN,
    configs,
    port_executor,
    record_losses,
    write_cc,
)

BF16_LOSS_REL = 2e-2
BF16_OPTS = ("tpu.compute_dtype=bfloat16", "tpu.params_dtype=bfloat16")


def test_bf16_train_losses_match_jax(tmp_path):
    write_cc(tmp_path)
    jconfig = configs(tmp_path, "jax", epochs=1, opts=BF16_OPTS)[0]
    tconfig = configs(tmp_path, "torch", epochs=1, opts=BF16_OPTS)[1]
    assert tconfig.tpu.compute_dtype == "bfloat16"
    jexec = build_executor(jconfig)
    texec = port_executor(tconfig)
    params = vct0_params_from_numpy(jax.tree.map(np.asarray,
                                                 jexec.model.params),
                                    torch.bfloat16, "cpu")
    assert texec.model.cfg.lm.dtype == torch.bfloat16
    texec.model.params["lm"] = params["lm"]
    texec.load_trainable_state({"mapper": params["mapper"]})
    jlosses, tlosses = record_losses(jexec), record_losses(texec)
    jexec.train()
    texec.train()
    assert len(tlosses) == len(jlosses) == N_TRAIN // BATCH
    np.testing.assert_allclose(tlosses, jlosses, rtol=BF16_LOSS_REL)
    metrics = []
    for config in (jconfig, tconfig):
        with open(os.path.join(config.saved_model_path,
                               "checkpoint_index.json")) as fh:
            metrics.append(json.load(fh)["best_metric"])
    np.testing.assert_allclose(metrics[1], metrics[0], rtol=BF16_LOSS_REL)
