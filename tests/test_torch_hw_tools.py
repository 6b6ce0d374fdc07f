"""The port's eval_pipeline_bench and hw_smoke on the CPU at the fixtures'
sizes (the two-layer T5 at the card's kernel widths, their plain versions
here), and every new tool's device rule: on the card unless --device cpu is
given, raising without one."""

import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (
    eval_pipeline_bench,
    hw_smoke,
    train_step_study,
    vit_b_study,
    vit_l_study,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import vct0_executor


def test_eval_pipeline_bench_orders_agree():
    """Both orders over all 32 questions in 16 batches; the tool raises
    when their predictions differ, and a warm run's too."""
    out = eval_pipeline_bench.main(["--device", "cpu"])
    assert out["batches"] == 16 and out["predictions"] == 32
    assert out["value"] == out["serial_ms"] / out["pipelined_ms"]
    assert out["device"] == {"name": "cpu", "power_limit": None}


def test_pipelined_order_dispatches_before_collecting():
    """JAX's one-deep order: batch N+1 dispatched before batch N is
    collected, every batch collected once, in order."""
    calls = []

    class Recorder:
        test_dataloader = ["b0", "b1", "b2"]

        def _dispatch_generative(self, batch, i):
            calls.append(("dispatch", i))
            return i

        def _collect_generative(self, state):
            calls.append(("collect", state))
            return {"predictions": [state]}

    out = eval_pipeline_bench.run_pipelined(Recorder())
    assert [o["predictions"] for o in out] == [[0], [1], [2]]
    assert calls == [("dispatch", 0), ("dispatch", 1), ("collect", 0),
                     ("dispatch", 2), ("collect", 1), ("collect", 2)]


def test_hw_smoke_passes(capsys):
    """The five flows: each checks itself (answers.pkl coverage, looped ==
    batched ensembles, the resumed executor's mapper equal to the trained
    one, the int8 calibration) and raises on a miss."""
    out = hw_smoke.main(["--device", "cpu"])
    assert list(out) == list(hw_smoke.FLOWS)
    assert out["eval"]["predictions"] == hw_smoke.VAL_QUESTIONS
    assert out["int8"]["predictions"] == hw_smoke.VAL_QUESTIONS
    assert out["ensembles"]["predictions"] == hw_smoke.VAL_QUESTIONS
    assert out["train"]["steps"] == 3
    # pyarrow imports here: the shipped loader reads the parquet rows
    assert out["train"]["loader"] == "DataLoaderConceptualCaptions"
    assert capsys.readouterr().out.rstrip().endswith("hw_smoke PASSED")


def test_hw_smoke_train_flow_checks_the_resumed_mapper(tmp_path,
                                                       monkeypatch):
    """A resumed mapper that differs from the trained one fails the flow."""
    load = vct0_executor.VCT0Executor.load_trainable_state

    def perturbed(self, state):
        load(self, state)
        leaf = next(iter(next(iter(self.model.params["mapper"].values()))
                         .values()))
        with torch.no_grad():
            leaf.add_(1.0)

    monkeypatch.setattr(vct0_executor.VCT0Executor, "load_trainable_state",
                        perturbed)
    with pytest.raises(RuntimeError, match="resumed executor's mapper"):
        hw_smoke.flow_train(torch.device("cpu"), tmp_path)


@pytest.mark.parametrize("tool", [
    train_step_study, vit_b_study, vit_l_study, eval_pipeline_bench,
    hw_smoke])
def test_tools_need_a_card_unless_told_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
