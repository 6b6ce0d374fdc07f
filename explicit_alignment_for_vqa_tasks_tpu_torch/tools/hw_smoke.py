"""Hardware smoke: the product's flows through the port on the card.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/hw_smoke.py, on
the same synthetic fixtures (``e2e_fixtures``), with the two-layer T5 in
bf16 at the card's kernel widths (``e2e_fixtures.KERNEL_LM_CONFIG``):

  1. the few-shot VQA eval (data loading, module parser, prefix splice,
     the encoder through ``t5_attention_core``, greedy decode, VQA scoring,
     ``answers.pkl``), from a mapper checkpoint saved and loaded;
  2. the one-at-a-time encoder eval, and beam search (``num_beams=2``);
  3. prompt-permutation ensembles (3 permutations), looped
     (``tpu.ensemble_members_per_call`` 1) and batched (2): equal answers;
  4. Conceptual Captions mapper training for one epoch, ``model_00``
     written and loaded into a fresh executor, whose mapper equals the
     trained one;
  5. the int8 eval with deferred SmoothQuant calibration
     (``int8_encoder_ffn``, ``int8_encoder_attn``, ``int8_cross_kv``,
     ``int8_calibrate_batches=1``): pending before the run, the calibrated
     norms in place and every question answered after it.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.hw_smoke \\
        [--device cpu]

It ends with ``hw_smoke PASSED``; any failed check raises.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from ..trainers.checkpointing import save_checkpoint
from ..utils.device_stats import device_info
from . import e2e_fixtures

VAL_QUESTIONS = 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"hw_smoke: {msg}")


def eval_config(folder: Path, **additional: Any):
    """The fixtures' eval config at the kernel widths in bf16."""
    fixtures = e2e_fixtures.write_vqa_fixtures(folder,
                                               n_val_imgs=VAL_QUESTIONS)
    return e2e_fixtures.on_kernel_widths(
        e2e_fixtures.make_test_config(folder, fixtures, **additional))


def answers(config) -> List[Dict]:
    with open(os.path.join(config.results_path, "answers.pkl"), "rb") as fh:
        return pickle.load(fh)


def tested(executor) -> float:
    """``executor.test()``'s overall accuracy, checked to be a share."""
    metrics = executor.test()
    acc = metrics["test_evaluation/accuracy_overall"]
    check(0.0 <= acc <= 100.0, f"accuracy {metrics}")
    return acc


def flow_eval(dev: torch.device, folder: Path) -> dict:
    config = eval_config(folder)
    executor = e2e_fixtures.build_executor(config, device=dev)
    save_checkpoint(config.saved_model_path, 0, executor.trainable_state())
    executor.maybe_load_checkpoint()
    acc = tested(executor)
    n = len(answers(config))
    check(n == VAL_QUESTIONS, f"eval wrote {n} predictions")
    print(f"hw_smoke eval OK: accuracy_overall={acc:.2f}, predictions={n}",
          flush=True)
    return {"accuracy": acc, "predictions": n}


def flow_modes(dev: torch.device, folder: Path) -> dict:
    out = {}
    for name, additional in (
            ("one_at_a_time",
             {"pass_examples_through_encoder_one_at_a_time": 1}),
            ("beam", {"num_beams": 2})):
        config = eval_config(folder / name, **additional)
        out[name] = tested(e2e_fixtures.build_executor(config, device=dev))
        print(f"hw_smoke {name} eval OK", flush=True)
    return out


def flow_ensembles(dev: torch.device, folder: Path) -> dict:
    got = []
    for members in (1, 2):
        config = eval_config(folder / f"m{members}",
                             num_permutations_of_in_context_examples=3)
        config.tpu.ensemble_members_per_call = members
        tested(e2e_fixtures.build_executor(config, device=dev))
        got.append(answers(config))
    check(got[0] == got[1], "batched != looped ensembles")
    print("hw_smoke batched-ensembles eval OK (== looped)", flush=True)
    return {"predictions": len(got[0])}


def flow_train(dev: torch.device, folder: Path) -> dict:
    config = e2e_fixtures.on_kernel_widths(
        e2e_fixtures.make_cc_config(folder))
    config.train.epochs = 1
    executor = e2e_fixtures.build_executor(config, device=dev)
    executor.train()
    ckpt = os.path.join(config.saved_model_path, "model_00")
    check(os.path.isdir(ckpt), f"{ckpt} was not written")
    resumed = e2e_fixtures.build_executor(config, device=dev)
    resumed.maybe_load_checkpoint()
    trained, loaded = (e.model.params["mapper"] for e in (executor, resumed))
    check(all(torch.equal(trained[layer][k], loaded[layer][k])
              for layer in trained for k in trained[layer]),
          "the resumed executor's mapper differs from the trained one")
    check(resumed.current_epoch == 1,
          f"resumed at epoch {resumed.current_epoch}")
    print(f"hw_smoke train+resume OK ({config.data_loader.type})",
          flush=True)
    return {"steps": executor.global_step, "loader": config.data_loader.type}


def flow_int8(dev: torch.device, folder: Path) -> dict:
    config = eval_config(folder)
    for knob in ("fused_attention", "int8_encoder_ffn", "int8_encoder_attn",
                 "int8_cross_kv"):
        config.tpu[knob] = True
    config.tpu.int8_calibrate_batches = 1
    executor = e2e_fixtures.build_executor(config, device=dev)
    check(bool(executor.model.pending_int8_calibration),
          "no int8 calibration pending")
    acc = tested(executor)
    enc = executor.model.params["lm"]["encoder"]
    check("ln" in enc["ffn_q8"] and "ln" in enc["self_attn_q8"],
          "the calibrated norms are missing")
    n = len(answers(config))
    check(n == VAL_QUESTIONS, f"int8 eval wrote {n} predictions")
    print(f"hw_smoke int8 calibrated eval OK: accuracy_overall={acc:.2f}",
          flush=True)
    return {"accuracy": acc, "predictions": n}


FLOWS: Dict[str, Callable[[torch.device, Path], dict]] = {
    "eval": flow_eval, "modes": flow_modes, "ensembles": flow_ensembles,
    "train": flow_train, "int8": flow_int8,
}


def run(device: Optional[str] = None) -> dict:
    """The flows in order, each in a fresh temporary folder; what each
    checked."""
    dev = resolve_device(device)
    print(f"hw_smoke on: {device_info(dev)}", flush=True)
    out = {}
    for name, flow in FLOWS.items():
        with tempfile.TemporaryDirectory() as tmp:
            out[name] = flow(dev, Path(tmp))
    print("hw_smoke PASSED", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card unless given (cpu: plain versions)")
    return run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
