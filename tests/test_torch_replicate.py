"""The port's replication dryrun on the CPU (tools/replicate_dryrun.py
--modes main --shots 0 --no-int8: the tiny HF T5, the reference-style
mapper .ckpt converted by the port, the fixture tokenizer), its hotpotqa
point held against JAX's _run_point on the same artifacts: the same
answers.pkl and accuracies."""

import json
import os
import pickle

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("transformers")

from explicit_alignment_for_vqa_tasks_tpu.tools import (  # noqa: E402
    replicate_baseline as j_rb,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (  # noqa: E402
    replicate_dryrun,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_point_equals_jax(tmp_path):
    os.chdir(REPO)
    work = tmp_path / "dry"
    rc = replicate_dryrun.main(["--workdir", str(work), "--modes", "main",
                                "--shots", "0", "--no-int8"], device="cpu")
    assert rc == 0
    report = json.loads((work / "dryrun_report.json").read_text())
    assert [(r["template"], r["num_shots"]) for r in report["rows"]] == [
        ("hotpotqa", 0), ("frozen", 0)]
    assert not report["random_mapper"]
    for row in report["rows"]:
        assert row["questions"] == 4 and 0.0 <= row["accuracy"] <= 100.0
        assert row["reference"] == j_rb.BASELINE_NUMBERS[
            (row["template"], 0)]
        assert row["verdict"] in ("PASS", "FAIL")
    # the port's mapper: the converted reference .ckpt
    assert (work / "run" / "converted_mapper" / "trainable_state.pt").exists()

    # JAX's harness on the same artifacts (written again from the same
    # seeds), in a workdir of its own
    args = j_rb.parse_args(replicate_dryrun.build_dryrun_argv(
        str(work), modes=["main"], int8=False, shots=[0]))
    args.workdir = str(tmp_path / "jax_run")
    config = j_rb._build_config(
        "hotpotqa", 0, args, j_rb._lm_config_from_hf_dir(args.t0_weights),
        j_rb._resolve_mapper_ckpt(args.mapper_ckpt, args.mapping_type,
                                  args.workdir),
        j_rb._sentinel_base(args.t0_weights))
    point = j_rb._run_point(config)
    row = report["rows"][0]
    assert row["accuracy"] == point["accuracy_overall"]
    with open(os.path.join(config.results_path, "answers.pkl"), "rb") as fh:
        want = pickle.load(fh)
    port_results = (work / "run" / "experiments" / "replicate_main_hotpotqa_k0"
                    / "results" / "answers.pkl")
    assert pickle.loads(port_results.read_bytes()) == want
    assert len(want) == 4
