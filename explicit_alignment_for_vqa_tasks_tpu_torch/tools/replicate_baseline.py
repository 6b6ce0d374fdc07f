"""One-command replication of the reference's published VQA2 numbers.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/replicate_baseline.py.
The reference's value is its published few-shot VQA2 accuracies
(reference: src/tools/plots_for_report.ipynb cells 2-7, in BASELINE.md).
Once T0-3B weights and the VQA2 artifacts are mounted, this is the check a
user runs, on the card unless ``--device cpu`` is given:

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.replicate_baseline \
        --t0-weights  $EAVT_T0_WEIGHTS            # HF dir incl. tokenizer \
        --mapper-ckpt .../model_04.ckpt           # reference .ckpt or the port's model_NN \
        --questions-train .../v2_OpenEnded_mscoco_train2014_questions.json \
        --annotations-train .../v2_mscoco_train2014_annotations.json \
        --questions-val .../v2_OpenEnded_mscoco_val2014_questions.json \
        --annotations-val .../v2_mscoco_val2014_annotations.json \
        --clip-embeddings-train .../coco_ViT-L_14@336px_train2014.pkl \
        --clip-embeddings-val   .../coco_ViT-L_14@336px_val2014.pkl \
        --rices .../rices.pkl \
        --workdir /tmp/replicate --output report.json

The HF weights and tokenizer load through ``transformers`` from local files
only. It runs the k in {0,1,2,4,8} x {hotpotqa, frozen} sweep through the
port's executor and prints a BASELINE.md diff table with +-0.3 parity
verdicts (exit code 1 with --strict when a point misses). A reference
``.ckpt`` is converted by tools/convert_reference_checkpoint.py; an Orbax
directory of the JAX package is refused (convert it first with
tools/convert_orbax_checkpoint.py).

--modes extends the sweep to the rest of the published table (all
hotpotqa-template rows; reference notebook cells 5-7):
  no_prefix   text-only prompts (--no_prefix 1), RICES example text
  text_rices  text-only prompts + question-only RICES
              (needs --text-rices rices_questions_only.pkl)
  ensemble    prompt-permutation ensembling
              (--num_permutations_of_in_context_examples 5)
  random      RANDOM in-context examples
              (needs --random-examples random.pkl)

To check the opt-in int8 modes' accuracy, add

    --opts "tpu.int8_cross_kv=True" "tpu.int8_encoder_ffn=True" \
           "tpu.int8_encoder_attn=True" --compare-bf16

which runs every point also with the int8 overrides stripped and reports
the int8-vs-bf16 delta; "tpu.int8_calibrate_batches=8" calibrates
SmoothQuant on the first eval batches. Whenever tpu.int8_* opts are
present, the trained-weight drift study (tools/int8_drift_study.py
--weights <t0-weights>) runs first in a child process and lands in the
report under "int8_drift_study" (--skip-int8-drift opts out). Every input
path is checked up front. tools/replicate_dryrun.py rehearses all of this
on tiny artifacts.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from ..device import DeviceLike

logger = logging.getLogger(__name__)

# Published reference numbers (BASELINE.md; source
# reference src/tools/plots_for_report.ipynb cells 2-5):
# {(template, num_shots): VQA2 val accuracy %} — RICES examples, n=10.
BASELINE_NUMBERS: Dict[Any, float] = {
    ("hotpotqa", 0): 34.49,
    ("hotpotqa", 1): 40.39,
    ("hotpotqa", 2): 39.66,
    ("hotpotqa", 4): 37.17,
    ("hotpotqa", 8): 34.72,
    ("frozen", 0): 20.89,
    ("frozen", 1): 30.83,
    ("frozen", 2): 28.89,
    ("frozen", 4): 26.58,
    ("frozen", 8): 23.83,
}

TEMPLATE_CONFIGS = {
    "hotpotqa": "configs/vqa2/few_shot_vqa_hotpotqa.jsonnet",
    "frozen": "configs/vqa2/few_shot_vqa_frozen.jsonnet",
}

# The rest of the published table (plots_for_report.ipynb cells 5-7,
# BASELINE.md) — all measured on the hotpotqa template.
MODE_BASELINES: Dict[str, Dict[Any, float]] = {
    "main": BASELINE_NUMBERS,
    "no_prefix": {("hotpotqa", 0): 27.39, ("hotpotqa", 1): 38.08,
                  ("hotpotqa", 2): 38.74, ("hotpotqa", 4): 35.11},
    "text_rices": {("hotpotqa", 0): 27.39, ("hotpotqa", 1): 32.94,
                   ("hotpotqa", 2): 33.54, ("hotpotqa", 4): 32.24},
    "ensemble": {("hotpotqa", 2): 40.34, ("hotpotqa", 4): 38.36},
    "random": {("hotpotqa", 1): 24.93, ("hotpotqa", 2): 24.69,
               ("hotpotqa", 4): 24.26, ("hotpotqa", 8): 24.11},
}
MODE_DEFAULT_SHOTS: Dict[str, List[int]] = {
    "main": [0, 1, 2, 4, 8],
    "no_prefix": [0, 1, 2, 4],
    "text_rices": [0, 1, 2, 4],
    "ensemble": [2, 4],
    "random": [1, 2, 4, 8],
}


def _lm_config_from_hf_dir(weights_dir: str) -> Dict[str, Any]:
    """T5Config dim overrides from the HF checkpoint's config.json, so
    the harness works for any T5-v1.1-family size (incl. tiny CI twins)."""
    with open(os.path.join(weights_dir, "config.json")) as fh:
        hf = json.load(fh)
    return {
        "vocab_size": hf["vocab_size"],
        "d_model": hf["d_model"],
        "d_kv": hf["d_kv"],
        "num_heads": hf["num_heads"],
        "d_ff": hf["d_ff"],
        "num_encoder_layers": hf["num_layers"],
        "num_decoder_layers": hf.get("num_decoder_layers",
                                     hf["num_layers"]),
        "relative_attention_num_buckets":
            hf.get("relative_attention_num_buckets", 32),
        "relative_attention_max_distance":
            hf.get("relative_attention_max_distance", 128),
    }


def _resolve_mapper_ckpt(mapper_ckpt: Optional[str], mapping_type: str,
                         workdir: str) -> Optional[str]:
    """A reference torch/PL .ckpt is converted to a checkpoint of the port;
    the port's own checkpoint directory is used as it is; None runs with a
    random-init mapper (a prompt-only ablation, marked in the report)."""
    if not mapper_ckpt:
        return None
    if os.path.isdir(mapper_ckpt):
        from ..trainers.checkpointing import STATE_FILE

        if not os.path.isfile(os.path.join(mapper_ckpt, STATE_FILE)):
            raise ValueError(
                f"{mapper_ckpt} holds no {STATE_FILE}: an Orbax checkpoint "
                "of the JAX package is not read here; convert it on a host "
                "with tensorstore: python -m explicit_alignment_for_vqa_"
                "tasks_tpu_torch.tools.convert_orbax_checkpoint --src "
                "<its model_NN> --out <a directory>")
        return os.path.abspath(mapper_ckpt)
    from .convert_reference_checkpoint import convert

    out = os.path.join(os.path.abspath(workdir), "converted_mapper")
    return convert(mapper_ckpt, mapping_type, out)


def _sentinel_base(weights_dir: str) -> Optional[int]:
    """<extra_id_0>'s id from the mounted tokenizer (32099 for the real
    T5/T0 vocab; tiny CI twins differ). The prefix-splice op keys on it."""
    try:
        import transformers

        tok = transformers.AutoTokenizer.from_pretrained(
            weights_dir, local_files_only=True
        )
        base = tok.convert_tokens_to_ids("<extra_id_0>")
        return int(base) if base is not None else None
    except Exception as exc:
        logger.warning("could not read sentinel base from tokenizer: %s",
                       exc)
        return None


def _mode_examples_fpath(mode: str, args: Any) -> str:
    """In-context example pickle per mode. Modes whose artifact was not
    supplied raise — the user explicitly asked for the mode."""
    if mode == "random":
        if not args.random_examples:
            raise ValueError("--modes random needs --random-examples "
                             "(the reference's random.pkl)")
        return args.random_examples
    if mode == "text_rices":
        if not args.text_rices:
            raise ValueError("--modes text_rices needs --text-rices "
                             "(the reference's rices_questions_only.pkl)")
        return args.text_rices
    return args.rices


def _strip_int8_opts(opts: List[str]) -> List[str]:
    """Drop every tpu.int8* dotted override — the bf16 twin of an int8
    sweep point (--compare-bf16)."""
    return [o for o in opts
            if not o.split("=", 1)[0].strip().startswith("tpu.int8")]


def _build_config(template: str, num_shots: int, args: Any,
                  lm_config: Dict[str, Any],
                  mapper_path: Optional[str],
                  sentinel_base: Optional[int] = None,
                  mode: str = "main",
                  strip_int8: bool = False):
    from ..utils.attr_dict import AttrDict
    from ..utils.config_system import parse_optional_args, process_config

    opts = list(args.opts or [])
    suffix = ""
    if strip_int8:
        opts = _strip_int8_opts(opts)
        suffix = "_bf16"
    ns = argparse.Namespace(
        config=TEMPLATE_CONFIGS[template],
        mode="test",
        experiment_name=f"replicate_{mode}_{template}_k{num_shots}{suffix}",
        reset=False, num_shots=num_shots,
        no_prefix=int(mode in ("no_prefix", "text_rices")),
        pass_examples_through_encoder_one_at_a_time=0,
        num_permutations_of_in_context_examples=(
            args.ensemble_permutations if mode == "ensemble" else 0
        ),
        sample_templates=0, ensemble_one_shots=0,
        in_context_examples_fpath=_mode_examples_fpath(mode, args),
        modules=[], tags=[],
        test_batch_size=args.batch_size, test_evaluation_name="",
        opts=opts,
    )
    config = process_config(ns)
    work = os.path.abspath(args.workdir)
    config.EXPERIMENT_FOLDER = os.path.join(work, "experiments")
    config.experiment_path = os.path.join(
        work, "experiments", ns.experiment_name
    )
    config.saved_model_path = os.path.join(config.experiment_path,
                                           "saved_model")
    config.results_path = os.path.join(config.experiment_path, "results")
    config.cache.default_folder = os.path.join(work, "cache")
    config.log_path = os.path.join(config.experiment_path, "logs")

    mc = config.model_config
    mc.pretrained = 1
    mc.model_args.model_version = args.t0_weights
    mc.TokenizerClass = "T5TokenizerFast"
    mc.TokenizerModelVersion = args.t0_weights
    mc.lm_config = lm_config
    if sentinel_base is not None:
        mc.model_args.sentinel_base = sentinel_base

    config.tpu.compute_dtype = args.compute_dtype
    config.tpu.params_dtype = args.params_dtype
    if args.fused_attention:
        config.tpu.fused_attention = 1

    config.valid.batch_size = args.batch_size
    config.test.batch_size = args.batch_size
    if mapper_path:
        config.test.load_model_path = mapper_path

    module_dict = config.data_loader.dataset_modules.module_dict
    module_dict.LoadVQA2Data.config.vqa_data_path = AttrDict(
        question_files={"train": args.questions_train,
                        "val": args.questions_val},
        annotation_files={"train": args.annotations_train,
                          "val": args.annotations_val},
    )
    module_dict.LoadVQA2Data.config.image_data_path = AttrDict(
        train=work, val=work
    )
    module_dict.LoadClipEmbeddings.config = AttrDict(
        train=args.clip_embeddings_train, val=args.clip_embeddings_val,
    )
    # the user's --opts win over the harness's settings above (say,
    # model_config.TokenizerClass=SimpleTokenizer without T0's tokenizer)
    return parse_optional_args(config, opts)


def _run_point(config, device: DeviceLike = None) -> Dict[str, Any]:
    from ..registry import DATA_LOADERS, EXECUTORS

    # main.py registers everything via its imports
    from .. import main as _main  # noqa: F401

    data_loader = DATA_LOADERS.get(config.data_loader.type)(config)
    data_loader.build_dataset()
    data_loader.set_dataloader()
    executor = EXECUTORS.get(config.train.type)(config, data_loader,
                                                device=device)
    if config.test.get("load_model_path"):
        executor.maybe_load_checkpoint()
    t0 = time.perf_counter()
    metrics = executor.test()
    dt = time.perf_counter() - t0
    n_questions = len(data_loader.data.vqa_data.val.data_items)
    return {
        "accuracy_overall": metrics.get("test_evaluation/accuracy_overall"),
        "per_answer_type": {
            key.removeprefix("test_evaluation/"): value
            for key, value in metrics.items()
            if "accuracy_" in key and key !=
            "test_evaluation/accuracy_overall"
        },
        "questions": n_questions,
        "questions_per_s": round(n_questions / max(dt, 1e-9), 2),
        "wall_s": round(dt, 1),
    }


def check_artifacts(args: Any) -> List[str]:
    """Loud missing-artifact checklist: verify every input path BEFORE
    any model/data work, so a half-mounted artifact set fails with the
    full shopping list instead of a deep loader traceback. Returns the
    missing descriptions (and logs the checklist)."""
    required = [
        ("--t0-weights (HF dir with config.json)", args.t0_weights,
         lambda p: os.path.isfile(os.path.join(p, "config.json"))),
        ("--questions-train", args.questions_train, os.path.isfile),
        ("--annotations-train", args.annotations_train, os.path.isfile),
        ("--questions-val", args.questions_val, os.path.isfile),
        ("--annotations-val", args.annotations_val, os.path.isfile),
        ("--clip-embeddings-train", args.clip_embeddings_train,
         os.path.isfile),
        ("--clip-embeddings-val", args.clip_embeddings_val, os.path.isfile),
        ("--rices", args.rices, os.path.isfile),
    ]
    if args.mapper_ckpt:
        required.append(("--mapper-ckpt", args.mapper_ckpt, os.path.exists))
    if "random" in args.modes:
        required.append(("--random-examples (random.pkl)",
                         args.random_examples, os.path.isfile))
    if "text_rices" in args.modes:
        required.append(("--text-rices (rices_questions_only.pkl)",
                         args.text_rices, os.path.isfile))
    missing = []
    for name, path, ok in required:
        present = bool(path) and ok(path)
        logger.info("artifact %-45s %s  %s", name,
                    "OK     " if present else "MISSING", path or "(unset)")
        if not present:
            missing.append(f"{name}: {path or '(unset)'}")
    return missing


def _run_int8_drift_study(args: Any) -> Optional[Dict[str, Any]]:
    """tools/int8_drift_study.py --weights <t0_weights> in a child process,
    before this process builds its first model, so that the two never hold
    the card's memory at once. Returns its JSON summary, or None on failure
    (logged)."""
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m",
        "explicit_alignment_for_vqa_tasks_tpu_torch.tools.int8_drift_study",
        "--weights", args.t0_weights,
    ]
    if args.device:
        cmd += ["--device", args.device]
    logger.info("running trained-weight int8 drift study: %s",
                " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=3600)
        for line in reversed(proc.stdout.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
        logger.warning("int8 drift study produced no JSON (rc=%d): %s",
                       proc.returncode, proc.stderr[-500:])
    except Exception as exc:
        logger.warning("int8 drift study failed: %s", exc)
    return None


def run_sweep(args: Any, device: DeviceLike = None) -> Dict[str, Any]:
    """Every requested point through _build_config and _run_point (and its
    bf16 twin with --compare-bf16), on ``device`` (default: --device, else
    the card)."""
    if device is not None:
        args.device = str(device)
    device = args.device
    if args.compare_bf16 and \
            _strip_int8_opts(list(args.opts or [])) == list(args.opts or []):
        raise ValueError(
            "--compare-bf16 compares an int8 run against its bf16 twin: "
            "pass at least one tpu.int8_* override via --opts (e.g. "
            "--opts tpu.int8_encoder_ffn=1 tpu.int8_calibrate_batches=4)"
        )
    missing = check_artifacts(args)
    if missing:
        raise FileNotFoundError(
            "replication artifacts missing — mount these and re-run:\n  "
            + "\n  ".join(missing)
        )
    # with int8 opts the trained-weight drift study is part of the
    # validation by default; it runs first, in a child process
    int8_drift = None
    has_int8_opts = _strip_int8_opts(list(args.opts or [])) != \
        list(args.opts or [])
    if has_int8_opts and not args.skip_int8_drift:
        int8_drift = _run_int8_drift_study(args)
    os.makedirs(args.workdir, exist_ok=True)
    lm_config = _lm_config_from_hf_dir(args.t0_weights)
    mapper_path = _resolve_mapper_ckpt(
        args.mapper_ckpt, args.mapping_type, args.workdir
    )
    if mapper_path is None:
        logger.warning(
            "no --mapper-ckpt given: running with a RANDOM-INIT mapper — "
            "accuracies will NOT match the baseline (prompt-only ablation)"
        )

    sentinel_base = _sentinel_base(args.t0_weights)
    rows: List[Dict[str, Any]] = []
    for mode in args.modes:
        # the non-main published rows are hotpotqa-only (notebook cells 5-7)
        templates = args.templates if mode == "main" else ["hotpotqa"]
        if mode != "main" and set(args.templates) != {"hotpotqa", "frozen"} \
                and args.templates != ["hotpotqa"]:
            logger.warning(
                "--templates %s ignored for mode '%s': its published rows "
                "are hotpotqa-only", args.templates, mode,
            )
        shots = args.shots if args.shots else MODE_DEFAULT_SHOTS[mode]
        if mode != "main" and args.shots:
            # only published points are meaningful for the extra modes
            # (an 'n/a' row would count as passing under --strict)
            dropped = [k for k in shots
                       if k not in MODE_DEFAULT_SHOTS[mode]]
            shots = [k for k in shots if k in MODE_DEFAULT_SHOTS[mode]]
            if dropped:
                logger.warning(
                    "mode '%s': dropping unpublished shot counts %s "
                    "(published: %s)", mode, dropped,
                    MODE_DEFAULT_SHOTS[mode],
                )
            if not shots:
                raise ValueError(
                    f"--shots {args.shots} leaves no published points for "
                    f"mode '{mode}' (published: {MODE_DEFAULT_SHOTS[mode]})"
                )
        baselines = MODE_BASELINES[mode]
        for template in templates:
            for k in shots:
                logger.info("=== %s, %s, %d-shot ===", mode, template, k)
                config = _build_config(template, k, args, lm_config,
                                       mapper_path, sentinel_base,
                                       mode=mode)
                point = _run_point(config, device)
                ref = baselines.get((template, k))
                acc = point["accuracy_overall"]
                delta = None if ref is None or acc is None else round(
                    acc - ref, 2
                )
                verdict = "n/a"
                if delta is not None and mapper_path is not None:
                    verdict = ("PASS" if abs(delta) <= args.tolerance
                               else "FAIL")
                row = {
                    "mode": mode, "template": template, "num_shots": k,
                    "accuracy": acc, "reference": ref, "delta": delta,
                    "verdict": verdict, **{
                        key: point[key]
                        for key in ("questions", "questions_per_s",
                                    "wall_s")
                    },
                }
                if args.compare_bf16:
                    # the bf16 twin of this int8 point in the same
                    # invocation
                    bf_config = _build_config(
                        template, k, args, lm_config, mapper_path,
                        sentinel_base, mode=mode, strip_int8=True,
                    )
                    bf_point = _run_point(bf_config, device)
                    bf_acc = bf_point["accuracy_overall"]
                    row["accuracy_bf16"] = bf_acc
                    row["bf16_questions_per_s"] = bf_point[
                        "questions_per_s"]
                    if acc is not None and bf_acc is not None:
                        d8 = round(acc - bf_acc, 2)
                        row["int8_vs_bf16_delta"] = d8
                        row["int8_verdict"] = (
                            "PASS" if abs(d8) <= args.tolerance else "FAIL"
                        )
                rows.append(row)
    report = {
        "t0_weights": args.t0_weights,
        "mapper_ckpt": args.mapper_ckpt,
        "random_mapper": mapper_path is None,
        "tolerance": args.tolerance,
        "rows": rows,
        "all_pass": all(
            r["verdict"] != "FAIL" and r.get("int8_verdict") != "FAIL"
            for r in rows
        ),
    }
    if int8_drift is not None:
        report["int8_drift_study"] = int8_drift
    elif has_int8_opts and args.skip_int8_drift:
        report["int8_drift_study"] = "skipped (--skip-int8-drift)"
    return report


def print_report(report: Dict[str, Any]) -> None:
    print(f"\n{'mode':>10} {'template':>10} {'k':>2} {'ours':>7} "
          f"{'reference':>9} {'delta':>6}  verdict   q/s")
    for row in report["rows"]:
        ours = "—" if row["accuracy"] is None else f"{row['accuracy']:.2f}"
        ref = "—" if row["reference"] is None else f"{row['reference']:.2f}"
        delta = "—" if row["delta"] is None else f"{row['delta']:+.2f}"
        line = (f"{row.get('mode', 'main'):>10} {row['template']:>10} "
                f"{row['num_shots']:>2} {ours:>7} "
                f"{ref:>9} {delta:>6}  {row['verdict']:<7} "
                f"{row['questions_per_s']:>6.1f}")
        if "accuracy_bf16" in row:
            bf = ("—" if row["accuracy_bf16"] is None
                  else f"{row['accuracy_bf16']:.2f}")
            d8 = ("—" if row.get("int8_vs_bf16_delta") is None
                  else f"{row['int8_vs_bf16_delta']:+.2f}")
            line += (f"  | bf16 {bf} int8Δ {d8} "
                     f"{row.get('int8_verdict', 'n/a')}")
        print(line)
    if report["random_mapper"]:
        print("\nNOTE: random-init mapper (no --mapper-ckpt) — verdicts "
              "suppressed")
    print(f"\nall_pass={report['all_pass']} "
          f"(tolerance ±{report['tolerance']})")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--t0-weights",
                        default=os.environ.get("EAVT_T0_WEIGHTS"),
                        help="local HF dir (model + tokenizer); default "
                             "$EAVT_T0_WEIGHTS")
    parser.add_argument("--mapper-ckpt", default="",
                        help="trained mapper: reference PL .ckpt (converted"
                             " on the fly) or the port's checkpoint dir")
    parser.add_argument("--mapping-type", default="mlp",
                        choices=["mlp", "transformer"])
    parser.add_argument("--questions-train", required=True)
    parser.add_argument("--annotations-train", required=True)
    parser.add_argument("--questions-val", required=True)
    parser.add_argument("--annotations-val", required=True)
    parser.add_argument("--clip-embeddings-train", required=True)
    parser.add_argument("--clip-embeddings-val", required=True)
    parser.add_argument("--rices", required=True,
                        help="RICES in-context example pickle")
    parser.add_argument("--modes", nargs="+", default=["main"],
                        choices=list(MODE_BASELINES),
                        help="published-table sections to replicate")
    parser.add_argument("--random-examples", default="",
                        help="random.pkl for --modes random")
    parser.add_argument("--text-rices", default="",
                        help="rices_questions_only.pkl for "
                             "--modes text_rices")
    parser.add_argument("--ensemble-permutations", type=int, default=5,
                        help="permutations per question for "
                             "--modes ensemble (reference uses 5)")
    parser.add_argument("--shots", type=int, nargs="+", default=None,
                        help="override shot counts for ALL modes "
                             "(default: each mode's published list)")
    parser.add_argument("--templates", nargs="+",
                        default=["hotpotqa", "frozen"],
                        choices=list(TEMPLATE_CONFIGS))
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--tolerance", type=float, default=0.3)
    parser.add_argument("--compute-dtype", default="bfloat16")
    parser.add_argument("--params-dtype", default="bfloat16")
    parser.add_argument("--fused-attention", type=int, default=1)
    parser.add_argument("--workdir", default="replicate_workdir")
    parser.add_argument("--output", default="",
                        help="write the JSON report here")
    parser.add_argument("--compare-bf16", action="store_true",
                        help="run every sweep point TWICE — once with "
                        "the given tpu.int8_* --opts, once with them "
                        "stripped — and report the int8-vs-bf16 accuracy "
                        "delta with a ±tolerance verdict per row")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 if any sweep point FAILs")
    parser.add_argument("--skip-int8-drift", action="store_true",
                        help="when tpu.int8_* --opts are present, the "
                        "trained-weight int8 drift study "
                        "(tools/int8_drift_study.py --weights) runs by "
                        "default before the sweep and lands in the "
                        "report; this skips it")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="extra dotted config overrides")
    args = parser.parse_args(argv)
    if not args.t0_weights:
        parser.error("--t0-weights (or $EAVT_T0_WEIGHTS) is required")
    return args


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    report = run_sweep(args, device)
    print_report(report)
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(report, fh, indent=2)
        logger.info("report written to %s", args.output)
    if args.strict and not report["all_pass"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
