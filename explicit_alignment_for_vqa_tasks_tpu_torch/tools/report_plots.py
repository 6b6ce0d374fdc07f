"""Accuracy-vs-shots report plots.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/tools/report_plots.py
(the reference's ``plots_for_report.ipynb``, the source of the published
numbers in BASELINE.md), host code only: collects ``accuracy_overall``
from experiment result files and plots accuracy against the number of
shots per method, the reference's curves overlaid. Needs ``matplotlib``,
imported where it plots.

    python -m explicit_alignment_for_vqa_tasks_tpu_torch.tools.report_plots \
        RESULT_DIR... --out plot.png
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List

logger = logging.getLogger(__name__)

# reference-published accuracies (BASELINE.md), for overlay
REFERENCE_CURVES = {
    "hotpotqa + RICES (reference)": {0: 34.49, 1: 40.39, 2: 39.66,
                                     4: 37.17, 8: 34.72},
    "frozen + RICES (reference)": {0: 20.89, 1: 30.83, 2: 28.89,
                                   4: 26.58, 8: 23.83},
    "hotpotqa + RANDOM (reference)": {1: 24.93, 2: 24.69, 4: 24.26,
                                      8: 24.11},
}


def collect_results(result_dirs: List[str]) -> Dict[str, Dict[int, float]]:
    """Each dir must contain metrics.json files of shape
    {"num_shots": k, "method": name, "accuracy_overall": x}."""
    curves: Dict[str, Dict[int, float]] = {}
    for root in result_dirs:
        for dirpath, _, files in os.walk(root):
            for name in files:
                if not name.endswith("metrics.json"):
                    continue
                with open(os.path.join(dirpath, name), encoding="utf-8") as fh:
                    entry = json.load(fh)
                method = entry.get("method", "ours")
                curves.setdefault(method, {})[int(entry["num_shots"])] = (
                    float(entry["accuracy_overall"])
                )
    return curves


def plot_curves(curves: Dict[str, Dict[int, float]], out_path: str,
                include_reference: bool = True) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    all_curves = dict(curves)
    if include_reference:
        all_curves.update(REFERENCE_CURVES)
    for label, points in all_curves.items():
        shots = sorted(points)
        style = "--" if "(reference)" in label else "-"
        ax.plot(shots, [points[s] for s in shots], style, marker="o",
                label=label)
    ax.set_xlabel("number of in-context examples (shots)")
    ax.set_ylabel("VQA2 val accuracy (%)")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    logger.info("wrote plot to %s", out_path)
    return out_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("result_dirs", nargs="+")
    parser.add_argument("--out", required=True)
    parser.add_argument("--no_reference", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    curves = collect_results(args.result_dirs)
    plot_curves(curves, args.out, include_reference=not args.no_reference)


if __name__ == "__main__":
    main()
