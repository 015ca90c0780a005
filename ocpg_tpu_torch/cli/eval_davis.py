"""Offline DAVIS J&F scoring of saved PNG masks: counterpart of
``ocpg_tpu/cli/eval_davis.py`` (numpy and scipy, no device).

Writes the global and per-sequence CSVs next to the results, as the
reference's eval_davis.py does.

Usage:
    python -m ocpg_tpu_torch.cli.eval_davis --davis_path /data/davis \\
        --results_path output/davis/valid/anno_0
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Optional, Sequence

from ..evaluation.davis_eval import evaluate_davis, global_summary


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ocpg_tpu_torch.cli.eval_davis",
                                description="DAVIS J&F of saved palette PNGs.")
    p.add_argument("--davis_path", required=True)
    p.add_argument("--results_path", required=True)
    p.add_argument("--set", default="val")
    p.add_argument("--task", default="unsupervised",
                   choices=["semi-supervised", "unsupervised"])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = get_args(argv)
    metrics = evaluate_davis(args.davis_path, args.results_path, args.set, args.task)
    summary = global_summary(metrics)

    g_csv = os.path.join(args.results_path, f"global_results-{args.set}.csv")
    with open(g_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(summary.keys()))
        w.writerow([f"{v:.5f}" for v in summary.values()])

    seq_csv = os.path.join(args.results_path, f"per-sequence_results-{args.set}.csv")
    with open(seq_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Sequence", "J-Mean", "F-Mean"])
        for name in metrics["J"]["M_per_object"]:
            w.writerow([name, f"{metrics['J']['M_per_object'][name]:.5f}",
                        f"{metrics['F']['M_per_object'][name]:.5f}"])

    print(" ".join(f"{k}={v:.4f}" for k, v in summary.items()))
    return summary


if __name__ == "__main__":
    main()
