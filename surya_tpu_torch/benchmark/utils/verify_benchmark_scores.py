"""Score gates of the port's accuracy stages (the port's copy of
benchmark/utils/verify_benchmark_scores.py, the reference's CI thresholds).
Each gate reads a stage's result file and raises ValueError below its
threshold.

    python -m surya_tpu_torch.benchmark.utils.verify_benchmark_scores <result.json> [--bench_type detection]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def verify_det(data):
    scores = data["metrics"]["surya"]
    if scores["precision"] <= 0.9 or scores["recall"] <= 0.9:
        raise ValueError("Detection scores do not meet the required threshold")


def verify_rec(data):
    if data["surya"]["avg_score"] <= 0.9:
        raise ValueError("Recognition scores do not meet the required threshold")


def verify_layout(data):
    for layout_type, metrics in data["metrics"].items():
        if layout_type == "List":  # Lists don't appear in the early rows
            continue
        if metrics["precision"] <= 0.6 or metrics["recall"] <= 0.6:
            raise ValueError("Layout scores do not meet the required threshold")


def verify_order(data):
    if data["mean_accuracy"] < 0.75:
        raise ValueError("Ordering scores do not meet the required threshold")


def verify_table_rec(data):
    if data["surya"]["mean_row_iou"] < 0.75 or data["surya"]["mean_col_iou"] < 0.75:
        raise ValueError("Table rec scores do not meet the required threshold")


def verify_texify(data):
    if data["scores"] > 0.2:
        raise ValueError("Texify scores do not meet the required threshold")


VERIFIERS = {
    "detection": verify_det,
    "recognition": verify_rec,
    "layout": verify_layout,
    "ordering": verify_order,
    "table_recognition": verify_table_rec,
    "texify": verify_texify,
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Verify benchmark scores against the CI gates.")
    p.add_argument("file_path")
    p.add_argument("--bench_type", default="detection")
    options = p.parse_args(argv)
    with open(options.file_path) as f:
        data = json.load(f)
    if options.bench_type not in VERIFIERS:
        raise ValueError(f"Invalid benchmark type {options.bench_type}")
    VERIFIERS[options.bench_type](data)
    print(f"{options.bench_type} scores pass")


if __name__ == "__main__":
    main()
