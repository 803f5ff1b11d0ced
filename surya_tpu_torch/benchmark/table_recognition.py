"""Table recognition accuracy stage (counterpart of
benchmark/table_recognition.py, its Surya half): penalized row and column
IoU on TABLE_REC_BENCH_DATASET_NAME or on synthetic grid tables offline;
writes ``table_rec_bench.json``.

    python -m surya_tpu_torch.benchmark.table_recognition [--results_dir DIR] [--max_rows 100] [--synthetic]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import format_table, stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_table_pages
from surya_tpu_torch.benchmark.utils.metrics import penalized_iou_score
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.settings import settings
from surya_tpu_torch.table_rec import TableRecPredictor


def parser():
    return stage_parser("Benchmark the table recognition model.", max_rows=100)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    predictor = TableRecPredictor()

    if synthetic:
        images, ref_rows, ref_cols = synthetic_table_pages(max_rows)
    else:
        dataset = load_hf_dataset(settings.TABLE_REC_BENCH_DATASET_NAME, max_rows)
        images = convert_if_not_rgb(list(dataset["image"]))
        ref_rows = list(dataset["rows"])
        ref_cols = list(dataset["cols"])

    predictor(images[:1])  # warm-up
    start = time.time()
    predictions = predictor(images)
    total_time = time.time() - start

    row_scores, col_scores = [], []
    for pred, rows, cols in zip(predictions, ref_rows, ref_cols):
        row_scores.append(penalized_iou_score([r.bbox for r in pred.rows], rows))
        col_scores.append(penalized_iou_score([c.bbox for c in pred.cols], cols))

    out = {
        "surya": {
            "mean_row_iou": sum(row_scores) / len(row_scores),
            "mean_col_iou": sum(col_scores) / len(col_scores),
            "time_per_image": total_time / len(images),
        }
    }
    write_results(results_dir, "table_rec_bench.json", out)
    rows = [[m, v["mean_row_iou"], v["mean_col_iou"], v["time_per_image"]] for m, v in out.items()]
    print(format_table(rows, ["model", "row iou", "col iou", "time/image (s)"]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
