"""Detection accuracy stage (counterpart of benchmark/detection.py, its Surya
half): coverage-based precision and recall of the detected line boxes on
DETECTOR_BENCH_DATASET_NAME (boxes on a 1000x1000 scale) or on synthetic
pages offline; writes ``det_bench.json``.

    python -m surya_tpu_torch.benchmark.detection [--results_dir DIR] [--max_rows 100] [--synthetic]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import format_table, stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_text_pages
from surya_tpu_torch.benchmark.utils.metrics import precision_recall
from surya_tpu_torch.common.util import rescale_bbox
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.settings import settings


def parser():
    return stage_parser("Benchmark the detection model.", max_rows=100)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    det_predictor = DetectionPredictor()

    if synthetic:
        images, correct_boxes, _ = synthetic_text_pages(max_rows)
    else:
        dataset = load_hf_dataset(settings.DETECTOR_BENCH_DATASET_NAME, max_rows)
        images = convert_if_not_rgb(list(dataset["image"]))
        correct_boxes = [
            [rescale_bbox(b, (1000, 1000), images[i].size) for b in boxes]
            for i, boxes in enumerate(dataset["bboxes"])
        ]

    det_predictor(images[:1])  # warm-up
    start = time.time()
    predictions = det_predictor(images)
    surya_time = time.time() - start

    page_metrics = {
        idx: {"surya": precision_recall([b.bbox for b in pred.bboxes], ref)}
        for idx, (pred, ref) in enumerate(zip(predictions, correct_boxes))
    }
    mean_metrics = {
        "surya": {
            k: sum(page_metrics[i]["surya"][k] for i in page_metrics) / len(page_metrics)
            for k in ("precision", "recall")
        }
    }
    mean_metrics["surya"]["time_per_image"] = surya_time / len(images)

    out = {"metrics": mean_metrics, "page_metrics": page_metrics}
    write_results(results_dir, "det_bench.json", out)
    rows = [[m, v["precision"], v["recall"], v["time_per_image"]] for m, v in mean_metrics.items()]
    print(format_table(rows, ["model", "precision", "recall", "time/image (s)"]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
