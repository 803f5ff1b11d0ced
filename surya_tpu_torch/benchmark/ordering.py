"""Reading-order accuracy stage (counterpart of benchmark/ordering.py):
pairwise rank accuracy of the layout model's emission order on
ORDER_BENCH_DATASET_NAME (each reference box matched to the predicted box
that covers most of it), or on synthetic pages in top-to-bottom order;
writes ``order_bench.json``.

    python -m surya_tpu_torch.benchmark.ordering [--results_dir DIR] [--max_rows 100] [--synthetic]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_text_pages
from surya_tpu_torch.benchmark.utils.metrics import rank_accuracy
from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.settings import settings


def parser():
    return stage_parser("Benchmark reading order (layout emission order).", max_rows=100)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    layout_predictor = LayoutPredictor()
    if synthetic:
        # natural top-to-bottom reading order on synthetic line pages
        images, page_boxes, _ = synthetic_text_pages(max_rows)
        rows = [{"bboxes": b, "labels": [str(i) for i in range(len(b))]} for b in page_boxes]
    else:
        rows = load_hf_dataset(settings.ORDER_BENCH_DATASET_NAME, max_rows)
        images = convert_if_not_rgb(list(rows["image"]))

    layout_predictor(images[:1])  # warm-up
    start = time.time()
    predictions = layout_predictor(images)
    total_time = time.time() - start

    accuracies = []
    for pred, row in zip(predictions, rows):
        # match each reference box to the closest predicted box's position
        pred_positions, ref_positions = [], []
        for ref_bbox, ref_pos in zip(row["bboxes"], row["labels"]):
            ref_box = PolygonBox(polygon=ref_bbox)
            best, best_pos = 0.0, None
            for p in pred.bboxes:
                pct = ref_box.intersection_pct(p)
                if pct > best:
                    best, best_pos = pct, p.position
            if best_pos is not None:
                pred_positions.append(best_pos)
                ref_positions.append(int(ref_pos))
        if len(pred_positions) > 1:
            accuracies.append(rank_accuracy(pred_positions, ref_positions))

    mean_accuracy = sum(accuracies) / len(accuracies) if accuracies else 0.0
    out = {"mean_accuracy": mean_accuracy, "time_per_image": total_time / len(images)}
    write_results(results_dir, "order_bench.json", out)
    print(f"mean pairwise order accuracy: {mean_accuracy:.4f} ({total_time / len(images):.3f}s/image)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
