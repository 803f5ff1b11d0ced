"""Layout accuracy stage (counterpart of benchmark/layout.py): per-label
coverage precision and recall on LAYOUT_BENCH_DATASET_NAME (PubLayNet
labels, mapped onto the model's by ``LABEL_ALIGNMENT``), or on synthetic
pages whose lines are all "Text"; writes ``layout_bench.json``.

    python -m surya_tpu_torch.benchmark.layout [--results_dir DIR] [--max_rows 100] [--synthetic]
"""

from __future__ import annotations

import collections
import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import format_table, stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_text_pages
from surya_tpu_torch.benchmark.utils.metrics import precision_recall
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.settings import settings

# publaynet label -> our label set
LABEL_ALIGNMENT = {
    "Image": ["Picture", "Figure"],
    "Table": ["Table", "Form", "TableOfContents"],
    "Text": ["Text", "Caption", "Footnote", "Equation", "TextInlineMath", "Code", "Handwriting"],
    "List": ["ListItem"],
    "Title": ["SectionHeader", "Title"],
}


def parser():
    return stage_parser("Benchmark the layout model.", max_rows=100)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    layout_predictor = LayoutPredictor()
    if synthetic:
        images, page_boxes, _ = synthetic_text_pages(max_rows)
        rows = [{"bboxes": b, "labels": ["Text"] * len(b)} for b in page_boxes]
    else:
        rows = load_hf_dataset(settings.LAYOUT_BENCH_DATASET_NAME, max_rows)
        images = convert_if_not_rgb(list(rows["image"]))

    layout_predictor(images[:1])  # warm-up
    start = time.time()
    predictions = layout_predictor(images)
    surya_time = time.time() - start

    label_metrics = collections.defaultdict(list)
    for pred, row in zip(predictions, rows):
        for label_name, aliases in LABEL_ALIGNMENT.items():
            ref_boxes = [b for b, lab in zip(row["bboxes"], row["labels"]) if lab == label_name]
            pred_boxes = [p.bbox for p in pred.bboxes if p.label in aliases]
            if ref_boxes or pred_boxes:
                label_metrics[label_name].append(precision_recall(pred_boxes, ref_boxes, penalize_double=False))

    mean_metrics = {
        label: {
            "precision": sum(m["precision"] for m in ms) / len(ms),
            "recall": sum(m["recall"] for m in ms) / len(ms),
        }
        for label, ms in label_metrics.items()
        if ms
    }

    out = {"metrics": mean_metrics, "time_per_image": surya_time / len(images)}
    write_results(results_dir, "layout_bench.json", out)
    print(format_table([[label, m["precision"], m["recall"]] for label, m in mean_metrics.items()],
                       ["label", "precision", "recall"]))
    print(f"time per image: {surya_time / len(images):.3f}s")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
