"""Recognition accuracy stage (counterpart of benchmark/recognition.py, its
Surya half): fuzzy line similarity (``overlap_score``) of the lines read
from given boxes on RECOGNITION_BENCH_DATASET_NAME or on synthetic pages
offline; writes ``rec_bench.json``. The dataset's ``language`` column
serves only the baselines, which the port leaves out.

    python -m surya_tpu_torch.benchmark.recognition [--results_dir DIR] [--max_rows 256] [--synthetic]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import format_table, stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_text_pages
from surya_tpu_torch.benchmark.utils.scoring import overlap_score
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.settings import settings


def parser():
    return stage_parser("Benchmark the recognition model.", max_rows=256)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    rec_predictor = RecognitionPredictor()

    if synthetic:
        images, bboxes, line_text = synthetic_text_pages(max_rows)
    else:
        dataset = load_hf_dataset(settings.RECOGNITION_BENCH_DATASET_NAME, max_rows)
        images = convert_if_not_rgb(list(dataset["image"]))
        bboxes = list(dataset["bboxes"])
        line_text = list(dataset["text"])

    rec_predictor(images[:1], bboxes=bboxes[:1])  # warm-up
    start = time.time()
    predictions = rec_predictor(images, bboxes=bboxes)
    surya_time = time.time() - start

    scores, weights = [], []
    for pred, ref_texts in zip(predictions, line_text):
        s, w, _ = overlap_score([line.text for line in pred.text_lines], ref_texts)
        scores.extend(s)
        weights.extend(w)
    avg_score = sum(scores) / max(1e-6, sum(weights))

    out = {"surya": {"avg_score": avg_score, "time_per_img": surya_time / len(images), "total_time": surya_time}}
    write_results(results_dir, "rec_bench.json", out)
    rows = [[m, v["avg_score"], v["time_per_img"]] for m, v in out.items()]
    print(format_table(rows, ["model", "avg_score", "time/image (s)"]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
