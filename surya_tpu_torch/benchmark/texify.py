"""LaTeX OCR (texify) accuracy stage (counterpart of benchmark/texify.py):
the mean normalized edit distance of each image read whole with the
``block_without_boxes`` task, on TEXIFY_BENCHMARK_DATASET or on synthetic
three-line blocks; writes ``texify_bench.json``.

    python -m surya_tpu_torch.benchmark.texify [--results_dir DIR] [--max_rows 128] [--synthetic]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from surya_tpu_torch.benchmark.utils import stage_parser, write_results
from surya_tpu_torch.benchmark.utils.data import load_hf_dataset, synthetic_text_pages
from surya_tpu_torch.benchmark.utils.scoring import levenshtein
from surya_tpu_torch.input.processing import convert_if_not_rgb
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.recognition.tokenizer import TaskNames
from surya_tpu_torch.settings import settings


def normalized_edit_distance(pred: str, ref: str) -> float:
    if not ref:
        return 0.0
    return levenshtein(pred, ref) / max(len(pred), len(ref))


def parser():
    return stage_parser("Benchmark LaTeX OCR (texify task).", max_rows=128)


def run(results_dir: str, max_rows: int, synthetic: bool) -> dict:
    predictor = RecognitionPredictor()
    if synthetic:
        images, _, texts = synthetic_text_pages(max_rows, lines=3, size=(800, 260))
        references = [" ".join(t) for t in texts]
    else:
        dataset = load_hf_dataset(settings.TEXIFY_BENCHMARK_DATASET, max_rows)
        images = convert_if_not_rgb(list(dataset["image"]))
        references = list(dataset["text"])

    tasks = [TaskNames.block_without_boxes] * len(images)
    bboxes = [[[0, 0, im.width, im.height]] for im in images]

    predictor(images[:1], tasks[:1], bboxes=bboxes[:1])  # warm-up
    start = time.time()
    predictions = predictor(images, tasks, bboxes=bboxes)
    total_time = time.time() - start

    dists = [normalized_edit_distance(pred.text_lines[0].text, ref) for pred, ref in zip(predictions, references)]
    mean_dist = sum(dists) / len(dists)

    out = {"scores": mean_dist, "total_time": total_time, "n": len(images)}
    write_results(results_dir, "texify_bench.json", out)
    print(f"normalized edit distance: {mean_dist:.4f} ({total_time:.1f}s total, {len(images)} rows)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parser().parse_args(argv)))


if __name__ == "__main__":
    main()
