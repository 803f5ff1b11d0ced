"""Detect the layout of a file or a folder of PDFs or images: labelled
blocks in reading order (counterpart of surya_tpu/scripts/detect_layout.py;
the same options and results.json layout).

    python -m surya_tpu_torch.scripts.detect_layout <input_path> [--output_dir DIR] [--images]
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Optional, Sequence

from surya_tpu_torch.debug.draw import draw_polys_on_image
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.scripts.config import CLILoader, parse_args, parser, save_page_artifacts, write_results_json

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> None:
    options = parse_args(parser("Detect layout of an input file or folder (PDFs or images)."), argv)
    loader = CLILoader(options.pop("input_path"), options)
    predictor = LayoutPredictor()  # built outside the timed region

    start = time.time()
    predictions = predictor(loader.images)
    logger.debug("Layout took %.2f seconds", time.time() - start)

    def render(image, pred):
        polys = [p.polygon for p in pred.bboxes]
        labels = [f"{p.label}-{p.position}" for p in pred.bboxes]
        yield "layout", draw_polys_on_image(polys, copy.deepcopy(image), labels=labels)

    save_page_artifacts(loader, predictions, render)
    write_results_json(loader.result_path, loader.names, predictions)
    logger.info("Wrote results to %s", loader.result_path)


if __name__ == "__main__":
    main()
