"""Detect text lines in a file or a folder of PDFs or images, with the
port's DetectionPredictor (counterpart of surya_tpu/scripts/detect_text.py;
the same options and results.json layout).

    python -m surya_tpu_torch.scripts.detect_text <input_path> [--output_dir DIR] [--images] [-d]
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Optional, Sequence

from surya_tpu_torch.debug.draw import draw_polys_on_image
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.scripts.config import CLILoader, parse_args, parser, save_page_artifacts, write_results_json

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> None:
    options = parse_args(parser("Detect text line bboxes in an input file or folder (PDFs or images)."), argv)
    loader = CLILoader(options.pop("input_path"), options)
    predictor = DetectionPredictor()  # built outside the timed region

    start = time.time()
    predictions = predictor(loader.images, include_maps=loader.debug)
    logger.debug("Detection took %.2f seconds", time.time() - start)

    def render(image, pred):
        yield "bbox", draw_polys_on_image([p.polygon for p in pred.bboxes], copy.deepcopy(image))
        if loader.debug:
            yield "heat", pred.heatmap

    save_page_artifacts(loader, predictions, render)
    write_results_json(loader.result_path, loader.names, predictions, exclude=["heatmap", "affinity_map"])
    logger.info("Wrote results to %s", loader.result_path)


if __name__ == "__main__":
    main()
