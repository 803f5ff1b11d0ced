"""OCR the text of a file or a folder of PDFs or images: detection, then
recognition of the lines sliced from the pages rasterized at
IMAGE_DPI_HIGHRES (counterpart of surya_tpu/scripts/ocr_text.py; the same
options and results.json layout).

    python -m surya_tpu_torch.scripts.ocr_text <input_path> [--task_name T] [--disable_math] [--output_dir DIR]
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

from surya_tpu_torch.debug.draw import draw_text_on_image
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.recognition.tokenizer import TaskNames
from surya_tpu_torch.scripts.config import CLILoader, parse_args, parser, save_page_artifacts, write_results_json

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = parser("OCR text in an input file or folder (PDFs or images).")
    p.add_argument("--task_name", default=TaskNames.ocr_with_boxes)
    p.add_argument("--disable_math", action="store_true", help="Do not recognize math in OCR.")
    options = parse_args(p, argv)
    task_name, disable_math = options.pop("task_name"), options.pop("disable_math")
    loader = CLILoader(options.pop("input_path"), options, highres=True)
    rec_predictor = RecognitionPredictor()  # built outside the timed region
    det_predictor = DetectionPredictor()

    start = time.time()
    predictions = rec_predictor(
        loader.images,
        task_names=[task_name] * len(loader.images),
        det_predictor=det_predictor,
        highres_images=loader.highres_images,
        math_mode=not disable_math,
    )
    logger.debug("OCR took %.2f seconds", time.time() - start)

    def render(image, pred):
        lines = pred.text_lines
        yield "text", draw_text_on_image([ln.bbox for ln in lines], [ln.text for ln in lines], image.size)

    save_page_artifacts(loader, predictions, render)
    write_results_json(loader.result_path, loader.names, predictions)
    logger.info("Wrote results to %s", loader.result_path)


if __name__ == "__main__":
    main()
