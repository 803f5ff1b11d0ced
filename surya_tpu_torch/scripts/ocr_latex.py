"""OCR LaTeX equations: each page (or image) is one block, recognized
whole with the ``block_without_boxes`` task (counterpart of
surya_tpu/scripts/ocr_latex.py; the same options and results.json layout,
one ``{"equation": ...}`` row a page).

    python -m surya_tpu_torch.scripts.ocr_latex <input_path> [--output_dir DIR]
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.recognition.tokenizer import TaskNames
from surya_tpu_torch.scripts.config import CLILoader, parse_args, parser, write_results_json

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> None:
    options = parse_args(parser("OCR LaTeX equations."), argv)
    # the pages are not rasterized a second time at highres: the whole page
    # is the block
    loader = CLILoader(options.pop("input_path"), options)
    predictor = RecognitionPredictor()

    start = time.time()
    results = predictor(
        loader.images,
        [TaskNames.block_without_boxes] * len(loader.images),
        bboxes=[[[0, 0, im.width, im.height]] for im in loader.images],
    )
    logger.debug("LaTeX OCR took %.2f seconds", time.time() - start)

    write_results_json(loader.result_path, loader.names, results,
                       to_row=lambda pred: {"equation": pred.text_lines[0].text})
    logger.info("Wrote results to %s", loader.result_path)


if __name__ == "__main__":
    main()
