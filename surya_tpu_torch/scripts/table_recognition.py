"""Recognize table structure in a file or a folder of PDFs or images:
layout finds the tables, the page rasterized at IMAGE_DPI_HIGHRES supplies
the crops, table recognition runs once over all crops, and the results group
back per document with page and table indices (counterpart of
surya_tpu/scripts/table_recognition.py; the same options and results.json
layout).

    python -m surya_tpu_torch.scripts.table_recognition <input_path> [--skip_table_detection] [--output_dir DIR]
"""

from __future__ import annotations

import copy
import json
import logging
import os
from collections import Counter, defaultdict
from typing import Optional, Sequence

from surya_tpu_torch.common.util import expand_bbox, rescale_bbox
from surya_tpu_torch.debug.draw import draw_bboxes_on_image
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.scripts.config import CLILoader, parse_args, parser
from surya_tpu_torch.table_rec import TableRecPredictor

logger = logging.getLogger(__name__)

TABLE_LABELS = ("Table", "TableOfContents")


def crop_tables(loader, layout_predictions, skip_table_detection):
    """Flatten every page's table regions into one crop batch, keeping the
    page index of each crop. With --skip_table_detection each highres page
    is the table."""
    crops, crop_pages = [], []
    for page_idx, layout_pred in enumerate(layout_predictions):
        highres = loader.highres_images[page_idx]
        if skip_table_detection:
            crops.append(highres)
            crop_pages.append(page_idx)
            continue
        lowres_size = loader.images[page_idx].size
        for box in layout_pred.bboxes:
            if box.label not in TABLE_LABELS:
                continue
            highres_bbox = expand_bbox(rescale_bbox(box.bbox, lowres_size, highres.size))
            crops.append(highres.crop(highres_bbox))
            crop_pages.append(page_idx)
    return crops, crop_pages


def save_debug_images(crop, pred, result_path, name, page, table_idx):
    rc_image = draw_bboxes_on_image(
        [r.bbox for r in pred.rows], copy.deepcopy(crop),
        labels=[f"Row {r.row_id}" for r in pred.rows], label_font_size=20, color="blue",
    )
    rc_image = draw_bboxes_on_image(
        [c.bbox for c in pred.cols], rc_image,
        labels=[f"Col {c.col_id}" for c in pred.cols], label_font_size=20, color="red",
    )
    rc_image.save(os.path.join(result_path, f"{name}_page{page}_table{table_idx}_rc.png"))
    cell_image = draw_bboxes_on_image([c.bbox for c in pred.cells], copy.deepcopy(crop), color="green")
    cell_image.save(os.path.join(result_path, f"{name}_page{page}_table{table_idx}_cells.png"))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = parser("Detect and recognize table structure in an input file or folder.")
    p.add_argument("--skip_table_detection", action="store_true",
                   help="Tables are already cropped, so don't re-detect tables.")
    options = parse_args(p, argv)
    skip_table_detection = options.pop("skip_table_detection")
    loader = CLILoader(options.pop("input_path"), options, highres=True)

    layout_predictor = LayoutPredictor()
    table_rec_predictor = TableRecPredictor()

    layout_predictions = layout_predictor(loader.images)
    crops, crop_pages = crop_tables(loader, layout_predictions, skip_table_detection)
    table_preds = table_rec_predictor(crops)

    # page numbers restart at 1 within each document name (a PDF's pages
    # share one name; results.json is keyed by document)
    pages_seen: Counter = Counter()
    page_number = []
    for name in loader.names:
        pages_seen[name] += 1
        page_number.append(pages_seen[name])

    results = defaultdict(list)
    tables_on_page: Counter = Counter()
    for crop, page_idx, pred in zip(crops, crop_pages, table_preds):
        name = loader.names[page_idx]
        table_idx = tables_on_page[page_idx]
        tables_on_page[page_idx] += 1

        out_pred = pred.model_dump()
        out_pred["page"] = page_number[page_idx]
        out_pred["table_idx"] = table_idx
        results[name].append(out_pred)

        if loader.save_images:
            save_debug_images(crop, pred, loader.result_path, name, page_number[page_idx], table_idx)

    with open(os.path.join(loader.result_path, "results.json"), "w+", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False)
    logger.info("Wrote results to %s", loader.result_path)


if __name__ == "__main__":
    main()
