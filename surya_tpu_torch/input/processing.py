"""Image slicing/masking for line crops (the port's copy of
surya_tpu/input/processing.py; reference: surya/input/processing.py)."""

from __future__ import annotations

import logging
from typing import List

import cv2
import numpy as np
from PIL import Image

from surya_tpu_torch.settings import settings

logger = logging.getLogger(__name__)


def convert_if_not_rgb(images: List[Image.Image]) -> List[Image.Image]:
    return [img if img.mode == "RGB" else img.convert("RGB") for img in images]


def slice_bboxes_from_image(image: np.ndarray, bboxes) -> List[np.ndarray]:
    lines = []
    for bbox in bboxes:
        b = np.clip(np.asarray(bbox, np.int32), 0, None)
        if b[3] <= b[1]:
            b[3] = b[1] + 1
        if b[2] <= b[0]:
            b[2] = b[0] + 1
        b[2] = min(b[2], image.shape[1])
        b[3] = min(b[3], image.shape[0])
        line = image[b[1] : b[3], b[0] : b[2]].copy()
        if line.size == 0:
            logger.warning("empty line crop for bbox %s", bbox)
        lines.append(line)
    return lines


def slice_polys_from_image(image: np.ndarray, polys) -> List[np.ndarray]:
    if len(polys) >= 8:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:
            return list(pool.map(lambda p: slice_and_pad_poly(image, p), polys))
    return [slice_and_pad_poly(image, poly) for poly in polys]


def slice_and_pad_poly(image_array: np.ndarray, coordinates) -> np.ndarray:
    """Crop a polygon's bbox and whiten pixels outside the polygon
    (reference :64-101)."""
    pts = [(c[0], c[1]) for c in coordinates]
    bbox = [
        min(p[0] for p in pts),
        min(p[1] for p in pts),
        max(p[0] for p in pts),
        max(p[1] for p in pts),
    ]
    cropped = image_array[bbox[1] : bbox[3], bbox[0] : bbox[2]].copy()
    height, width = cropped.shape[:2]
    local = [(x - bbox[0], y - bbox[1]) for x, y in pts]

    if bbox[3] <= bbox[1] or bbox[2] <= bbox[0] or len(local) < 3 or height == 0 or width == 0:
        return cropped

    # axis-aligned rectangles in winding order (the typical detection
    # output) cover their whole bbox — the outside-polygon mask would be a
    # no-op, skip it. Consecutive corners must share an axis so a
    # bowtie-ordered quad (self-intersecting) still gets masked.
    if len(local) == 4:
        xs = sorted(p[0] for p in local)
        ys = sorted(p[1] for p in local)
        spans_bbox = xs[0] == xs[1] == 0 and ys[0] == ys[1] == 0 and xs[2] == xs[3] and ys[2] == ys[3]
        winding = all(
            local[i][0] == local[(i + 1) % 4][0] or local[i][1] == local[(i + 1) % 4][1]
            for i in range(4)
        )
        if spans_bbox and winding:
            return cropped

    try:
        mask = np.zeros(cropped.shape[:2], np.uint8)
        cv2.fillPoly(mask, [np.int32(local)], 1)
        cropped[mask == 0] = settings.RECOGNITION_PAD_VALUE
    except cv2.error as e:
        logger.warning("polygon mask failed: %s", e)
    return cropped
