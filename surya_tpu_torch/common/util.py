"""Box utilities shared across predictors (the port's copy of
surya_tpu/common/util.py; reference: surya/common/util.py)."""

from __future__ import annotations

import copy
from typing import List

from surya_tpu_torch.common.polygon import PolygonBox


def clean_boxes(boxes: List[PolygonBox]) -> List[PolygonBox]:
    """Drop degenerate boxes and boxes fully contained in a different box
    (reference semantics: surya/common/util.py:9-36)."""
    kept = []
    bboxes = [b.bbox for b in boxes]
    for i, box_obj in enumerate(boxes):
        xs = [pt[0] for pt in box_obj.polygon]
        ys = [pt[1] for pt in box_obj.polygon]
        if max(xs) == min(xs) or max(ys) == min(ys):
            continue

        box = bboxes[i]
        contained = False
        for j, other_obj in enumerate(boxes):
            if other_obj.polygon == box_obj.polygon:
                continue
            other = bboxes[j]
            if box == other:
                continue
            if box[0] >= other[0] and box[1] >= other[1] and box[2] <= other[2] and box[3] <= other[3]:
                contained = True
                break
        if not contained:
            kept.append(box_obj)
    return kept


def rescale_bbox(bbox: List[float], processor_size, image_size) -> List[float]:
    sx = image_size[0] / processor_size[0]
    sy = image_size[1] / processor_size[1]
    out = copy.deepcopy(bbox)
    out[0] = int(out[0] * sx)
    out[1] = int(out[1] * sy)
    out[2] = int(out[2] * sx)
    out[3] = int(out[3] * sy)
    return out


def expand_bbox(bbox: List[float], expansion_factor: float = 0.01) -> List[float]:
    lo = 1 - expansion_factor
    hi = 1 + expansion_factor
    return [bbox[0] * lo, bbox[1] * lo, bbox[2] * hi, bbox[3] * hi]
