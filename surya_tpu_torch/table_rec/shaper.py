"""Label vector <-> dict conversion for table rec (the port's copy of
surya_tpu/table_rec/shaper.py; reference:
surya/table_rec/shaper.py:8-145)."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from surya_tpu_torch.models.table_rec_model import BOX_DIM, BOX_PROPERTIES, SPECIAL_TOKENS


class LabelShaper:
    def __init__(self):
        self.property_keys = [k for (k, _, _) in BOX_PROPERTIES]

    def dict_to_labels(self, components: List[dict]) -> List[List[float]]:
        if not components:
            return []
        out = []
        for comp in components:
            bbox = comp["bbox"]
            for i in range(len(bbox)):
                bbox[i] = min(max(bbox[i], 0), BOX_DIM)
            vector = []
            for k, kcount, mode in BOX_PROPERTIES:
                item = comp[k]
                if isinstance(item, (list, tuple)):
                    vector += list(item)
                else:
                    if mode == "classification":
                        item += SPECIAL_TOKENS
                    vector.append(item)
            out.append(vector)
        return out

    def component_idx(self, key):
        idx = 0
        for k, kcount, mode in BOX_PROPERTIES:
            incr = kcount if mode == "regression" else 1
            if k == key:
                return (idx, idx + incr)
            idx += incr
        raise ValueError(f"unknown property {key}")

    def convert_polygons_to_bboxes(self, components: List[Dict]) -> List[Dict]:
        """4-corner polygon → (cx, cy, w, h, xskew+512, yskew+512)."""
        for comp in components:
            poly = np.clip(comp["polygon"], 0, BOX_DIM)
            (x1, y1), (x2, y2), (x3, y3), (x4, y4) = poly
            cx = (x1 + x2 + x3 + x4) / 4
            cy = (y1 + y2 + y3 + y4) / 4
            width = (x2 + x3) / 2 - (x1 + x4) / 2
            height = (y3 + y4) / 2 - (y2 + y1) / 2
            x_skew = (x3 + x4) / 2 - (x1 + x2) / 2 + BOX_DIM // 2
            y_skew = (y2 + y3) / 2 - (y1 + y4) / 2 + BOX_DIM // 2
            comp["bbox"] = [cx, cy, width, height, x_skew, y_skew]
        return components

    def convert_bbox_to_polygon(self, box, skew_scaler=BOX_DIM // 2, skew_min=0.001):
        cx, cy, width, height = box[0], box[1], box[2], box[3]
        x1, y1 = cx - width / 2, cy - height / 2
        x2, y2 = cx + width / 2, cy + height / 2
        skew_x = math.floor((box[4] - skew_scaler) / 2)
        skew_y = math.floor((box[5] - skew_scaler) / 2)
        if abs(skew_x) < skew_min:
            skew_x = 0
        if abs(skew_y) < skew_min:
            skew_y = 0
        quad = [
            x1 - skew_x, y1 - skew_y, x2 - skew_x, y1 + skew_y,
            x2 + skew_x, y2 + skew_y, x1 + skew_x, y2 - skew_y,
        ]
        return [[quad[2 * i], quad[2 * i + 1]] for i in range(4)]
