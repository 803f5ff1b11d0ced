"""4-corner polygon geometry used by every output schema (the port's copy of
surya_tpu/common/polygon.py).

Behavioral parity with the reference's PolygonBox (surya/common/polygon.py:9-201)
— e.g. `rescale` truncates to int, `intersection_pct` normalizes by self.area —
because downstream benchmark metrics depend on these exact semantics.
"""

from __future__ import annotations

import numbers
from typing import List, Optional

import numpy as np
from pydantic import BaseModel, computed_field, field_validator

Corner = List[float]


class PolygonBox(BaseModel):
    polygon: List[Corner]
    confidence: Optional[float] = None

    @field_validator("polygon", mode="before")
    @classmethod
    def _coerce_polygon(cls, value):
        if isinstance(value, np.ndarray):
            if value.shape == (4, 2):
                return value.tolist()
        elif isinstance(value, (list, tuple)) and len(value) == 4:
            if all(isinstance(v, numbers.Number) for v in value):
                x0, y0, x1, y1 = (float(v) for v in value)
                return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]
            if all(isinstance(pt, (list, tuple)) and len(pt) == 2 for pt in value):
                return [[float(c) for c in pt] for pt in value]
        raise ValueError(
            "polygon must be a bbox [x0, y0, x1, y1] or four (x, y) corners; "
            f"got {value!r}"
        )

    @computed_field
    @property
    def bbox(self) -> List[float]:
        xs = [pt[0] for pt in self.polygon]
        ys = [pt[1] for pt in self.polygon]
        return [min(xs), min(ys), max(xs), max(ys)]

    @property
    def width(self) -> float:
        b = self.bbox
        return b[2] - b[0]

    @property
    def height(self) -> float:
        b = self.bbox
        return b[3] - b[1]

    @property
    def area(self) -> float:
        return self.width * self.height

    @property
    def center(self) -> List[float]:
        b = self.bbox
        return [(b[0] + b[2]) / 2, (b[1] + b[3]) / 2]

    def rescale(self, processor_size, image_size):
        """Scale corners from processor space to image space (int-truncated)."""
        sx = image_size[0] / processor_size[0]
        sy = image_size[1] / processor_size[1]
        for pt in self.polygon:
            pt[0] = int(pt[0] * sx)
            pt[1] = int(pt[1] * sy)

    def round(self, divisor):
        for pt in self.polygon:
            pt[0] = int(pt[0] / divisor) * divisor
            pt[1] = int(pt[1] / divisor) * divisor

    def fit_to_bounds(self, bounds):
        self.polygon = [
            [
                max(min(pt[0], bounds[2]), bounds[0]),
                max(min(pt[1], bounds[3]), bounds[1]),
            ]
            for pt in self.polygon
        ]

    def clamp(self, bbox: List[float]):
        for pt in self.polygon:
            pt[0] = max(min(pt[0], bbox[2]), bbox[0])
            pt[1] = max(min(pt[1], bbox[3]), bbox[1])

    def shift(self, x_shift: float | None = None, y_shift: float | None = None):
        for pt in self.polygon:
            if x_shift is not None:
                pt[0] += x_shift
            if y_shift is not None:
                pt[1] += y_shift

    def merge(self, other: "PolygonBox"):
        a, b = self.bbox, other.bbox
        x0, y0 = min(a[0], b[0]), min(a[1], b[1])
        x1, y1 = max(a[2], b[2]), max(a[3], b[3])
        self.polygon = [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]

    def merge_left(self, other: "PolygonBox"):
        x0 = min(self.bbox[0], other.bbox[0])
        self.polygon[0][0] = x0
        self.polygon[3][0] = x0

    def merge_right(self, other: "PolygonBox"):
        x1 = max(self.bbox[2], other.bbox[2])
        self.polygon[1][0] = x1
        self.polygon[2][0] = x1

    def expand(self, x_margin: float, y_margin: float):
        dx = x_margin * self.width
        dy = y_margin * self.height
        signs = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
        self.polygon = [
            [int(pt[0] + sx * dx), int(pt[1] + sy * dy)]
            for pt, (sx, sy) in zip(self.polygon, signs)
        ]

    def x_overlap(self, other: "PolygonBox", x_margin=0) -> float:
        a, b = self.bbox, other.bbox
        return max(0, min(a[2] + x_margin, b[2] + x_margin) - max(a[0] - x_margin, b[0] - x_margin))

    def y_overlap(self, other: "PolygonBox", y_margin=0) -> float:
        a, b = self.bbox, other.bbox
        return max(0, min(a[3] + y_margin, b[3] + y_margin) - max(a[1] - y_margin, b[1] - y_margin))

    def intersection_area(self, other: "PolygonBox", x_margin=0, y_margin=0) -> float:
        return self.x_overlap(other, x_margin) * self.y_overlap(other, y_margin)

    def intersection_pct(self, other: "PolygonBox", x_margin=0, y_margin=0) -> float:
        assert 0 <= x_margin <= 1 and 0 <= y_margin <= 1
        if self.area == 0:
            return 0
        if x_margin:
            x_margin = int(min(self.width, other.width) * x_margin)
        if y_margin:
            y_margin = int(min(self.height, other.height) * y_margin)
        return self.intersection_area(other, x_margin, y_margin) / self.area

    def intersection_polygon(self, other: "PolygonBox") -> List[Corner]:
        s, o = self.polygon, other.polygon
        # corner-wise inner rectangle: max on the low sides, min on the high
        ops = [(max, max), (min, max), (min, min), (max, min)]
        return [
            [fx(s[i][0], o[i][0]), fy(s[i][1], o[i][1])]
            for i, (fx, fy) in enumerate(ops)
        ]

    def distance(self, other: "PolygonBox") -> float:
        c, d = self.center, other.center
        return ((c[0] - d[0]) ** 2 + (c[1] - d[1]) ** 2) ** 0.5

    def __hash__(self):
        return hash(tuple(self.bbox))
