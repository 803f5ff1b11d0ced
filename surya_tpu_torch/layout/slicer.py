"""Oversized-page tiling for layout (the port's copy of surya_tpu/layout/slicer.py).

Pages above slice_min are cut along their long axis into ≤max_slices tiles;
results are re-joined with overlap- and label-aware box merging.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from PIL import Image

from surya_tpu_torch.layout.schema import LayoutResult

TilePositions = List[Tuple[int, int, int]]


class ImageSlicer:
    merge_tolerance = 0.05
    merge_margin = 0.05

    def __init__(self, slice_min_dims, slice_sizes, max_slices: int = 4):
        self.slice_min_dims = slice_min_dims
        self.slice_sizes = slice_sizes
        self.max_slices = max_slices

    def _slice_size(self, dimension: int, dim_type: str) -> int:
        return max(self.slice_sizes[dim_type], dimension // self.max_slices + 1)

    def slice_count(self, image: Image.Image) -> int:
        width, height = image.size
        if width > height:
            return math.ceil(width / self._slice_size(width, "width"))
        return math.ceil(height / self._slice_size(height, "height"))

    def slice(self, images: List[Image.Image]) -> Tuple[List[Image.Image], TilePositions]:
        tiles, positions = [], []
        for idx, image in enumerate(images):
            if image.size[0] > self.slice_min_dims["width"] or image.size[1] > self.slice_min_dims["height"]:
                width, height = image.size
                if width > height:
                    step = self._slice_size(width, "width")
                    for i, x in enumerate(range(0, width, step)):
                        tiles.append(image.crop((x, 0, min(x + step, width), height)))
                        positions.append((idx, i, 0))
                else:
                    step = self._slice_size(height, "height")
                    for i, y in enumerate(range(0, height, step)):
                        tiles.append(image.crop((0, y, width, min(y + step, height))))
                        positions.append((idx, 0, i))
            else:
                tiles.append(image)
                positions.append((idx, 0, 0))
        return tiles, positions

    def join(self, results: List[LayoutResult], tile_positions: TilePositions) -> List[LayoutResult]:
        joined: List[LayoutResult] = []
        current = None
        for idx, (result, (image_idx, tile_x, _tile_y)) in enumerate(zip(results, tile_positions)):
            if idx == 0 or image_idx != tile_positions[idx - 1][0]:
                if current is not None:
                    joined.append(current)
                current = result
            else:
                merge_dir = "width" if tile_x > 0 else "height"
                current = self.merge_results(current, result, merge_dir=merge_dir)
        if current is not None:
            joined.append(current)
        return joined

    def merge_results(self, res1: LayoutResult, res2: LayoutResult, merge_dir="width") -> LayoutResult:
        new_image_bbox = res1.image_bbox.copy()
        removed = set()
        axis_idx = 2 if merge_dir == "width" else 3
        new_image_bbox[axis_idx] += res2.image_bbox[axis_idx]
        max_position = max((b.position for b in res1.bboxes), default=-1) + 1

        for i, box2 in enumerate(res2.bboxes):
            if merge_dir == "width":
                box2.shift(x_shift=res1.image_bbox[2])
            else:
                box2.shift(y_shift=res1.image_bbox[3])
            box2.position += max_position
            for box1 in res1.bboxes:
                if merge_dir == "width":
                    overlaps = (
                        box1.intersection_pct(box2, x_margin=self.merge_margin) > self.merge_tolerance
                        or box2.intersection_pct(box1, x_margin=self.merge_margin) > self.merge_tolerance
                    )
                    aligned = (
                        box1.y_overlap(box2) > box1.height // 2
                        or box2.y_overlap(box1) > box2.height // 2
                    )
                else:
                    overlaps = (
                        box1.intersection_pct(box2, y_margin=self.merge_margin) > self.merge_tolerance
                        or box2.intersection_pct(box1, y_margin=self.merge_margin) > self.merge_tolerance
                    )
                    aligned = (
                        box1.x_overlap(box2) > box1.width // 2
                        or box2.x_overlap(box1) > box2.width // 2
                    )
                same_kind = box1.label == box2.label or (
                    box1.label in ("Picture", "Figure") and box2.label in ("Picture", "Figure")
                )
                if overlaps and aligned and same_kind:
                    box1.merge(box2)
                    removed.add(i)

        return LayoutResult(
            image_bbox=new_image_bbox,
            bboxes=res1.bboxes + [b for i, b in enumerate(res2.bboxes) if i not in removed],
            sliced=True,
        )
