"""Column/vertical line detection from the affinity heatmap (the port's copy
of surya_tpu/detection/affinity.py; reference: surya/detection/affinity.py:97-158)."""

from __future__ import annotations

import math
from typing import List

import cv2
import numpy as np

from surya_tpu_torch.detection.schema import ColumnLine


def get_line_angle(x1, y1, x2, y2) -> float:
    return math.degrees(math.atan((y2 - y1) / (x2 - x1)))


def get_detected_lines_sobel(image: np.ndarray, vertical: bool = True) -> np.ndarray:
    dx, dy = (1, 0) if vertical else (0, 1)
    sobel = np.absolute(cv2.Sobel(image, cv2.CV_32F, dx, dy, ksize=3))
    scaled = np.uint8(255 * sobel / np.max(sobel))

    kernel = np.ones((20, 1), np.uint8)
    eroded = cv2.erode(scaled, kernel, iterations=1)
    return cv2.dilate(eroded, kernel, iterations=3)


def get_detected_lines(image, slope_tol_deg=2, vertical=False, horizontal=False) -> List[ColumnLine]:
    assert not (vertical and horizontal)
    work = image.astype(np.float32) * 255
    if vertical or horizontal:
        work = get_detected_lines_sobel(work, vertical)
    work = work.astype(np.uint8)

    edges = cv2.Canny(work, 150, 200, apertureSize=3)
    max_gap, min_length = (100, 10) if vertical else (10, 4)
    lines = cv2.HoughLinesP(
        edges, 1, np.pi / 180, threshold=150, minLineLength=min_length, maxLineGap=max_gap
    )

    found: List[ColumnLine] = []
    if lines is not None:
        for line in np.asarray(lines).reshape(-1, 4):
            x1, y1, x2, y2 = line
            is_vertical = is_horizontal = False
            if x2 == x1:
                is_vertical = True
            else:
                angle = get_line_angle(x1, y1, x2, y2)
                if 90 - slope_tol_deg < angle < 90 + slope_tol_deg:
                    is_vertical = True
                elif -90 - slope_tol_deg < angle < -90 + slope_tol_deg:
                    is_vertical = True
                elif -slope_tol_deg < angle < slope_tol_deg:
                    is_horizontal = True

            bbox = [float(x1), float(y1), float(x2), float(y2)]
            if bbox[3] < bbox[1]:
                bbox[1], bbox[3] = bbox[3], bbox[1]
            if bbox[2] < bbox[0]:
                bbox[0], bbox[2] = bbox[2], bbox[0]
            found.append(ColumnLine(polygon=bbox, vertical=is_vertical, horizontal=is_horizontal))

    if vertical:
        found = [ln for ln in found if ln.vertical]
    if horizontal:
        found = [ln for ln in found if ln.horizontal]
    return found


def get_vertical_lines(
    image, processor_size, image_size, divisor=20, x_tolerance=40, y_tolerance=20
) -> List[ColumnLine]:
    lines = get_detected_lines(image, vertical=True)
    for line in lines:
        line.rescale(processor_size, image_size)
    lines = sorted(lines, key=lambda ln: ln.bbox[0])
    for line in lines:
        line.round(divisor)

    # NOTE: the reference (surya/detection/affinity.py:107-155) "extends" the
    # surviving segment by assigning into line.bbox — but bbox is a computed
    # property there, so those writes are silent no-ops. Only the segment
    # REMOVAL is observable; we reproduce exactly that behavior.

    def _y_overlap(a, b, pad=0):
        # integer-range intersection semantics (reference builds sets of ints)
        return max(int(a.bbox[1]) - pad, int(b.bbox[1])) < min(int(a.bbox[3]) + pad, int(b.bbox[3]))

    # drop earlier segment when a later one shares its x and overlaps in y
    to_remove = set()
    for i, a in enumerate(lines):
        for j in range(i + 1, len(lines)):
            b = lines[j]
            if a.bbox[0] == b.bbox[0] and _y_overlap(a, b, pad=y_tolerance):
                to_remove.add(i)
    lines = [ln for i, ln in enumerate(lines) if i not in to_remove]

    # drop the shorter of two segments close in x with overlapping y
    to_remove = set()
    for i, a in enumerate(lines):
        if i in to_remove:
            continue
        for j in range(i + 1, len(lines)):
            if j in to_remove:
                continue
            b = lines[j]
            if abs(a.bbox[0] - b.bbox[0]) < x_tolerance and _y_overlap(a, b):
                len_a = int(a.bbox[3]) - int(a.bbox[1])
                len_b = int(b.bbox[3]) - int(b.bbox[1])
                to_remove.add(i if len_b > len_a else j)
    return [ln for i, ln in enumerate(lines) if i not in to_remove]
