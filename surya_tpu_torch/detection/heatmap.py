"""CRAFT-style heatmap -> text-line boxes, on the host (counterpart of
surya_tpu/detection/heatmap.py; reference: surya/detection/heatmap.py).

Dynamic thresholds from the page's top-10% intensity, connected components
(OpenCV, 4-connectivity), per-component dilation, min-area-rect quads. This
is the OpenCV path of the JAX package; its C++ path (native/craft_ops.cpp)
and its on-device component stats are not ported yet.
"""

from __future__ import annotations

from typing import List

import cv2
import numpy as np
from PIL import Image

from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.common.util import clean_boxes
from surya_tpu_torch.detection.schema import TextDetectionResult
from surya_tpu_torch.settings import settings


def get_dynamic_thresholds(linemap, text_threshold, low_text, typical_top10_avg=0.7):
    """Scale thresholds by the page's top-10% mean intensity so washed-out
    scans still segment. Accepts float [0,1] or uint8 (value*255) maps."""
    flat = linemap.ravel()
    top10_start = int(len(flat) * 0.9)
    avg_intensity = np.mean(np.partition(flat, top10_start)[top10_start:])
    if linemap.dtype == np.uint8:
        avg_intensity = avg_intensity / 255.0
    scaling = np.clip(avg_intensity / typical_top10_avg, 0, 1) ** 0.5

    low_text = np.clip(low_text * scaling, 0.1, 0.6)
    text_threshold = np.clip(text_threshold * scaling, 0.15, 0.8)
    return text_threshold, low_text


def detect_boxes(linemap, text_threshold, low_text):
    """Connected-component box extraction (CRAFT-derived). Returns (quads,
    confidences normalised by the page's largest)."""
    img_h, img_w = linemap.shape
    text_threshold, low_text = get_dynamic_thresholds(linemap, text_threshold, low_text)
    if linemap.dtype == np.uint8:
        linemap = linemap.astype(np.float32) / 255.0
    binary = (linemap > low_text).astype(np.uint8)
    label_count, labels, stats, _ = cv2.connectedComponentsWithStats(binary, connectivity=4)

    det: List[np.ndarray] = []
    confidences: List[float] = []
    max_confidence = 0.0

    for k in range(1, label_count):
        size = stats[k, cv2.CC_STAT_AREA]
        if size < 10:
            continue

        x, y, w, h = stats[k, [cv2.CC_STAT_LEFT, cv2.CC_STAT_TOP, cv2.CC_STAT_WIDTH, cv2.CC_STAT_HEIGHT]]
        niter = int(np.sqrt(min(w, h)))
        buffer = 1
        sx, sy = max(0, x - niter - buffer), max(0, y - niter - buffer)
        ex, ey = min(img_w, x + w + niter + buffer), min(img_h, y + h + niter + buffer)

        mask = labels[sy:ey, sx:ex] == k
        line_max = np.max(linemap[sy:ey, sx:ex][mask])
        if line_max < text_threshold:
            continue

        ksize = buffer + niter
        kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (ksize, ksize))
        dilated = cv2.dilate(mask.astype(np.uint8), kernel)

        ys, xs = np.nonzero(dilated)
        points = np.column_stack((xs + sx, ys + sy))
        box = cv2.boxPoints(cv2.minAreaRect(points))

        # near-square quads snap to their axis-aligned bbox
        side_a = np.linalg.norm(box[0] - box[1])
        side_b = np.linalg.norm(box[1] - box[2])
        ratio = max(side_a, side_b) / (min(side_a, side_b) + 1e-5)
        if abs(1 - ratio) <= 0.1:
            left, right = points[:, 0].min(), points[:, 0].max()
            top, bottom = points[:, 1].min(), points[:, 1].max()
            box = np.array([[left, top], [right, top], [right, bottom], [left, bottom]], dtype=np.float32)

        # clockwise order starting at the top-left-most corner
        start = box.sum(axis=1).argmin()
        box = np.roll(box, 4 - start, 0)

        max_confidence = max(max_confidence, float(line_max))
        confidences.append(float(line_max))
        det.append(box)

    if max_confidence > 0:
        confidences = [c / max_confidence for c in confidences]
    return det, confidences


def get_detected_boxes(textmap, text_threshold=None, low_text=None) -> List[PolygonBox]:
    if text_threshold is None:
        text_threshold = settings.DETECTOR_TEXT_THRESHOLD
    if low_text is None:
        low_text = settings.DETECTOR_BLANK_THRESHOLD
    if textmap.dtype not in (np.float32, np.uint8):
        textmap = textmap.astype(np.float32)
    boxes, confidences = detect_boxes(textmap, text_threshold, low_text)
    return [PolygonBox(polygon=box, confidence=conf) for box, conf in zip(boxes, confidences)]


def get_and_clean_boxes(textmap, processor_size, image_size, text_threshold=None, low_text=None) -> List[PolygonBox]:
    boxes = get_detected_boxes(textmap, text_threshold, low_text)
    for box in boxes:
        box.rescale(processor_size, image_size)
        box.fit_to_bounds([0, 0, image_size[0], image_size[1]])
    return clean_boxes(boxes)


def _map_to_image(m: np.ndarray) -> Image.Image:
    return Image.fromarray(m if m.dtype == np.uint8 else (m * 255).astype(np.uint8))


def parallel_get_boxes(preds, orig_sizes, include_maps=False) -> TextDetectionResult:
    """One page's result from its stitched maps (text map first)."""
    heatmap, affinity_map = preds[0], preds[1] if len(preds) > 1 else None
    heat_img = aff_img = None
    if include_maps:
        heat_img = _map_to_image(heatmap)
        if affinity_map is not None:
            aff_img = _map_to_image(affinity_map)

    heatmap_size = list(reversed(heatmap.shape))
    bboxes = get_and_clean_boxes(heatmap, heatmap_size, orig_sizes)
    for box in bboxes:
        if box.height < 3 * box.width:  # skip vertical boxes
            box.expand(x_margin=0, y_margin=settings.DETECTOR_BOX_Y_EXPAND_MARGIN)
            box.fit_to_bounds([0, 0, orig_sizes[0], orig_sizes[1]])

    return TextDetectionResult(
        bboxes=bboxes,
        vertical_lines=[],
        heatmap=heat_img,
        affinity_map=aff_img,
        image_bbox=[0, 0, orig_sizes[0], orig_sizes[1]],
    )
