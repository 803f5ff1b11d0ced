"""CRAFT-style heatmap -> text-line boxes, on the host (counterpart of
surya_tpu/detection/heatmap.py; reference: surya/detection/heatmap.py).

Dynamic thresholds from the page's top-10% intensity, connected components
(4-connectivity), per-component dilation, min-area-rect quads: by the C++ op
(native/craft_ops.cpp) with USE_NATIVE_POSTPROCESS, else by OpenCV (the two
enumerate components in other orders). ``boxes_from_stats`` does the same
box arithmetic from the component stats the device reduced
(ops/connected_components.py).
"""

from __future__ import annotations

from typing import List

import cv2
import numpy as np
from PIL import Image

from surya_tpu_torch import native
from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.common.util import clean_boxes
from surya_tpu_torch.detection.affinity import get_vertical_lines
from surya_tpu_torch.detection.schema import TextDetectionResult
from surya_tpu_torch.ops import connected_components as cc
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
    if settings.USE_NATIVE_POSTPROCESS:
        quads, confs = native.extract_boxes(linemap, float(text_threshold), float(low_text))
        max_conf = confs.max() if len(confs) else 0.0
        if max_conf > 0:
            confs = confs / max_conf
        return list(quads), [float(c) for c in confs]

    # the OpenCV path works in float [0, 1]
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


def boxes_from_stats(stats: np.ndarray, n_comp: int, text_threshold: float, page_hw, head_scale: int = 4):
    """CRAFT box arithmetic from the device's component stats (ops/
    connected_components.py), as surya_tpu's. Mirrors the native/OpenCV path
    (reference surya/detection/heatmap.py:27-107): size filter, max-intensity gate,
    rectangular dilation margins with the window clip, rotated rectangle for
    skewed components (principal-axis estimate), near-square snap, clockwise
    corner order. Stats are at 1/head_scale of processor resolution; boxes
    come back at processor resolution.

    Returns (quads [n, 4, 2] float32, confidences [n])."""
    s = head_scale
    map_h, map_w = page_hw
    det, confs = [], []
    for i in range(int(n_comp)):
        row = stats[i]
        area = row[cc.AREA] * s * s
        if area < 10:
            continue
        if row[cc.MAX_VAL] < text_threshold:
            continue
        # source-pixel footprint at processor resolution
        x0, x1 = row[cc.MIN_X] * s, row[cc.MAX_X] * s + (s - 1)
        y0, y1 = row[cc.MIN_Y] * s, row[cc.MAX_Y] * s + (s - 1)
        w, h = x1 - x0 + 1, y1 - y0 + 1
        niter = int(np.sqrt(min(w, h)))
        buffer = 1
        sx, sy = max(0, x0 - niter - buffer), max(0, y0 - niter - buffer)
        ex, ey = min(map_w - 1, x1 + niter + buffer), min(map_h - 1, y1 + niter + buffer)
        ksize = buffer + niter
        lo = ksize // 2
        hi = ksize - 1 - lo

        # principal axis from second moments (area-weighted, head res)
        a = max(row[cc.AREA], 1.0)
        cx, cy = row[cc.SUM_X] / a, row[cc.SUM_Y] / a
        vxx = max(row[cc.SUM_XX] / a - cx * cx, 0.0)
        vyy = max(row[cc.SUM_YY] / a - cy * cy, 0.0)
        vxy = row[cc.SUM_XY] / a - cx * cy
        theta = 0.5 * np.arctan2(2.0 * vxy, vxx - vyy) if (vxx != vyy or vxy != 0) else 0.0

        if abs(theta) < 0.03 or abs(theta - np.pi / 2) < 0.03 or abs(theta + np.pi / 2) < 0.03:
            # axis-aligned: dilation clipped to the window — exact C++ math
            dx0, dx1 = max(sx, x0 - lo), min(ex, x1 + hi)
            dy0, dy1 = max(sy, y0 - lo), min(ey, y1 + hi)
            box = np.array([[dx0, dy0], [dx1, dy0], [dx1, dy1], [dx0, dy1]], np.float32)
        else:
            # rotated: uniform-rectangle extent estimate (L = sqrt(12 var))
            # along the principal axes plus the dilation margin
            tr, ddet = vxx + vyy, vxx * vyy - vxy * vxy
            disc = max(tr * tr / 4 - ddet, 0.0) ** 0.5
            l1, l2 = tr / 2 + disc, max(tr / 2 - disc, 0.0)
            e1 = np.sqrt(12.0 * l1) / 2 * s + ksize / 2 + (s - 1) / 2
            e2 = np.sqrt(12.0 * l2) / 2 * s + ksize / 2 + (s - 1) / 2
            ratio = max(e1, e2) / (min(e1, e2) + 1e-5)
            ccx, ccy = cx * s + (s - 1) / 2, cy * s + (s - 1) / 2
            if abs(1 - ratio) <= 0.1:
                dx0, dx1 = max(sx, x0 - lo), min(ex, x1 + hi)
                dy0, dy1 = max(sy, y0 - lo), min(ey, y1 + hi)
                box = np.array([[dx0, dy0], [dx1, dy0], [dx1, dy1], [dx0, dy1]], np.float32)
            else:
                ux, uy = np.cos(theta), np.sin(theta)
                px, py = -uy, ux
                box = np.array(
                    [
                        [ccx - ux * e1 - px * e2, ccy - uy * e1 - py * e2],
                        [ccx + ux * e1 - px * e2, ccy + uy * e1 - py * e2],
                        [ccx + ux * e1 + px * e2, ccy + uy * e1 + py * e2],
                        [ccx - ux * e1 + px * e2, ccy - uy * e1 + py * e2],
                    ],
                    np.float32,
                )

        # clockwise winding, then start at the top-left-most corner
        ux_, uy_ = box[1] - box[0]
        vx_, vy_ = box[3] - box[0]
        if ux_ * vy_ - uy_ * vx_ < 0:
            box[[1, 3]] = box[[3, 1]]
        start = box.sum(axis=1).argmin()
        box = np.roll(box, 4 - start, 0)
        det.append(box)
        confs.append(float(row[cc.MAX_VAL]))

    if confs:
        max_conf = max(confs)
        if max_conf > 0:
            confs = [c / max_conf for c in confs]
    return det, confs


def get_boxes_from_stats_result(page, orig_sizes) -> TextDetectionResult:
    """A page's TextDetectionResult from its device stats (the stats-path
    counterpart of parallel_get_boxes): page holds "stats", "n_comp",
    "text_threshold" and "page_hw" (the stitched page at processor width)."""
    quads, confs = boxes_from_stats(
        page["stats"], page["n_comp"], page["text_threshold"], page["page_hw"]
    )
    boxes = [PolygonBox(polygon=q, confidence=c) for q, c in zip(quads, confs)]
    heat_h, heat_w = page["page_hw"]
    for box in boxes:
        box.rescale((heat_w, heat_h), orig_sizes)
        box.fit_to_bounds([0, 0, orig_sizes[0], orig_sizes[1]])
    boxes = clean_boxes(boxes)
    for box in boxes:
        if box.height < 3 * box.width:
            box.expand(x_margin=0, y_margin=settings.DETECTOR_BOX_Y_EXPAND_MARGIN)
            box.fit_to_bounds([0, 0, orig_sizes[0], orig_sizes[1]])
    return TextDetectionResult(
        bboxes=boxes,
        vertical_lines=[],
        heatmap=None,
        affinity_map=None,
        image_bbox=[0, 0, orig_sizes[0], orig_sizes[1]],
    )


def parallel_get_lines(preds, orig_sizes, include_maps=False) -> TextDetectionResult:
    if len(preds) < 2:
        raise ValueError(
            "parallel_get_lines needs both heatmap and affinity channels — "
            "run detection with include_maps=True (the default transfer ships "
            "only the text channel)"
        )
    heatmap, affinity_map = preds
    heat_img = aff_img = None
    if include_maps:
        heat_img = _map_to_image(heatmap)
        aff_img = _map_to_image(affinity_map)
    if affinity_map.dtype == np.uint8:
        affinity_map = affinity_map.astype(np.float32) / 255.0

    affinity_size = list(reversed(affinity_map.shape))
    heatmap_size = list(reversed(heatmap.shape))
    bboxes = get_and_clean_boxes(heatmap, heatmap_size, orig_sizes)
    vertical_lines = get_vertical_lines(affinity_map, affinity_size, orig_sizes)

    return TextDetectionResult(
        bboxes=bboxes,
        vertical_lines=vertical_lines,
        heatmap=heat_img,
        affinity_map=aff_img,
        image_bbox=[0, 0, orig_sizes[0], orig_sizes[1]],
    )
