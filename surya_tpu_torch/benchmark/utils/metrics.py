"""Accuracy metrics of the port's stages, in numpy only (the port's copy of
benchmark/utils/metrics.py, the same definitions as the reference's so that
scores compare directly): coverage-based precision/recall with a
double-coverage penalty, penalized mean IoU over greedy box matching, and
pairwise rank accuracy."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def box_area(box) -> float:
    return (box[2] - box[0]) * (box[3] - box[1])


def intersection_area(box1, box2) -> float:
    x_left = max(box1[0], box2[0])
    y_top = max(box1[1], box2[1])
    x_right = min(box1[2], box2[2])
    y_bottom = min(box1[3], box2[3])
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    return (x_right - x_left) * (y_bottom - y_top)


def calculate_iou(box1, box2, box1_only: bool = False) -> float:
    inter = intersection_area(box1, box2)
    union = box_area(box1)
    if not box1_only:
        union += box_area(box2) - inter
    return inter / union if union else 0.0


def match_boxes(preds, references):
    """Greedy IoU matching; unmatched references score -1, unmatched preds 0
    (the reference's penalty scheme)."""
    iou = np.zeros((len(references), len(preds)))
    for i, ref in enumerate(references):
        for j, pred in enumerate(preds):
            iou[i, j] = calculate_iou(ref, pred, box1_only=True)

    order = np.argsort(iou, axis=None)[::-1]
    ref_idx, pred_idx = np.unravel_index(order, iou.shape)

    taken_ref, taken_pred, matches = set(), set(), []
    for i, j in zip(ref_idx, pred_idx):
        if i not in taken_ref and j not in taken_pred:
            val = iou[i, j]
            if val > 0.95:  # tolerate rounding on box edges
                val = 1.0
            matches.append((i, j, val))
            taken_ref.add(i)
            taken_pred.add(j)
    matches += [(i, None, -1.0) for i in set(range(len(references))) - taken_ref]
    matches += [(None, j, 0.0) for j in set(range(len(preds))) - taken_pred]
    return matches


def penalized_iou_score(preds, references) -> float:
    matches = match_boxes(preds, references)
    return sum(m[2] for m in matches) / len(matches)


def coverage(box, other_boxes, penalize_double: bool = False) -> float:
    """Fraction of ``box`` covered by other_boxes; the double-coverage penalty
    subtracts the pairwise overlap of the covering regions (reference
    semantics)."""
    area = box_area(box)
    if area == 0 or len(other_boxes) == 0:
        return 0.0
    others = np.asarray(other_boxes, np.float64)
    x_left = np.maximum(box[0], others[:, 0])
    y_top = np.maximum(box[1], others[:, 1])
    x_right = np.minimum(box[2], others[:, 2])
    y_bottom = np.minimum(box[3], others[:, 3])
    widths = np.maximum(0, x_right - x_left)
    heights = np.maximum(0, y_bottom - y_top)
    inter = widths * heights
    total = inter.sum()

    if penalize_double:
        rects = np.stack([x_left, y_top, x_right, y_bottom], axis=1)[inter > 0]
        double = 0.0
        for a in range(len(rects)):
            for b in range(a + 1, len(rects)):
                double += intersection_area(rects[a], rects[b])
        total -= double
    return float(min(1.0, max(0.0, total) / area))


def precision_recall(preds, references, threshold: float = 0.5, penalize_double: bool = True) -> Dict[str, float]:
    if len(references) == 0:
        return {"precision": 1, "recall": 1}
    if len(preds) == 0:
        return {"precision": 0, "recall": 0}

    precision_cov = [coverage(p, references, penalize_double) for p in preds]
    recall_cov = [coverage(r, preds) for r in references]
    return {
        "precision": sum(c > threshold for c in precision_cov) / len(preds),
        "recall": sum(c > threshold for c in recall_cov) / len(references),
    }


def mean_coverage(preds, references) -> Dict[str, float]:
    covs = [coverage(r, preds) for r in references] + [coverage(p, references) for p in preds]
    return {"coverage": sum(covs) / len(covs) if covs else 0}


def rank_accuracy(preds: List[float], references: List[float]) -> float:
    """Share of pairwise order relations the prediction ranks the same way."""
    pairs = set()
    for i in range(len(preds)):
        for j in range(len(preds)):
            if i != j:
                pairs.add((i, j, preds[i] > preds[j]))
    correct = 0
    for i in range(len(references)):
        for j in range(len(references)):
            if i != j and (i, j, references[i] > references[j]) in pairs:
                correct += 1
    return correct / len(pairs) if pairs else 0.0
