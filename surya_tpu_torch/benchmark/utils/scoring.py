"""Fuzzy text scoring of the port's stages (the port's copy of
benchmark/utils/scoring.py, the reference's definition: the best fuzzy match
per predicted line, weighted by the square root of the reference's length).

``ratio`` is the normalised Indel similarity that the JAX stages take from
``rapidfuzz.fuzz.ratio``, and ``levenshtein`` the edit distance of texify's
score. Both are bit-parallel over Python ints, one machine word step per
character of the second string: Hyyrö's LCS (the Indel distance is the two
lengths less twice the LCS) and Myers' edit distance in Hyyrö's form. A
plain dynamic program would take about 1.6e9 cell steps for the recognition
stage's 256 pages.
"""

from __future__ import annotations

import math
from typing import Dict, List


def _char_masks(s: str) -> Dict[str, int]:
    """For each character, the bit set of its positions in ``s``."""
    masks: Dict[str, int] = {}
    for i, ch in enumerate(s):
        masks[ch] = masks.get(ch, 0) | (1 << i)
    return masks


def lcs_length(a: str, b: str) -> int:
    """Length of the longest common subsequence (Hyyrö 2004)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    full = (1 << len(a)) - 1
    masks = _char_masks(a)
    v = full
    for ch in b:
        u = v & masks.get(ch, 0)
        v = ((v + u) | (v - u)) & full
    return len(a) - bin(v).count("1")


def ratio(a: str, b: str, score_cutoff: float = 0.0) -> float:
    """``100 * (1 - indel(a, b) / (len(a) + len(b)))``, 100 for two empty
    strings, 0 where it falls below ``score_cutoff`` (in percent): the
    arithmetic of ``rapidfuzz.fuzz.ratio``, in its order, so that the two
    round alike at the cutoff."""
    total = len(a) + len(b)
    if total == 0:
        return 100.0
    norm_sim = 1.0 - (total - 2 * lcs_length(a, b)) / total
    return norm_sim * 100 if norm_sim >= score_cutoff / 100 else 0.0


def levenshtein(a: str, b: str) -> int:
    """Edit distance with unit insertions, deletions and substitutions
    (Myers 1999, Hyyrö's formulation)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    full = (1 << len(a)) - 1
    last = 1 << (len(a) - 1)
    masks = _char_masks(a)
    vp, vn, score = full, 0, len(a)
    for ch in b:
        eq = masks.get(ch, 0)
        xv = eq | vn
        xh = ((((eq & vp) + vp) & full) ^ vp) | eq
        hp = vn | (~(xh | vp) & full)
        hn = vp & xh
        if hp & last:
            score += 1
        elif hn & last:
            score -= 1
        hp = ((hp << 1) | 1) & full
        hn = (hn << 1) & full
        vp = hn | (~(xv | hp) & full)
        vn = hp & xv
    return score


def overlap_score(pred_lines: List[str], reference_lines: List[str]):
    line_scores, line_weights, line_match = [], [], {}
    for i, pred_line in enumerate(pred_lines):
        best, weight, match = 0.0, 1.0, None
        for j, ref_line in enumerate(reference_lines):
            score = ratio(pred_line, ref_line, score_cutoff=20) / 100
            if score > best:
                best = score
                weight = math.sqrt(len(ref_line))
                match = j
        line_scores.append(best * weight)
        line_weights.append(weight)
        line_match[i] = match
    return line_scores, line_weights, line_match


def overlap_score_exact(pred_lines: List[str], reference_lines: List[str]):
    assert len(pred_lines) == len(reference_lines)
    line_scores, line_weights = [], []
    for pred_line, ref_line in zip(pred_lines, reference_lines):
        score = ratio(pred_line, ref_line, score_cutoff=20) / 100
        weight = math.sqrt(len(ref_line))
        line_scores.append(score * weight)
        line_weights.append(weight)
    return line_scores, line_weights
