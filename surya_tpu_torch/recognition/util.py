"""Recognition host-side utilities (the port's copy of the parts of
surya_tpu/recognition/util.py that the recognition path uses)."""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.recognition.schema import TextChar, TextLine, TextWord

MATH_SYMBOLS = ["+", "-", "*", "=", "^", "_", "\\", "{", "}"]


def unwrap_math(text: str) -> str:
    """Strip <math> wrappers from short runs that contain no LaTeX commands
    (false math detections; reference :14-31)."""
    if len(text) > 50:
        return text
    if (
        re.match(r'^\s*<math(?:\s+display="inline")?.*?</math>\s*$', text, re.DOTALL)
        and text.count("<math") == 1
        and not any(s in text for s in MATH_SYMBOLS)
    ):
        text = re.sub(r"<math.*?>", "", text)
        text = re.sub(r"</math>", "", text)
    return text


_MATH_BLOCK = re.compile(r"(<math\b[^>]*>)(.*?)</math>", flags=re.I | re.S)
_STRIP_TAGS = re.compile(r"</?(?:br|u|del|mark|i|b|sup|sub)\b[^>]*>", flags=re.I | re.S)


def clean_math_tags(html: str) -> str:
    """Remove formatting tags inside math blocks and orphan </math> closers
    (reference :33-57)."""

    def _inner(m):
        inner = _STRIP_TAGS.sub("", m.group(2))
        return f"{m.group(1)}{inner}</math>" if inner.strip() else ""

    cleaned = _MATH_BLOCK.sub(_inner, html)

    depth = 0
    parts = []
    for token in re.split(r"(</?math[^>]*>)", cleaned, flags=re.I):
        low = token.lower()
        if low.startswith("<math"):
            depth += 1
            parts.append(token)
        elif low == "</math>":
            if depth:
                depth -= 1
                parts.append(token)
        else:
            parts.append(token)
    return "".join(parts)


# repeat-detector window (reference :60-70). chunk_stop_scan's tail width,
# length gate, and scan window all derive from this single constant.
def interleave_shard_slots(frees: List[int], shard_block: int) -> List[int]:
    """Free slots in round-robin order over the data shards' blocks of
    `shard_block` slots (surya_tpu recognition.util.interleave_shard_slots):
    the cache splits its slots blockwise over the data axis, and ascending
    order would put every prefill's cache writes on the first shard."""
    if shard_block <= 0:
        return frees
    return sorted(frees, key=lambda s: (s % shard_block, s // shard_block))


REPEAT_WINDOW = 40


def detect_repeat_token(predicted_tokens: List[int], max_repeats: int = REPEAT_WINDOW) -> bool:
    """True when the tail is a short cycle repeated (reference :60-70)."""
    if len(predicted_tokens) < max_repeats:
        return False
    last_n = predicted_tokens[-max_repeats:]
    unique = len(set(last_n))
    if unique > 5:
        return False
    return last_n[-unique:] == last_n[-unique * 2 : -unique]


def chunk_stop_scan(
    ctoks: np.ndarray,
    prior: np.ndarray,
    budget: np.ndarray,
    tails: np.ndarray,
    eos: int,
    pad: int,
    max_repeats: int = 40,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized per-chunk stop detection for the decode scheduler.

    For each row of ``ctoks`` [A, K], find the first step where generation
    must stop: EOS/pad emitted (token kept), token budget filled, or the
    repeat heuristic fires — identical semantics to running
    ``detect_repeat_token`` after appending each token (reference
    surya/recognition/__init__.py:583-595 does this one token at a time).

    prior/budget: [A] tokens already emitted / per-prompt max_tokens.
    tails: [A, max_repeats-1] last history tokens, -1 sentinel padded on the
    left (windows reaching a sentinel are gated out by the length check).
    Returns (any_stop [A] bool, cut [A] last kept step index)."""
    A, K = ctoks.shape
    W = max_repeats
    step = np.arange(1, K + 1)[None, :]
    prior = prior[:, None]
    stop = np.isin(ctoks, (eos, pad)) | (prior + step >= budget[:, None])
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([tails, ctoks], axis=1), W, axis=1
    )  # [A, K, W]: the W-token window ending at each step
    uniq = (np.diff(np.sort(win, -1), axis=-1) != 0).sum(-1) + 1
    rep = np.zeros((A, K), bool)
    for u in range(1, 6):
        m = (win[..., W - u :] == win[..., W - 2 * u : W - u]).all(-1)
        rep |= (uniq == u) & m
    stop |= rep & (prior + step >= W)
    any_stop = stop.any(1)
    cut = np.where(any_stop, stop.argmax(1), K - 1)
    return any_stop, cut


def sort_text_lines(lines: List[TextLine] | List[dict], tolerance: float = 1.25):
    """Approximate reading order: group by rows, sort left-to-right
    (reference :73-96, including its group-key quirk)."""
    vertical_groups = {}
    for line in lines:
        raw = line.bbox[1] if isinstance(line, TextLine) else line["bbox"][1] / tolerance
        key = round(raw) * tolerance
        vertical_groups.setdefault(key, []).append(line)

    sorted_lines = []
    for _, group in sorted(vertical_groups.items()):
        sorted_lines.extend(
            sorted(group, key=lambda x: x.bbox[0] if isinstance(x, TextLine) else x["bbox"][0])
        )
    return sorted_lines


def close_to_previous(polygons: np.ndarray, thresh: float = 0.1) -> np.ndarray:
    """polygons [..., T, 4, 2]: True at [..., t] where polygon t lies within
    thresh of polygon t - 1 in every coordinate, False at t = 0. Multi-token
    characters emit such near-duplicate boxes, and only the first of them is
    kept (reference :99-119, which compares consecutive polygons of a run)."""
    polygons = np.asarray(polygons, np.float64)
    close = np.zeros(polygons.shape[:-2], bool)
    close[..., 1:] = (np.abs(np.diff(polygons, axis=-3)) <= thresh).all(axis=(-2, -1))
    return close


def words_from_chars(chars: List[TextChar], line_box: PolygonBox) -> List[TextWord]:
    """Whitespace-split character stream into words with merged boxes
    (reference :121-152)."""
    words: List[TextWord] = []
    word = None
    for i, char in enumerate(chars):
        if not char.bbox_valid:
            if word:
                words.append(word)
                word = None
            continue
        if not word:
            word = TextWord(**char.model_dump())
            if i == 0:
                word.merge_left(line_box)
        elif not char.text.strip():
            words.append(word)
            word = None
        else:
            word.merge(char)
            word.text = word.text + char.text
            if i == len(chars) - 1:
                word.merge_right(line_box)
    if word:
        words.append(word)
    return words


def prediction_to_polygon_batch(
    preds: np.ndarray,
    img_sizes: List[Tuple[int, int]],
    bbox_scaler: float,
    skew_scaler: float,
    skew_min: float = 0.001,
) -> np.ndarray:
    """Decode (cx, cy, w, h, xskew, yskew) head outputs into skewed quads,
    batched in numpy (reference :155-206 does this in torch on host anyway).

    preds: [B, T, 6]; img_sizes: [(h, w)] per row. Returns [B, T, 4, 2]."""
    sizes = np.asarray(img_sizes, np.float32)
    w_scale = (sizes[:, 1] / bbox_scaler)[:, None, None]
    h_scale = (sizes[:, 0] / bbox_scaler)[:, None, None]

    preds = preds.astype(np.float32)
    cx, cy = preds[:, :, 0], preds[:, :, 1]
    width, height = preds[:, :, 2], preds[:, :, 3]
    x1, y1 = cx - width / 2, cy - height / 2
    x2, y2 = cx + width / 2, cy + height / 2

    skew_x = np.floor((preds[:, :, 4] - skew_scaler) / 2)
    skew_y = np.floor((preds[:, :, 5] - skew_scaler) / 2)
    skew_x[np.abs(skew_x) < skew_min] = 0
    skew_y[np.abs(skew_y) < skew_min] = 0

    polys = np.stack(
        [x1 - skew_x, y1 - skew_y, x2 - skew_x, y1 + skew_y, x2 + skew_x, y2 + skew_y, x1 + skew_x, y2 - skew_y],
        axis=2,
    ).reshape(preds.shape[0], preds.shape[1], 4, 2)
    polys[:, :, :, 0] *= w_scale
    polys[:, :, :, 1] *= h_scale
    return polys
