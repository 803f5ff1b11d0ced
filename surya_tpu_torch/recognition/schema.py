"""Recognition output schemas (the port's copy of surya_tpu/recognition/schema.py).

Class and field names mirror the reference's public result types
(surya/recognition/schema.py:1-40) — they ARE the API contract a drop-in
caller consumes (`result.text_lines[i].chars[j].bbox` etc.). Everything is a
polygon-carrying pydantic model, so each text unit inherits the full
PolygonBox op set (bbox/area/rescale/intersection).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
from pydantic import BaseModel, field_validator

from surya_tpu.common.polygon import PolygonBox


class BaseChar(PolygonBox):
    """A positioned text unit. Confidence is sanitized at construction:
    None/NaN (padding rows, killed slots) collapse to 0 so downstream JSON
    serialization and sorting never see NaN."""

    text: str
    confidence: Optional[float] = 0

    @field_validator("confidence", mode="before")
    @classmethod
    def _nan_to_zero(cls, v):
        bad = v is None or (isinstance(v, float) and (math.isnan(v) or np.isnan(v)))
        return 0 if bad else v


class TextChar(BaseChar):
    """One character. bbox_valid=False marks chars whose box the model never
    emitted (e.g. math-tag interior) — the polygon is then a placeholder."""

    bbox_valid: bool = True


class TextWord(BaseChar):
    """A whitespace-delimited run of chars with a merged box (built on demand
    by words_from_chars when return_words is set)."""

    bbox_valid: bool = True


class TextLine(BaseChar):
    """One detected line: its own text/box plus per-char detail."""

    chars: List[TextChar]
    original_text_good: bool = False
    words: Optional[List[TextWord]] = None


class OCRResult(BaseModel):
    """Per-page result: lines in reading order + the page bbox."""

    text_lines: List[TextLine]
    image_bbox: List[float]
