"""OCR error detection schema (counterpart of surya_tpu/ocr_error/schema.py)."""

from typing import List

from pydantic import BaseModel


class OCRErrorDetectionResult(BaseModel):
    texts: List[str]
    labels: List[str]
