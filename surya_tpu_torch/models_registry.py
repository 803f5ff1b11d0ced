"""Predictor registry of the port (counterpart of surya_tpu/models_registry.py)."""

from __future__ import annotations

from typing import Optional


def load_predictors(checkpoints: Optional[dict] = None, *, device=None, tiny: bool = False) -> dict:
    """Build all five predictors on `device`, under the JAX package's keys
    (detection, recognition, layout, table_rec, ocr_error). checkpoints: an
    optional checkpoint per key; loading one is not ported yet, so a given
    checkpoint raises NotImplementedError."""
    from surya_tpu_torch.detection import DetectionPredictor
    from surya_tpu_torch.layout import LayoutPredictor
    from surya_tpu_torch.ocr_error import OCRErrorPredictor
    from surya_tpu_torch.recognition import RecognitionPredictor
    from surya_tpu_torch.table_rec import TableRecPredictor

    checkpoints = checkpoints or {}
    return {
        "layout": LayoutPredictor(checkpoints.get("layout"), tiny, device=device),
        "ocr_error": OCRErrorPredictor(checkpoints.get("ocr_error"), tiny, device=device),
        "recognition": RecognitionPredictor(checkpoints.get("recognition"), tiny, device=device),
        "detection": DetectionPredictor(checkpoints.get("detection"), tiny, device=device),
        "table_rec": TableRecPredictor(checkpoints.get("table_rec"), tiny, device=device),
    }
