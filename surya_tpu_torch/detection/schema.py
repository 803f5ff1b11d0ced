"""Detection output schemas (the port's copy of surya_tpu/detection/schema.py;
reference: surya/detection/schema.py)."""

from typing import Any, List, Optional

from pydantic import BaseModel

from surya_tpu_torch.common.polygon import PolygonBox


class ColumnLine(PolygonBox):
    vertical: bool
    horizontal: bool


class TextDetectionResult(BaseModel):
    bboxes: List[PolygonBox]
    vertical_lines: List[ColumnLine]
    heatmap: Optional[Any] = None
    affinity_map: Optional[Any] = None
    image_bbox: List[float]
