"""Layout output schemas (the port's copy of surya_tpu/layout/schema.py)."""

from typing import Dict, List, Optional

from pydantic import BaseModel

from surya_tpu_torch.common.polygon import PolygonBox


class LayoutBox(PolygonBox):
    label: str
    position: int
    top_k: Optional[Dict[str, float]] = None


class LayoutResult(BaseModel):
    bboxes: List[LayoutBox]
    image_bbox: List[float]
    sliced: bool = False
