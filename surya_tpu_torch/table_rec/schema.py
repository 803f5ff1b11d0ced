"""Table recognition output schemas (the port's copy of
surya_tpu/table_rec/schema.py).

Class and field names mirror the reference's public result types
(surya/table_rec/schema.py) — the drop-in API contract. Each unit is a
PolygonBox subclass, so rows/cols/cells carry the full geometry op set; the
`label` properties feed the debug renderer's box captions.
"""

from typing import List, Optional

from pydantic import BaseModel

from surya_tpu_torch.common.polygon import PolygonBox


class TableRow(PolygonBox):
    """A detected table row (pass-1 output)."""

    row_id: int
    is_header: bool

    @property
    def label(self):
        return f"Row {self.row_id}"


class TableCol(PolygonBox):
    """A detected table column (pass-1 output)."""

    col_id: int
    is_header: bool

    @property
    def label(self):
        return f"Column {self.col_id}"


class TableCell(PolygonBox):
    """A grid cell (pass-2 output). `unmerged` cells are the raw per-row
    spans; merged cells carry rowspan/merge flags from grid assembly.
    text_lines is filled by callers that intersect OCR results in."""

    row_id: int
    colspan: int
    within_row_id: int
    cell_id: int
    is_header: bool
    rowspan: Optional[int] = None
    merge_up: bool = False
    merge_down: bool = False
    col_id: Optional[int] = None
    text_lines: Optional[List[dict]] = None

    @property
    def label(self):
        return f"Cell {self.cell_id} {self.rowspan}/{self.colspan}"


class TableResult(BaseModel):
    """Per-table result: merged + unmerged cell grids, rows, cols, bbox."""

    cells: List[TableCell]
    unmerged_cells: List[TableCell]
    rows: List[TableRow]
    cols: List[TableCol]
    image_bbox: List[float]
