"""Table structure recognition predictor of the PyTorch port.

Counterpart of surya_tpu/table_rec/__init__.py, with the same outputs. Two
AR passes over each batch of table crops:

  pass 1: the whole-table query -> rows and columns;
  pass 2: one query per row, with every column of the batch as context ->
          the row's spanning cells; its batch doubles up to
          TABLE_REC_CELL_BATCH_MAX rows;

then the grid is assembled on the host (row x column cells, spanning-cell
matching, rowspan merging). The encoder states stay on the device: each
query row reads its crop's states through a gather by ``enc_idx`` there,
never fetched and uploaded again. Prompts are right-padded to
PROMPT_BUCKETS, with the padded rows masked; batches are not padded, since
rows do not interact. On CUDA the predictor runs on a stream of its own.
"""

from __future__ import annotations

import time
from copy import deepcopy
from itertools import chain
from typing import List, Optional

import cv2
import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.models import table_rec_model
from surya_tpu_torch.models.adetr import DoneWatch
from surya_tpu_torch.models.table_rec_model import BOX_DIM, CATEGORY_TO_ID, MERGE_KEYS, MERGE_VALUES, TableRecConfig
from surya_tpu_torch.settings import settings
from surya_tpu_torch.table_rec.loader import load_table_rec_model
from surya_tpu_torch.table_rec.schema import TableCell, TableCol, TableResult, TableRow
from surya_tpu_torch.table_rec.shaper import LabelShaper

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5
PROMPT_BUCKETS = (4, 8, 16, 32, 64, 128)


def install_synthetic_tables(tr: "TableRecPredictor", n_rows: int = 14, n_cols: int = 8,
                             n_cells: int = 8) -> None:
    """Pin a random-weight TableRecPredictor's AR control flow to a table of
    n_rows rows and n_cols columns, with n_cells spanning-cell candidates a
    row, through per-step category overrides. Untrained category logits sit
    within float crumbs of zero, so the same seed flips between no rows and
    max_boxes-step decodes from one machine to the next; the script drives
    the table's shape while every product of the model still runs. The boxes
    stay the model's; only the category stream is pinned."""
    cfg = tr.config
    M = cfg.max_boxes
    row_raw = CATEGORY_TO_ID["Table-row"] + table_rec_model.SPECIAL_TOKENS
    col_raw = CATEGORY_TO_ID["Table-column"] + table_rec_model.SPECIAL_TOKENS
    cell_raw = CATEGORY_TO_ID["Table-cell"] + table_rec_model.SPECIAL_TOKENS
    rowcol = np.full((M,), cfg.eos_token_id, np.int32)
    rowcol[:n_rows] = row_raw
    rowcol[n_rows : n_rows + n_cols] = col_raw
    cells = np.full((M,), cfg.eos_token_id, np.int32)
    cells[:n_cells] = cell_raw
    tr._script_rowcol = rowcol
    tr._script_cells = cells


def resize_polygon(polygon, orig_size, new_size):
    """Scale and clamp a polygon from one coordinate space to another."""
    sx = new_size[0] / orig_size[0]
    sy = new_size[1] / orig_size[1]
    for corner in polygon:
        corner[0] = min(max(corner[0] * sx, 0), new_size[0])
        corner[1] = min(max(corner[1] * sy, 0), new_size[1])
    return polygon


class TableRecPredictor(BasePredictor):
    batch_size_setting = "TABLE_REC_BATCH_SIZE"
    default_batch_sizes = {"cpu": 8, "cuda": 16}

    def __init__(self, tiny: bool = False, device=None, jax_params: Optional[dict] = None,
                 config: Optional[TableRecConfig] = None, dtype: Optional[torch.dtype] = None):
        """tiny: the small test configuration; config: any other; jax_params:
        the JAX table-rec pytree as numpy leaves, whose weights the model
        takes (random weights from WEIGHT_SEED otherwise); dtype: the model's
        (default bfloat16 on CUDA, float32 on the CPU)."""
        self._tiny = tiny
        self._jax_params = jax_params
        self._config = config
        self._dtype = dtype
        super().__init__(device)

    def _load(self):
        self.model, self.config = load_table_rec_model(self._tiny, self.device, self._jax_params, self._config,
                                                        self._dtype)
        self._jax_params = None
        self.dtype = self.model.pre_output_norm.weight.dtype
        self.shaper = LabelShaper()
        self._script_rowcol = None  # install_synthetic_tables
        self._script_cells = None
        # the last call's passes (rows, AR steps, host syncs, the host time
        # spent enqueuing, steps recorded) and cell-pass batches
        self.last_run: dict = {}

    def prepare_image(self, img: Image.Image) -> np.ndarray:
        size = self.config.encoder.image_size
        return cv2.resize(np.asarray(img, np.uint8), (size[1], size[0]), interpolation=cv2.INTER_LANCZOS4)

    def _encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """uint8 crops [B, H, W, 1 or 3] -> encoder states [B, tokens, hidden]."""
        x = pixels.expand(*pixels.shape[:-1], 3).to(self.dtype) / 255.0
        return self.model.encode((x - IMAGE_MEAN) / IMAGE_STD)

    # -- decode passes -------------------------------------------------------

    def _build_query_vectors(self, query_items: List[dict], columns: Optional[List[dict]] = None) -> np.ndarray:
        """[bos row, query label, query-end row] (+ the columns' labels for
        the cell pass), one prompt per query item."""
        cfg = self.config
        query_items = self.shaper.convert_polygons_to_bboxes(deepcopy(query_items))
        labels = self.shaper.dict_to_labels(query_items)
        dim = len(labels[0])
        rows = []
        for label in labels:
            rows.append([[cfg.bos_token_id] * dim, label, [cfg.query_end_token_id] * dim])
        if columns:
            col_labels = self.shaper.dict_to_labels(self.shaper.convert_polygons_to_bboxes(deepcopy(columns)))
            for seq in rows:
                seq += col_labels
        return np.asarray(rows, np.float32).astype(np.int32)

    def _run_pass(self, enc_dev: torch.Tensor, enc_idx: np.ndarray, vectors: np.ndarray,
                  script: Optional[np.ndarray] = None) -> List[List[dict]]:
        """One AR pass over the prompts `vectors` [n, L, 10]; returns, per
        prompt, its recorded property dicts. enc_dev: the batch's encoder
        states on the device; enc_idx [n]: each prompt's row in it. script:
        per-step raw category overrides (install_synthetic_tables)."""
        n, L = vectors.shape[:2]
        L_bucket = next((b for b in PROMPT_BUCKETS if b >= L), None)
        if L_bucket is None:
            raise ValueError(f"prompt length {L} exceeds buckets {PROMPT_BUCKETS}")
        vec_pad = np.zeros((n, L_bucket, vectors.shape[2]), np.int32)
        vec_pad[:, :L] = vectors
        t0 = time.perf_counter()
        watch = DoneWatch(self.device)
        with self._on_stream(), torch.inference_mode():
            enc = enc_dev[self._upload(enc_idx.astype(np.int64))]
            seq_lens = self._upload(np.full((n,), L, np.int32))
            bufs = self.model.generate(enc, self._upload(vec_pad), seq_lens, self.config.max_boxes,
                                       category_script=script, watch=watch)
            packed = torch.cat(
                [bufs["bbox"]] + [bufs[k][..., None].float() for k in ("category", "merges", "colspan", "is_header",
                                                                        "valid")],
                dim=-1,
            )
            handle = self._fetch(packed)
        enqueue_s = time.perf_counter() - t0
        [packed] = self._wait(handle)
        self.last_run["passes"].append({"rows": n, "steps": watch.steps, "host_syncs": watch.syncs + 1,
                                        "enqueue_s": enqueue_s, "recorded": int((packed[..., 10] > 0.5).sum())})

        predictions: List[List[dict]] = []
        for j in range(n):
            preds = []
            for i in range(packed.shape[1]):
                if packed[j, i, 10] <= 0.5:  # valid flag
                    continue
                preds.append({
                    "bbox": packed[j, i, :6].tolist(),
                    "category": int(packed[j, i, 6]),
                    "merges": int(packed[j, i, 7]),
                    "colspan": int(packed[j, i, 8]),
                    "is_header": int(packed[j, i, 9]),
                })
            predictions.append(preds)
        return predictions

    # -- public API ----------------------------------------------------------

    def __call__(self, images: List[Image.Image], batch_size: Optional[int] = None) -> List[TableResult]:
        return self.batch_table_recognition(images, batch_size)

    def batch_table_recognition(self, images: List[Image.Image], batch_size: Optional[int] = None) -> List[TableResult]:
        if not all(isinstance(im, Image.Image) for im in images):
            raise TypeError("TableRecPredictor takes PIL images")
        if batch_size is None:
            batch_size = self.get_batch_size()
        self.last_run = {"passes": [], "cell_batch": []}
        if len(images) == 0:
            return []

        query_items = [
            {
                "polygon": [[0, 0], [im.width, 0], [im.width, im.height], [0, im.height]],
                "category": CATEGORY_TO_ID["Table"],
                "colspan": 0,
                "merges": 0,
                "is_header": 0,
            }
            for im in images
        ]

        results = []
        for i in tqdm(range(0, len(images), batch_size), desc="Recognizing tables", disable=self.disable_tqdm):
            batch_images = [im.convert("RGB") for im in images[i : i + batch_size]]
            batch_query_items = deepcopy(query_items[i : i + batch_size])
            orig_sizes = [im.size for im in batch_images]
            for im, q in zip(batch_images, batch_query_items):
                q["polygon"] = resize_polygon(q["polygon"], im.size, (BOX_DIM, BOX_DIM))

            pixels = self.gray_ship(np.stack([self.prepare_image(im) for im in batch_images]))
            with self._on_stream(), torch.inference_mode():
                enc_dev = self._encode(self._upload(pixels))

            vectors = self._build_query_vectors(batch_query_items)
            rowcol_predictions = self._run_pass(enc_dev, np.arange(len(vectors)), vectors, script=self._script_rowcol)

            # row queries, with every column of the batch as their context
            row_query_items, idx_map, columns = [], [], []
            for j, img_preds in enumerate(rowcol_predictions):
                for pred in img_preds:
                    item = {
                        "polygon": self.shaper.convert_bbox_to_polygon(pred["bbox"]),
                        "category": pred["category"],
                        "colspan": 0,
                        "merges": 0,
                        "is_header": int(pred["is_header"] == 1),
                    }
                    if pred["category"] == CATEGORY_TO_ID["Table-row"]:
                        row_query_items.append(item)
                        idx_map.append(j)
                    elif pred["category"] == CATEGORY_TO_ID["Table-column"]:
                        columns.append(item)

            cell_predictions = []
            if row_query_items:
                row_vectors = self._build_query_vectors(row_query_items, columns=columns)
                row_idx = np.asarray(idx_map, np.int64)
                # the JAX package's rule: the small decoder's step is
                # latency-bound, so one wide pass beats several narrow ones
                cell_bs = batch_size
                cap = max(batch_size, settings.TABLE_REC_CELL_BATCH_MAX)
                while cell_bs < cap and cell_bs < len(row_vectors):
                    cell_bs *= 2
                cell_bs = min(cell_bs, cap)
                self.last_run["cell_batch"].append(cell_bs)
                for j in range(0, len(row_vectors), cell_bs):
                    cell_predictions.extend(self._run_pass(enc_dev, row_idx[j : j + cell_bs],
                                                           row_vectors[j : j + cell_bs], script=self._script_cells))

            results.extend(self.decode_batch_predictions(rowcol_predictions, cell_predictions, orig_sizes, idx_map))
        return results

    # -- grid assembly (host) -----------------------------------------------

    def decode_batch_predictions(self, rowcol_predictions, cell_predictions, orig_sizes, idx_map):
        results = []
        for j, (img_predictions, orig_size) in enumerate(zip(rowcol_predictions, orig_sizes)):
            row_cell_predictions = [c for i, c in enumerate(cell_predictions) if idx_map[i] == j]
            rows, cells, columns = [], [], []
            cell_id = 0
            row_preds = [p for p in img_predictions if p["category"] == CATEGORY_TO_ID["Table-row"]]
            col_preds = [p for p in img_predictions if p["category"] == CATEGORY_TO_ID["Table-column"]]

            for z, col_pred in enumerate(col_preds):
                polygon = self.shaper.convert_bbox_to_polygon(col_pred["bbox"])
                polygon = resize_polygon(polygon, (BOX_DIM, BOX_DIM), orig_size)
                columns.append(TableCol(polygon=polygon, col_id=z, is_header=col_pred["is_header"] == 1))

            for z, row_pred in enumerate(row_preds):
                polygon = self.shaper.convert_bbox_to_polygon(row_pred["bbox"])
                polygon = resize_polygon(polygon, (BOX_DIM, BOX_DIM), orig_size)
                row = TableRow(polygon=polygon, row_id=z, is_header=row_pred["is_header"] == 1)
                rows.append(row)

                spanning_cells = []
                cell_preds = row_cell_predictions[z] if z < len(row_cell_predictions) else []
                for l, spanning_cell in enumerate(cell_preds):
                    polygon = self.shaper.convert_bbox_to_polygon(spanning_cell["bbox"])
                    polygon = resize_polygon(polygon, (BOX_DIM, BOX_DIM), orig_size)
                    colspan = max(1, int(spanning_cell["colspan"]))
                    if colspan == 1 and spanning_cell["merges"] not in MERGE_VALUES:
                        continue
                    if PolygonBox(polygon=polygon).height < row.height * 0.85:
                        continue
                    spanning_cells.append(
                        TableCell(
                            polygon=polygon,
                            row_id=z,
                            rowspan=1,
                            cell_id=cell_id,
                            within_row_id=l,
                            colspan=colspan,
                            merge_up=spanning_cell["merges"] in (MERGE_KEYS["merge_up"], MERGE_KEYS["merge_both"]),
                            merge_down=spanning_cell["merges"] in (MERGE_KEYS["merge_down"], MERGE_KEYS["merge_both"]),
                            is_header=row.is_header or z == 0,
                        )
                    )
                    cell_id += 1

                used_spanning = set()
                skip_columns = 0
                for l, col in enumerate(columns):
                    if skip_columns:
                        skip_columns -= 1
                        continue
                    cell_polygon = row.intersection_polygon(col)
                    cell_added = False
                    for zz, spanning_cell in enumerate(spanning_cells):
                        pct = PolygonBox(polygon=cell_polygon).intersection_pct(spanning_cell)
                        correct_col_width = sum(c.width for c in columns[l : l + spanning_cell.colspan])
                        if pct > 0.9:
                            if spanning_cell.width > correct_col_width * 0.85:
                                cell_added = True
                                if zz not in used_spanning:
                                    used_spanning.add(zz)
                                    spanning_cell.col_id = l
                                    cells.append(spanning_cell)
                                    skip_columns = spanning_cell.colspan - 1
                            else:
                                used_spanning.add(zz)
                    if not cell_added:
                        cells.append(
                            TableCell(
                                polygon=cell_polygon,
                                row_id=z,
                                rowspan=1,
                                cell_id=cell_id,
                                within_row_id=l,
                                colspan=1,
                                merge_up=False,
                                merge_down=False,
                                col_id=l,
                                is_header=row.is_header or col.is_header or z == 0,
                            )
                        )
                        cell_id += 1

            # rowspan merging across consecutive rows
            grid_cells = deepcopy([[c for c in cells if c.row_id == row.row_id] for row in rows])
            for z, grid_row in enumerate(grid_cells[1:]):
                prev_row = grid_cells[z]
                for l, cell in enumerate(grid_row):
                    if l >= len(prev_row):
                        continue
                    above = prev_row[l]
                    if (
                        above.merge_down
                        and cell.merge_up
                        and above.col_id == cell.col_id
                        and above.colspan == cell.colspan
                    ):
                        above.merge(cell)
                        above.rowspan += cell.rowspan
                        grid_row[l] = above

            merged, used_ids = [], set()
            for cell in chain.from_iterable(grid_cells):
                if cell.cell_id not in used_ids:
                    used_ids.add(cell.cell_id)
                    merged.append(cell)

            results.append(
                TableResult(
                    cells=merged,
                    unmerged_cells=cells,
                    rows=rows,
                    cols=columns,
                    image_bbox=[0, 0, orig_size[0], orig_size[1]],
                )
            )
        return results
