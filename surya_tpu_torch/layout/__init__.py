"""Layout analysis and reading order predictor of the PyTorch port.

Counterpart of surya_tpu/layout/__init__.py, with the same outputs:

  1. pages above LAYOUT_SLICE_MIN are cut into tiles (slicer), and pages are
     packed into batches by tile count, at most ``pipeline_cap`` tiles a
     batch (LAYOUT_PIPELINE_BATCH; 8 on CUDA);
  2. each tile is squish-resized to the encoder size on the host
     (cv2 LANCZOS4) and shipped as uint8, one channel when every tile is
     gray; the device broadcasts it back, scales to [0, 1] and normalizes;
  3. on the device: the Swin encoder and the AR box loop with the
     header/footer rewrite (models/layout_model.generate), its outputs
     packed into one array for one copy back;
  4. on the host: top-k label probabilities, the schema, ``clean_boxes``,
     and the tiles joined back into pages.

One batch stays in flight: batch k's outputs are fetched and assembled only
after batch k + 1 is enqueued. On CUDA the predictor runs on a stream of its
own. Reading order is emission order (``position``). Batches are not padded:
rows do not interact in the eager loop.
"""

from __future__ import annotations

import time
from typing import List, Optional

import cv2
import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.common.util import clean_boxes
from surya_tpu_torch.layout.loader import load_layout_model
from surya_tpu_torch.layout.schema import LayoutBox, LayoutResult
from surya_tpu_torch.layout.slicer import ImageSlicer
from surya_tpu_torch.models.adetr import DoneWatch
from surya_tpu_torch.models.layout_model import ID_TO_LABEL, LayoutConfig
from surya_tpu_torch.settings import settings

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


def prediction_to_polygon(pred, img_size, bbox_scaler, skew_scaler, skew_min=0.001):
    """One (cx, cy, w, h, xskew, yskew) box -> a skewed quad scaled to the page."""
    w_scale = img_size[0] / bbox_scaler
    h_scale = img_size[1] / bbox_scaler
    cx, cy, width, height = pred[0], pred[1], pred[2], pred[3]
    x1, y1 = cx - width / 2, cy - height / 2
    x2, y2 = cx + width / 2, cy + height / 2
    skew_x = float(np.floor((pred[4] - skew_scaler) / 2))
    skew_y = float(np.floor((pred[5] - skew_scaler) / 2))
    if abs(skew_x) < skew_min:
        skew_x = 0
    if abs(skew_y) < skew_min:
        skew_y = 0
    quad = [
        (x1 - skew_x, y1 - skew_y),
        (x2 - skew_x, y1 + skew_y),
        (x2 + skew_x, y2 + skew_y),
        (x1 + skew_x, y2 - skew_y),
    ]
    return [[float(x) * w_scale, float(y) * h_scale] for x, y in quad]


def pack_by_tiles(img_counts: List[int], cap: int) -> List[tuple]:
    """(start, end) page ranges of at most `cap` tiles each (a page of more
    tiles alone), in page order, as the JAX predictor packs them."""
    batches = []
    start_idx, end_idx = 0, 1
    while end_idx < len(img_counts):
        if sum(img_counts[start_idx:end_idx]) >= cap or sum(img_counts[start_idx:end_idx + 1]) > cap:
            batches.append((start_idx, end_idx))
            start_idx = end_idx
        end_idx += 1
    if start_idx < len(img_counts):
        batches.append((start_idx, len(img_counts)))
    return batches


class LayoutPredictor(BasePredictor):
    batch_size_setting = "LAYOUT_BATCH_SIZE"
    default_batch_sizes = {"cpu": 4, "cuda": 16}

    def __init__(self, checkpoint: Optional[str] = None, tiny: bool = False, *, device=None,
                 jax_params: Optional[dict] = None, config: Optional[LayoutConfig] = None,
                 dtype: Optional[torch.dtype] = None):
        """checkpoint: a local directory or ``s3://`` name (default
        LAYOUT_MODEL_CHECKPOINT); tiny: the small test configuration of
        random weights; config: any other; jax_params: the JAX layout pytree
        as numpy leaves, whose weights the model takes (no checkpoint is
        resolved); dtype: the model's (default bfloat16 on CUDA, float32 on
        the CPU)."""
        self._tiny = tiny
        self._jax_params = jax_params
        self._config = config
        self._dtype = dtype
        super().__init__(checkpoint, device)

    def _load(self):
        self.model, self.config = load_layout_model(self.checkpoint, self._tiny, self.device, self._jax_params,
                                                  self._config, self._dtype)
        self._jax_params = None
        self.dtype = self.model.lm_head.weight.dtype
        # the last call's dispatches: tiles, AR steps and host syncs of each
        # (the loop's event waits and the output's), and the host time spent
        # enqueuing them
        self.last_run: dict = {}

    def prepare_image(self, img: Image.Image) -> np.ndarray:
        """Squish-resize to the encoder size (no aspect kept), HWC uint8."""
        size = self.config.encoder.image_size
        return cv2.resize(np.asarray(img, dtype=np.uint8), (size[1], size[0]), interpolation=cv2.INTER_LANCZOS4)

    def _generate(self, pixels: torch.Tensor, watch: DoneWatch) -> torch.Tensor:
        """uint8 tiles [B, H, W, 1 or 3] -> one float32 array [B, MAX, 7 +
        label_count + 1]: boxes, class logits and the valid flag."""
        x = pixels.expand(*pixels.shape[:-1], 3).to(self.dtype) / 255.0
        x = (x - IMAGE_MEAN) / IMAGE_STD
        boxes, logits, valid = self.model.generate(x, watch)
        return torch.cat([boxes, logits, valid[..., None].float()], dim=-1)

    def __call__(self, images: List[Image.Image], batch_size: Optional[int] = None,
                 top_k: int = 5) -> List[LayoutResult]:
        return self.batch_layout_detection(images, batch_size=batch_size, top_k=top_k)

    def batch_layout_detection(self, images: List[Image.Image], batch_size: Optional[int] = None,
                               top_k: int = 5) -> List[LayoutResult]:
        if not all(isinstance(im, Image.Image) for im in images):
            raise TypeError("LayoutPredictor takes PIL images")
        if batch_size is None:
            batch_size = self.get_batch_size()
        slicer = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE)
        img_counts = [slicer.slice_count(image) for image in images]
        batches = pack_by_tiles(img_counts, self.pipeline_cap(settings.LAYOUT_PIPELINE_BATCH, batch_size))
        run = self.last_run = {"tiles": [], "steps": [], "host_syncs": [], "enqueue_s": 0.0}

        results: List[LayoutResult] = []
        inflight = None
        for start_idx, end_idx in tqdm(batches, desc="Recognizing layout", disable=self.disable_tqdm):
            tiles, tile_positions = slicer.slice([im.convert("RGB") for im in images[start_idx:end_idx]])
            pixels = self.gray_ship(np.stack([self.prepare_image(im) for im in tiles]))
            t0 = time.perf_counter()
            watch = DoneWatch(self.device)
            with self._on_stream(), torch.inference_mode():
                handle = self._fetch(self._generate(self._upload(pixels), watch))
            run["enqueue_s"] += time.perf_counter() - t0
            run["tiles"].append(len(tiles))
            run["steps"].append(watch.steps)
            run["host_syncs"].append(watch.syncs + 1)  # the loop's event waits and the output's
            # fetch the previous batch only now that this one is enqueued
            if inflight is not None:
                results.extend(self._finish(*inflight, slicer, top_k))
            inflight = (handle, [im.size for im in tiles], tile_positions)
        if inflight is not None:
            results.extend(self._finish(*inflight, slicer, top_k))
        assert len(results) == len(images)
        return results

    def _finish(self, handle, orig_sizes, tile_positions, slicer, top_k) -> List[LayoutResult]:
        [packed] = self._wait(handle)
        return self._assemble_batch(packed[..., :7], packed[..., 7:-1], packed[..., -1] > 0.5, orig_sizes,
                                    tile_positions, slicer, top_k)

    def _assemble_batch(self, boxes, logits, valid, orig_sizes, tile_positions, slicer, top_k):
        """Host assembly of one fetched batch into LayoutResults, tiles joined."""
        batch_results = []
        dec = self.config
        for j, orig_size in enumerate(orig_sizes):
            layout_boxes = []
            position = 0
            for i in range(boxes.shape[1]):
                if not valid[j, i]:
                    continue
                token = boxes[j, i]
                if token[6] <= dec.special_token_count:  # drop special/Blank
                    continue
                label_id = int(token[6]) - dec.special_token_count
                label = ID_TO_LABEL[label_id]
                probs = _softmax(logits[j, i])
                top_idx = np.argsort(probs)[::-1][:top_k]
                top_k_dict = {
                    ID_TO_LABEL.get(int(t) - dec.special_token_count): float(probs[t])
                    for t in top_idx
                    if int(t) - dec.special_token_count > 0
                }
                poly = prediction_to_polygon(token, orig_size, dec.bbox_size, dec.skew_scaler)
                layout_boxes.append(
                    LayoutBox(polygon=poly, label=label, position=position, top_k=top_k_dict,
                              confidence=top_k_dict.get(label, 0.0))
                )
                position += 1
            layout_boxes = clean_boxes(layout_boxes)
            batch_results.append(LayoutResult(bboxes=layout_boxes, image_bbox=[0, 0, orig_size[0], orig_size[1]]))
        assert len(batch_results) == len(tile_positions)
        return slicer.join(batch_results, tile_positions)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()
