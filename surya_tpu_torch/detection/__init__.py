"""Text-line detection predictor of the PyTorch port.

Counterpart of surya_tpu/detection/__init__.py on its host-prepare path,
run synchronously, one batch at a time:

  1. split tall pages into vertical chunks (util.split_image);
  2. double-LANCZOS resize each chunk to the processor size on the host
     (PIL), pad the batch to its row bucket, keep uint8;
  3. on the device: uint8 -> float, ImageNet normalisation, the EfficientViT
     forward and sigmoid (``apply_heat``), then round(heat * 255) to uint8
     at the decode head's 1/4 resolution, and one copy to the host;
  4. on the host: cv2 bilinear upsample to the processor size, stitch the
     chunks of a page, CRAFT box extraction (heatmap.py) in a thread pool.

Not ported yet: the resize on the device (detection/resize.py), component
stats on the device, the C++ CRAFT op and the one-batch-in-flight pipelining.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Generator, List, Optional, Tuple

import cv2
import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.detection.heatmap import parallel_get_boxes
from surya_tpu_torch.detection.loader import load_detection_model
from surya_tpu_torch.detection.schema import TextDetectionResult
from surya_tpu_torch.detection.util import get_total_splits, split_image
from surya_tpu_torch.settings import settings


class DetectionPredictor(BasePredictor):
    batch_size_setting = "DETECTOR_BATCH_SIZE"
    default_batch_sizes = {"cpu": 8, "cuda": 32}

    def __init__(self, tiny: bool = False, device=None, jax_params: Optional[dict] = None):
        """tiny: the small test configuration; jax_params: the JAX detection
        pytree as numpy leaves, whose weights the model takes (random weights
        from WEIGHT_SEED otherwise)."""
        self._tiny = tiny
        self._jax_params = jax_params
        super().__init__(device)

    def _load(self):
        self.model, self.config = load_detection_model(self._tiny, self.device, self._jax_params)
        self._jax_params = None
        self.dtype = self.model.head.classifier.weight.dtype
        self.processor_size = self.config.image_size  # (h, w)
        # the heatmap tail: float32 sigmoid maps [B, C, H/4, W/4] from pixels
        # in [0, 1] (models.efficientvit.install_blob_detector replaces it)
        self._apply_heat = self.model.apply_heat

    def __call__(self, images: List[Image.Image], batch_size=None, include_maps=False) -> List[TextDetectionResult]:
        parallel = len(images) >= settings.DETECTOR_MIN_PARALLEL_THRESH and (os.cpu_count() or 1) > 1
        workers = max(1, min(settings.DETECTOR_POSTPROCESSING_CPU_WORKERS, len(images))) if parallel else 1
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(parallel_get_boxes, pred, size, include_maps)
                for preds, sizes in self.batch_detection(images, batch_size, include_maps)
                for pred, size in zip(preds, sizes)
            ]
            return [f.result() for f in futures]

    def prepare_image(self, img: Image.Image) -> np.ndarray:
        """Double-LANCZOS resize to the processor size (the reference notes
        the double resize matters for accuracy). Returns HWC uint8."""
        new_size = (self.processor_size[1], self.processor_size[0])  # (w, h)
        img.thumbnail(new_size, Image.Resampling.LANCZOS)
        img = img.resize(new_size, Image.Resampling.LANCZOS)
        return np.asarray(img, dtype=np.uint8)

    @torch.inference_mode()
    def heatmaps(self, pixels: np.ndarray, n_real: int, n_maps: int) -> np.ndarray:
        """uint8 pixels [rows, H, W, 3] -> uint8 maps [n_real, n_maps, H/4,
        W/4] on the host: the device program and its one copy back."""
        x = torch.from_numpy(pixels).to(self.device).permute(0, 3, 1, 2).to(self.dtype) / 255.0
        heat = self._apply_heat(x)[:n_real, :n_maps]
        return torch.round(heat * 255.0).to(torch.uint8).cpu().numpy()

    def batch_detection(
        self, images: List[Image.Image], batch_size=None, include_maps=False
    ) -> Generator[Tuple[List[List[np.ndarray]], List[Tuple[int, int]]], None, None]:
        """Yields, per batch, each page's stitched processor-size maps (text
        map, then the vertical-line map when include_maps) and its size."""
        if not all(isinstance(image, Image.Image) for image in images):
            raise TypeError("DetectionPredictor takes PIL images")
        if batch_size is None:
            batch_size = self.get_batch_size()
        proc_h = self.processor_size[0]
        out_wh = (self.processor_size[1], proc_h)
        n_maps = self.config.num_classes if include_maps else 1

        orig_sizes = [image.size for image in images]
        splits_per_image = [get_total_splits(size, proc_h) for size in orig_sizes]

        # pack pages into batches by their split counts
        batches: List[List[int]] = []
        current: List[int] = []
        current_size = 0
        for i in range(len(images)):
            if current_size + splits_per_image[i] > batch_size:
                if current:
                    batches.append(current)
                current, current_size = [], 0
            current.append(i)
            current_size += splits_per_image[i]
        if current:
            batches.append(current)

        for batch_image_idxs in tqdm(batches, desc="Detecting bboxes", disable=self.disable_tqdm):
            split_index: List[int] = []
            split_heights: List[int] = []
            image_splits: List[Image.Image] = []
            for image_idx, j in enumerate(batch_image_idxs):
                parts, heights = split_image(images[j].convert("RGB"), proc_h)
                image_splits.extend(parts)
                split_index.extend([image_idx] * len(parts))
                split_heights.extend(heights)

            n_real = len(image_splits)
            # rows: the next power of two, at most batch_size (a single tall
            # page may exceed it and keeps its own count)
            bucket = 1
            while bucket < min(n_real, batch_size):
                bucket *= 2
            rows = min(max(bucket, n_real), max(batch_size, n_real))

            if n_real >= settings.DETECTOR_MIN_PARALLEL_THRESH and (os.cpu_count() or 1) > 1:
                with ThreadPoolExecutor(max_workers=settings.DETECTOR_POSTPROCESSING_CPU_WORKERS) as pool:
                    prepared = list(pool.map(self.prepare_image, image_splits))
            else:
                prepared = [self.prepare_image(part) for part in image_splits]
            pixels = np.stack(prepared, axis=0)
            if rows > n_real:  # pad with copies of the last chunk
                pixels = np.pad(pixels, [(0, rows - n_real)] + [(0, 0)] * 3, mode="edge")

            compact = self.heatmaps(pixels, n_real, n_maps)

            preds: List[List[np.ndarray]] = []
            for i, (idx, height) in enumerate(zip(split_index, split_heights)):
                # host bilinear upsample of the uint8 1/4-resolution maps
                maps = [cv2.resize(compact[i, k], out_wh, interpolation=cv2.INTER_LINEAR) for k in range(n_maps)]
                if len(preds) <= idx:
                    preds.append(maps)
                else:
                    if height < proc_h:
                        maps = [m[:height, :] for m in maps]
                    preds[idx] = [np.vstack([old, new]) for old, new in zip(preds[idx], maps)]
            yield preds, [orig_sizes[j] for j in batch_image_idxs]
