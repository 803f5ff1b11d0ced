"""Text-line detection predictor of the PyTorch port.

Counterpart of surya_tpu/detection/__init__.py, with the same outputs:

  1. split tall pages into vertical chunks (util.split_image) and pack pages
     into batches of at most ``pipeline_cap`` chunk rows (8 on CUDA);
  2. with DETECTOR_DEVICE_RESIZE (auto: on for CUDA), ship each chunk at its
     own size, uint8, on a canvas bucketed to 256 px, one channel when every
     chunk is gray; the device resizes it to the processor size by the
     PIL-exact double-LANCZOS weight matrices of detection/resize.py, two
     products ``V @ x`` then ``H @ ...``. Otherwise PIL resizes on the host;
  3. on the device: the EfficientViT forward and sigmoid (``_apply_heat``),
     then either, with DETECTOR_ON_DEVICE_POSTPROCESS (auto: on for CUDA),
     the page maps gathered from their chunks, their dynamic thresholds and
     their connected-component stats (ops/connected_components.py), of which
     only [pages, DETECTOR_MAX_COMPONENTS, 11] numbers come back; or the
     uint8 maps at 1/4 resolution;
  4. on the host, in a thread pool: boxes from the stats
     (heatmap.boxes_from_stats), or upsample, stitch and CRAFT
     (heatmap.parallel_get_boxes).

One batch stays in flight: a batch's outputs are fetched only after the
next batch is enqueued. On CUDA the predictor runs on a stream of its own:
its uploads leave pinned host memory without blocking, and the host waits
for an output on an event of that stream, never on the device as a whole,
so a recognition run on the same card is not held up. A page with more
components than DETECTOR_MAX_COMPONENTS sends its batch through the maps
path (the pixels are still on the device), logged and counted in
``maps_batches``; ``stats_batches`` counts the batches the stats path took.
An error of the stats program raises: there is no quiet host fallback.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Generator, List, Optional, Tuple

import cv2
import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.common.profiling import stage
from surya_tpu_torch.detection.heatmap import get_boxes_from_stats_result, parallel_get_boxes
from surya_tpu_torch.detection.loader import load_detection_model
from surya_tpu_torch.detection.parallel import FakeExecutor
from surya_tpu_torch.detection.resize import double_resize_matrices
from surya_tpu_torch.detection.schema import TextDetectionResult
from surya_tpu_torch.detection.util import get_total_splits, split_image
from surya_tpu_torch.ops import connected_components as cc
from surya_tpu_torch.settings import on_for_cuda, settings

logger = logging.getLogger(__name__)

CANVAS_BUCKET = 256  # px: the device-resize canvas is the batch's largest chunk, rounded up to this


def resize_on_device(pixels: torch.Tensor, Vs: torch.Tensor, Hs: torch.Tensor, gid: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """uint8 chunks [B, Hb, Wb, C] at their source sizes on a canvas ->
    float32 [B, C, h, w] pixel values (integers in [0, 255]): out = V @ x @ Hᵀ
    per chunk, with V [h, Hb], H [w, Wb] of its size group gid. Each product
    takes operands in `dtype`, the model's (bf16 on CUDA, float32 on the
    CPU), and gives a float32 result; the intermediate is rounded to `dtype`
    and the result clipped and rounded to integers, as PIL rounds to uint8
    (surya_tpu's _resize_device). bf16 operands are exact in float32, so
    TF32 would not change the products either."""
    B, Hb, Wb, C = pixels.shape
    f32 = torch.float32
    V, Hm = Vs[gid].to(dtype).to(f32), Hs[gid].to(dtype).to(f32)  # [B, h, Hb], [B, w, Wb]
    h, w = V.shape[1], Hm.shape[1]
    x = pixels.to(dtype).to(f32).reshape(B, Hb, Wb * C)
    x = torch.bmm(V, x).to(dtype).to(f32)  # [B, h, Wb * C]
    x = torch.bmm(Hm, x.reshape(B, h, Wb, C).permute(0, 2, 1, 3).reshape(B, Wb, h * C))  # [B, w, h * C]
    return torch.clamp(torch.round(x), 0.0, 255.0).reshape(B, w, h, C).permute(0, 3, 2, 1)


class DetectionPredictor(BasePredictor):
    batch_size_setting = "DETECTOR_BATCH_SIZE"
    default_batch_sizes = {"cpu": 8, "cuda": 32}
    resize_cache_entries = 32  # device resize-matrix stacks kept, least recently used evicted first

    def __init__(self, checkpoint: Optional[str] = None, tiny: bool = False, *, device=None,
                 jax_params: Optional[dict] = None):
        """checkpoint: a local directory or ``s3://`` name (default
        DETECTOR_MODEL_CHECKPOINT); tiny: the small test configuration of
        random weights; jax_params: the JAX detection pytree as numpy
        leaves, whose weights the model takes (no checkpoint is resolved)."""
        self._tiny = tiny
        self._jax_params = jax_params
        super().__init__(checkpoint, device)

    def _load(self):
        self.model, self.config = load_detection_model(self.checkpoint, self._tiny, self.device, self._jax_params)
        self._jax_params = None
        self.dtype = self.model.head.classifier.weight.dtype
        self.processor_size = self.config.image_size  # (h, w)
        # the heatmap tail: float32 sigmoid maps [B, C, H/4, W/4] from pixels
        # in [0, 1] (models.efficientvit.install_blob_detector replaces it)
        self._apply_heat = self.model.apply_heat
        # device resize-matrix stacks by (source sizes, groups, canvas)
        self._resize_mat_cache: OrderedDict = OrderedDict()
        self.stats_batches = 0
        self.maps_batches = 0

    def __call__(self, images: List[Image.Image], batch_size=None, include_maps=False) -> List[TextDetectionResult]:
        parallel = len(images) >= settings.DETECTOR_MIN_PARALLEL_THRESH and (os.cpu_count() or 1) > 1
        workers = max(1, min(settings.DETECTOR_POSTPROCESSING_CPU_WORKERS, len(images)))
        with (ThreadPoolExecutor if parallel else FakeExecutor)(max_workers=workers) as pool:
            futures = []
            for preds, sizes in self.batch_detection(images, batch_size, include_maps):
                for pred, size in zip(preds, sizes):
                    if isinstance(pred, dict):  # the stats path
                        futures.append(pool.submit(get_boxes_from_stats_result, pred, size))
                    else:
                        futures.append(pool.submit(parallel_get_boxes, pred, size, include_maps))
            with stage("detection.postprocess_wait"):
                return [f.result() for f in futures]

    def prepare_image(self, img: Image.Image) -> np.ndarray:
        """Double-LANCZOS resize to the processor size (the reference notes
        the double resize matters for accuracy). Returns HWC uint8."""
        new_size = (self.processor_size[1], self.processor_size[0])  # (w, h)
        img.thumbnail(new_size, Image.Resampling.LANCZOS)
        img = img.resize(new_size, Image.Resampling.LANCZOS)
        return np.asarray(img, dtype=np.uint8)

    def _resize_mats(self, uniq, n_groups: int, canvas_hw) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Vs [G, h, Hb], Hs [G, w, Wb]) on the device, in the model dtype,
        cached by (sizes, groups, canvas). At resize_cache_entries stacks the
        least recently used one is evicted, never the one in use."""
        key = (tuple(uniq), n_groups, *canvas_hw)
        mats = self._resize_mat_cache.get(key)
        if mats is not None:
            self._resize_mat_cache.move_to_end(key)
            return mats
        Hb, Wb = canvas_hw
        Vs = np.zeros((n_groups, self.processor_size[0], Hb), np.float32)
        Hs = np.zeros((n_groups, self.processor_size[1], Wb), np.float32)
        for g, (h_src, w_src) in enumerate(uniq):
            V, Hm = double_resize_matrices((h_src, w_src), tuple(self.processor_size))
            Vs[g, :, :h_src] = V
            Hs[g, :, :w_src] = Hm
        mats = tuple(self._upload(m).to(self.dtype) for m in (Vs, Hs))
        while len(self._resize_mat_cache) >= self.resize_cache_entries:
            self._resize_mat_cache.popitem(last=False)
        self._resize_mat_cache[key] = mats
        return mats

    # -- device programs -------------------------------------------------------

    def _heat(self, pixels: torch.Tensor, resize) -> torch.Tensor:
        """Float32 heatmaps [B, C, H/4, W/4] of uint8 pixels: [B, Hb, Wb, C]
        chunks with resize = (Vs, Hs, gid), or [B, H, W, C] at the processor
        size without."""
        x = resize_on_device(pixels, *resize, self.dtype) if resize is not None else pixels.permute(0, 3, 1, 2)
        B, _, H, W = x.shape
        return self._apply_heat(x.expand(B, 3, H, W).to(self.dtype) / 255.0)

    def _maps_program(self, pixels: torch.Tensor, resize, n_real: int, n_maps: int) -> torch.Tensor:
        """uint8 maps [n_real, n_maps, H/4, W/4] (heat rounded to 1/255)."""
        heat = self._heat(pixels, resize)[:n_real, :n_maps]
        return torch.round(heat * 255.0).to(torch.uint8)

    def _stats_program(self, pixels: torch.Tensor, resize, page_gather, valid_rows, max_comps: int):
        """Component stats of whole pages (surya_tpu's _stats_tail). The pages'
        head-resolution maps are gathered from their chunks (page_gather [P, K]
        chunk rows, -1 for none; valid_rows [P, K] real head rows of each), so
        a component merges across a chunk seam as on the host. Returns one
        float32 array [P, max_comps * 11 + 3]: the stats, then n_comp, n_raw
        and the page's text threshold."""
        heat = self._heat(pixels, resize)[:, 0].float()  # [B, h4, w4]
        _, h4, w4 = heat.shape
        P, K = page_gather.shape
        maps = heat[page_gather.clamp(min=0).long()]  # [P, K, h4, w4]
        rows = torch.arange(h4, device=heat.device)[None, None, :, None]
        ok = (page_gather >= 0)[:, :, None, None] & (rows < valid_rows[:, :, None, None])
        page_maps = torch.where(ok, maps, 0.0).reshape(P, K * h4, w4)
        # the decile over the real pixels only: padding would dilute it
        top10 = cc.dynamic_threshold_inputs(page_maps, valid_rows.sum(dim=1) * w4)
        scaling = torch.clamp(top10 / 0.7, 0.0, 1.0) ** 0.5
        low = torch.clamp(settings.DETECTOR_BLANK_THRESHOLD * scaling, 0.1, 0.6)
        thr = torch.clamp(settings.DETECTOR_TEXT_THRESHOLD * scaling, 0.15, 0.8)
        stats, n_comp, n_raw = cc.component_stats(page_maps, low, max_comps=max_comps)
        return torch.cat([stats.reshape(P, -1), n_comp[:, None].float(), n_raw[:, None].float(), thr[:, None]], 1)

    # -- batches ---------------------------------------------------------------

    def batch_detection(
        self, images: List[Image.Image], batch_size=None, include_maps=False
    ) -> Generator[Tuple[list, List[Tuple[int, int]]], None, None]:
        """Yields, per batch, its pages' sizes and, per page, either a stats
        dict (the stats path; see heatmap.get_boxes_from_stats_result) or its
        stitched processor-size maps (text map, then the vertical-line map
        when include_maps)."""
        if not all(isinstance(image, Image.Image) for image in images):
            raise TypeError("DetectionPredictor takes PIL images")
        if batch_size is None:
            batch_size = self.get_batch_size()
        proc_h = self.processor_size[0]
        orig_sizes = [image.size for image in images]
        splits_per_image = [get_total_splits(size, proc_h) for size in orig_sizes]
        n_maps = self.config.num_classes if include_maps else 1
        device_resize = on_for_cuda(settings.DETECTOR_DEVICE_RESIZE, self.device)

        # pack pages into batches of at most eff_batch chunks, so that a
        # multi-page call is two dispatches or more
        eff_batch = self.pipeline_cap(settings.DETECTOR_PIPELINE_BATCH, batch_size)
        batches: List[List[int]] = []
        current: List[int] = []
        current_size = 0
        for i in range(len(images)):
            if current_size + splits_per_image[i] > eff_batch:
                if current:
                    batches.append(current)
                current, current_size = [], 0
            current.append(i)
            current_size += splits_per_image[i]
        if current:
            batches.append(current)

        inflight = None
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
            # rows: the next power of two up to batch_size (not eff_batch: a
            # tall page may exceed the cap and lands in a shared bucket)
            bucket = 1
            while bucket < min(n_real, batch_size):
                bucket *= 2
            rows = min(max(bucket, n_real), max(batch_size, n_real))

            with stage("detection.prepare"):
                if device_resize:
                    pixels, resize_host = self._canvas(image_splits, rows)
                else:
                    pixels, resize_host = self._prepared(image_splits, rows), None
            device_stats = on_for_cuda(settings.DETECTOR_ON_DEVICE_POSTPROCESS, self.device) and not include_maps
            rec = {
                "batch_image_idxs": batch_image_idxs, "split_index": split_index, "split_heights": split_heights,
                "n_real": n_real, "n_pages": len(batch_image_idxs),
            }
            with stage("detection.forward"), self._on_stream(), torch.inference_mode():
                # one upload; the stats program and the maps program (the main
                # path or the overflow route) read the same device pixels
                rec["pixels"] = self._upload(pixels)
                if resize_host is not None:
                    uniq, gid = resize_host
                    n_groups = 1
                    while n_groups < len(uniq):
                        n_groups *= 2
                    Vs, Hs = self._resize_mats(uniq, n_groups, pixels.shape[1:3])
                    rec["resize"] = (Vs, Hs, self._upload(gid))
                else:
                    rec["resize"] = None
                if device_stats:
                    page_gather, valid_rows = self._page_plan(split_index, split_heights, splits_per_image,
                                                              batch_image_idxs)
                    rec.update(mode="stats", max_comps=settings.DETECTOR_MAX_COMPONENTS)
                    rec["out"] = self._fetch(self._stats_program(
                        rec["pixels"], rec["resize"], self._upload(page_gather), self._upload(valid_rows),
                        rec["max_comps"],
                    ))
                else:
                    rec.update(mode="maps", n_maps=n_maps)
                    rec["out"] = self._fetch(self._maps_program(rec["pixels"], rec["resize"], n_real, n_maps))
            # fetch the previous batch only now that this one is enqueued
            if inflight is not None:
                yield self._finish(inflight, orig_sizes)
            inflight = rec
        if inflight is not None:
            yield self._finish(inflight, orig_sizes)

    def _canvas(self, image_splits, rows: int):
        """Device-resize input: the chunks at their own sizes on a zeroed
        uint8 canvas [rows, Hb, Wb, C] (C = 1 when every chunk is gray), in
        pinned memory on CUDA; and (the sorted distinct sizes, each row's
        size group)."""
        raw = [np.asarray(part, np.uint8) for part in image_splits]
        sizes = [r.shape[:2] for r in raw]
        Hb = -(-max(s[0] for s in sizes) // CANVAS_BUCKET) * CANVAS_BUCKET
        Wb = -(-max(s[1] for s in sizes) // CANVAS_BUCKET) * CANVAS_BUCKET
        gray = settings.DETECTOR_GRAYSCALE_SHIP is not False and all(self.is_gray(r) for r in raw)
        C = 1 if gray else 3
        buf = self._host_buffer((rows, Hb, Wb, C))
        canvas = buf.numpy()
        canvas.fill(0)
        for i, r in enumerate(raw):
            canvas[i, : r.shape[0], : r.shape[1]] = r[..., :C]
        uniq = sorted(set(sizes))
        gid = np.zeros(rows, np.int64)
        gid[: len(raw)] = [uniq.index(s) for s in sizes]
        return buf, (uniq, gid)

    def _prepared(self, image_splits, rows: int) -> torch.Tensor:
        """Host-resize input: each chunk double-LANCZOS resized by PIL, the
        batch padded to rows with copies of its last chunk, one channel when
        it is gray."""
        if len(image_splits) >= settings.DETECTOR_MIN_PARALLEL_THRESH and (os.cpu_count() or 1) > 1:
            with ThreadPoolExecutor(max_workers=settings.DETECTOR_POSTPROCESSING_CPU_WORKERS) as pool:
                prepared = list(pool.map(self.prepare_image, image_splits))
        else:
            prepared = [self.prepare_image(part) for part in image_splits]
        pixels = np.stack(prepared, axis=0)
        if rows > len(prepared):
            pixels = np.pad(pixels, [(0, rows - len(prepared))] + [(0, 0)] * 3, mode="edge")
        if settings.DETECTOR_GRAYSCALE_SHIP is not False:
            pixels = self.gray_ship(pixels)
        return torch.from_numpy(pixels)

    def _page_plan(self, split_index, split_heights, splits_per_image, batch_image_idxs):
        """(page_gather [P, K], valid_rows [P, K]) int32 for the stats program:
        each page's chunk rows (-1 for none) and the real head-resolution rows
        of each; P is the page count rounded up to a power of two."""
        n_pages = len(batch_image_idxs)
        K = max(splits_per_image[j] for j in batch_image_idxs)
        P = 1
        while P < n_pages:
            P *= 2
        page_gather = np.full((P, K), -1, np.int32)
        valid_rows = np.zeros((P, K), np.int32)
        for i, (idx, height) in enumerate(zip(split_index, split_heights)):
            k = int(np.sum(page_gather[idx] >= 0))
            page_gather[idx, k] = i
            valid_rows[idx, k] = height
        proc_h = self.processor_size[0]
        h4 = proc_h // 4  # the decode head's stride
        vr = np.ceil(valid_rows * h4 / proc_h).astype(np.int32)
        vr[:, 0] = np.where(page_gather[:, 0] >= 0, h4, 0)  # a page's first chunk is never cropped
        return page_gather, vr

    def _finish(self, rec, orig_sizes):
        """The yield value of a dispatched batch, once its outputs landed."""
        sizes_out = [orig_sizes[j] for j in rec["batch_image_idxs"]]
        proc_h, proc_w = self.processor_size
        if rec["mode"] == "stats":
            with stage("detection.device_get"):
                [out] = self._wait(rec["out"])
            max_comps, n_pages = rec["max_comps"], rec["n_pages"]
            n_raw = out[:n_pages, -2].astype(np.int64)
            if (n_raw <= max_comps).all():
                self.stats_batches += 1
                stats = out[:, : max_comps * cc.STATS_DIM].reshape(-1, max_comps, cc.STATS_DIM)
                pages = []
                for idx in range(n_pages):
                    heights = [h for i, h in zip(rec["split_index"], rec["split_heights"]) if i == idx]
                    page_h = proc_h if len(heights) == 1 else proc_h * (len(heights) - 1) + min(heights[-1], proc_h)
                    pages.append({
                        "stats": stats[idx], "n_comp": int(out[idx, -3]), "text_threshold": float(out[idx, -1]),
                        "page_hw": (page_h, proc_w),
                    })
                return pages, sizes_out
            # a page's components were truncated: this batch takes the maps
            # path on the pixels already on the device, so no box is lost
            logger.warning("page exceeded DETECTOR_MAX_COMPONENTS=%d (%d components); the maps path for "
                           "this batch", max_comps, int(n_raw.max()))
            with stage("detection.forward"), self._on_stream(), torch.inference_mode():
                rec["out"] = self._fetch(self._maps_program(rec["pixels"], rec["resize"], rec["n_real"], 1))
            rec["n_maps"] = 1
        self.maps_batches += 1
        with stage("detection.device_get"):
            [compact] = self._wait(rec["out"])
        preds: List[List[np.ndarray]] = []
        with stage("detection.stitch"):
            for i, (idx, height) in enumerate(zip(rec["split_index"], rec["split_heights"])):
                # host bilinear upsample of the uint8 1/4-resolution maps
                maps = [cv2.resize(compact[i, k], (proc_w, proc_h), interpolation=cv2.INTER_LINEAR)
                        for k in range(rec["n_maps"])]
                if len(preds) <= idx:
                    preds.append(maps)
                else:
                    if height < proc_h:
                        maps = [m[:height, :] for m in maps]
                    preds[idx] = [np.vstack([old, new]) for old, new in zip(preds[idx], maps)]
        return preds, sizes_out
