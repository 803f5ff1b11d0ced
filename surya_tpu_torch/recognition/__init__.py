"""Text recognition predictor of the PyTorch port, with continuous batching.

Counterpart of surya_tpu/recognition/__init__.py: lines given as ``bboxes=``
or ``polygons=``, or found by a ``det_predictor`` (whole-page OCR: detect,
slice, recognize). The scheduler keeps everything that decides outputs:
the width-sorted queue, cache slots plus a trash slot, prefill waves under
slot and patch budgets with ``min_prefill_ratio``, prefill row buckets and
sequence buckets, a cache sized to the workload, per-chunk stop scans on the
host with kill masks sent down with the next dispatch, the device-side
repeat stop and pinned decode, over a bf16 or (``RECOGNITION_MODEL_QUANTIZE``)
an int8 KV cache.

It is pipelined as the JAX scheduler is: the slot state (last token, active,
repeat run) lives on the device and is threaded through every dispatch, so
one dispatch stays in flight and its packed outputs are read only after the
next one is enqueued (a copy to pinned host memory, waited for on an
event); a builder thread packs the next prefill wave (pure numpy) while the
device runs; a wave that is built waits, held, for its slots; when the
in-flight outputs already exhaust every budget the loop drains first; and
when no further wave can follow, the decode chunk is fused into the prefill
dispatch (``fuse_decode``), both outputs read together. On CUDA the
predictor runs on a stream of its own.

Whole-page OCR of more than RECOGNITION_DET_PIPELINE_PAGES pages streams:
detection of page group k + 1 runs in a worker thread and feeds the live
run (``feeder``); prompts that do not fit the first group's cache run in a
follow-up loop and are spliced back by id. ``stream()`` serves a page
stream, yielding each page's result in order as soon as it completes.
"""

from __future__ import annotations

import queue as queue_mod
import re
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import cv2
import numpy as np
import torch
from tqdm import tqdm

from surya_tpu_torch.common.polygon import PolygonBox
from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.common.profiling import stage
from surya_tpu_torch.input.processing import convert_if_not_rgb, slice_bboxes_from_image, slice_polys_from_image
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.recognition.loader import load_recognition_model
from surya_tpu_torch.recognition.postprocessing import fix_unbalanced_tags
from surya_tpu_torch.recognition.processor import MIN_IMAGE_SIZE
from surya_tpu_torch.recognition.schema import OCRResult, TextChar, TextLine
from surya_tpu_torch.recognition.tokenizer import NOMATH_TOKEN, TaskNames
from surya_tpu_torch.recognition.util import (
    REPEAT_WINDOW,
    chunk_stop_scan,
    clean_close_polygons,
    clean_math_tags,
    detect_repeat_token,
    prediction_to_polygon_batch,
    sort_text_lines,
    unwrap_math,
    words_from_chars,
)
from surya_tpu_torch.settings import settings

# what a prediction_loop feeder returns when its prompt stream is over
FEED_DONE = object()


@dataclass
class RecognitionPrompt:
    id: int
    task_name: str
    image: np.ndarray
    text: Optional[str]
    math_mode: bool


def _pack(tokens, scores, bboxes):
    """tokens/scores/bboxes -> one float32 array [..., 8], fetched in one copy."""
    return torch.cat([tokens.float()[..., None], scores[..., None], bboxes.float()], dim=-1)


def _empty_results(images) -> List[OCRResult]:
    return [OCRResult(text_lines=[], image_bbox=[0, 0, img.size[0], img.size[1]]) for img in images]


class RecognitionPredictor(BasePredictor):
    batch_size_setting = "RECOGNITION_BATCH_SIZE"
    default_batch_sizes = {"cpu": 8, "cuda": 128}
    min_prefill_ratio: float = 0.2
    # fuse the next decode chunk into a prefill dispatch when no further wave
    # can follow it; off gives a plain prefill and decode split for profiling
    fuse_decode: bool = True
    tasks = {
        TaskNames.ocr_with_boxes: {"img_size": (1024, 256), "max_tokens": 224},
        TaskNames.ocr_without_boxes: {"img_size": (1024, 256), "max_tokens": 224},
        TaskNames.block_without_boxes: {"img_size": (1024, 512), "max_tokens": 768},
    }

    def __init__(self, checkpoint: Optional[str] = None, tiny: bool = False, *, device=None,
                 jax_params: Optional[dict] = None):
        """checkpoint: a local directory or ``s3://`` name (default
        RECOGNITION_MODEL_CHECKPOINT); tiny: the small test configuration of
        random weights; jax_params: the JAX foundation pytree as numpy
        leaves, whose weights the model takes (no checkpoint is resolved)."""
        self._tiny = tiny
        self._jax_params = jax_params
        super().__init__(checkpoint, device)

    def _load(self):
        self.model, self.config, self.processor = load_recognition_model(
            self.checkpoint, self._tiny, self.device, self._jax_params
        )
        self._jax_params = None
        self.last_decoded_tokens = 0  # tokens decoded by the last __call__ or stream()
        self.dtype = self.model.token_embed.weight.dtype
        batch = self.get_batch_size()
        self.n_slots = batch  # plus one trash slot that padding rows write
        self.prefill_rows = max(1, batch // 4)
        # a big refill wave (e.g. the initial fill) goes through one large prefill
        self.prefill_row_buckets = (self.prefill_rows, min(self.n_slots + 1, self.prefill_rows * 4))
        self.decode_chunk = settings.RECOGNITION_DECODE_CHUNK
        self.seq_buckets = tuple(settings.RECOGNITION_SEQ_BUCKETS)
        # patch-capacity buckets per prefill wave: the smallest that fits is used
        max_cap = max(8192, -(-self.prefill_rows * 1536 // 512) * 512)
        caps = [4096]
        while caps[-1] < max_cap:
            caps.append(min(caps[-1] * 2, max_cap))
        self.patch_caps = tuple(caps)
        self.patch_cap = max_cap

    # -- device programs -------------------------------------------------------
    # Nothing here waits for the device: no read of a device value, no copy
    # from pageable host memory, no boolean-mask indexing.

    def _apply_kill(self, last_token, active, kill):
        """Stops the host found (budget, repeats) reach the device with the
        next dispatch: deactivate killed slots before running it."""
        return torch.where(kill, self.config.pad_token_id, last_token), active & ~kill

    def _seed_slots(self, last_token, active, run, tok, slot_idx, row_valid, pin: bool):
        """Device state of the newly filled slots, from prefill token 0."""
        cfg = self.config
        done0 = torch.zeros_like(row_valid) if pin else (tok == cfg.eos_token_id) | (tok == self.processor.no_output_token)
        lt_new = torch.where((tok == cfg.eos_token_id) | (tok == cfg.pad_token_id), cfg.pad_token_id, tok)
        idx = (slot_idx.long(),)
        last_token = last_token.index_put(idx, torch.where(row_valid, lt_new, last_token[idx]))
        active = active.index_put(idx, torch.where(row_valid, ~done0, active[idx]))
        run = run.index_put(idx, torch.where(row_valid, 1, run[idx]))  # token 0 starts each run
        return last_token, active, run

    def _prefill(self, cache, batch, slot_idx, row_valid, state, kill, pin: bool):
        """One prefill wave on the device: the wave's inputs are uploaded,
        killed slots deactivated, the prompts encoded into their cache slots
        and token 0 sampled. Returns (packed outputs [rows, 8], state)."""
        last_token, active, run = state
        last_token, active = self._apply_kill(last_token, active, self._upload(kill))
        up = self._upload
        layout = batch.layout
        slot_idx_t = up(slot_idx)
        tok, score, bbox = self.model.prefill(
            cache,
            self.processor.normalize_patch_rows(up(batch.patches), self.dtype),
            tuple(up(a) for a in layout.device_args), up(layout.llm_h_idx), up(layout.llm_w_idx),
            up(batch.input_ids), up(batch.img_gather), up(batch.seq_lens), slot_idx_t,
            kv_range=layout.kv_range, win_range=layout.win_range,
        )
        state = self._seed_slots(last_token, active, run, tok, slot_idx_t, up(row_valid), pin)
        return _pack(tok, score, bbox), state

    def _decode(self, cache, state, kill, pin: bool):
        """One decode chunk on the device (kill: None when it was applied by a
        prefill fused before it). Returns (packed outputs [slots, K, 8], state)."""
        last_token, active, run = state
        if kill is not None:
            last_token, active = self._apply_kill(last_token, active, self._upload(kill))
        toks, scores, bboxes, last_token, active, run = self.model.decode_chunk(
            cache, last_token, active, self.decode_chunk, run=run,
            repeat_window=0 if pin else REPEAT_WINDOW, pin_decode=pin,
        )
        return _pack(toks, scores, bboxes), (last_token, active, run)

    def _dispatch_prefill(self, cache, batch, slot_idx, row_valid, state, kill, pin: bool, fuse: bool):
        """Enqueue a prefill wave, fused with the decode chunk after it, and
        the copies of their packed outputs. Returns (fetch handle, state)."""
        packed, state = self._prefill(cache, batch, slot_idx, row_valid, state, kill, pin)
        if not fuse:
            return self._fetch(packed), state
        decode_packed, state = self._decode(cache, state, None, pin)
        return self._fetch(packed, decode_packed), state

    def _dispatch_decode(self, cache, state, kill, pin: bool):
        """Enqueue a decode chunk and the copy of its packed outputs.
        Returns (fetch handle, state)."""
        packed, state = self._decode(cache, state, kill, pin)
        return self._fetch(packed), state

    # -- slicing (host) --------------------------------------------------------

    def detect_and_slice_bboxes(self, images, task_names, det_predictor, detection_batch_size=None,
                                highres_images=None):
        """Detect the lines of each page and slice them; with a highres page,
        the polygons are scaled to it and the slices cut from it."""
        with stage("recognition.detect"):
            det_predictions = det_predictor(images, batch_size=detection_batch_size)
        if highres_images is None:
            highres_images = [None] * len(images)
        all_slices, slice_map, all_polygons, all_task_names, all_res_scales = [], [], [], [], []
        for det_pred, image, highres, task_name in zip(det_predictions, images, highres_images, task_names):
            polygons = [p.polygon for p in det_pred.bboxes]
            with stage("recognition.slice"):
                if highres is not None:
                    sx = highres.size[0] / image.size[0]
                    sy = highres.size[1] / image.size[1]
                    scaled = [[[int(p[0] * sx), int(p[1] * sy)] for p in poly] for poly in polygons]
                    slices = slice_polys_from_image(np.asarray(highres), scaled)
                    res_scales = [(sx, sy)] * len(slices)
                else:
                    slices = slice_polys_from_image(np.asarray(image), polygons)
                    res_scales = [(1, 1)] * len(slices)
            slice_map.append(len(slices))
            all_slices.extend(slices)
            all_polygons.extend(polygons)
            all_task_names.extend([task_name] * len(slices))
            all_res_scales.extend(res_scales)
        return {
            "slices": all_slices,
            "slice_map": slice_map,
            "polygons": all_polygons,
            "task_names": all_task_names,
            "input_text": [None] * len(all_slices),
            "res_scales": all_res_scales,
        }

    def slice_bboxes(self, images, task_names, bboxes=None, polygons=None, input_text=None):
        if bboxes is None and polygons is None:
            raise ValueError("need bboxes or polygons")
        slice_map, all_slices, all_polygons, all_text, all_task_names = [], [], [], [], []
        for idx, image in enumerate(images):
            arr = np.asarray(image)
            if polygons is not None:
                polys = polygons[idx]
                slices = slice_polys_from_image(arr, polys)
            else:
                slices = slice_bboxes_from_image(arr, bboxes[idx])
                polys = [[[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]] for b in bboxes[idx]]
            slice_map.append(len(slices))
            all_slices.extend(slices)
            all_polygons.extend(polys)
            all_task_names.extend([task_names[idx]] * len(slices))
            all_text.extend([None] * len(slices) if input_text is None else input_text[idx])
        return {
            "slices": all_slices,
            "slice_map": slice_map,
            "polygons": all_polygons,
            "input_text": all_text,
            "task_names": all_task_names,
            "res_scales": [(1, 1)] * len(all_slices),
        }

    def _prepare_image(self, image: np.ndarray, task_name: str) -> np.ndarray:
        # a degenerate crop becomes a blank at scale_to_fit's minimum size
        blank = np.zeros((MIN_IMAGE_SIZE, MIN_IMAGE_SIZE, 3), np.uint8)
        if image.shape[0] == 0 or image.shape[1] == 0:
            return blank
        try:
            return self.processor.scale_to_fit(image, self.tasks[task_name]["img_size"])
        except cv2.error:
            return blank

    def _estimate_window_slots(self, image: np.ndarray) -> int:
        f = self.processor.factor
        p = self.config.encoder.patch_size
        grid = (
            max(f, -(-int(image.shape[0]) // f) * f) // p,
            max(f, -(-int(image.shape[1]) // f) * f) // p,
        )
        return self.processor.window_slots_needed(grid)

    # -- the scheduler ---------------------------------------------------------

    @torch.inference_mode()
    def prediction_loop(self, flat: dict, recognition_batch_size=None, math_mode=True,
                        feeder=None, leftover_sink=None, on_done=None, prompt_bound_override=None):
        """Continuous-batching scheduler over the prompts of `flat`. Returns
        (tokens per prompt, bbox array [n, T, 6], scores per prompt), in the
        order the prompts arrived.

        With `feeder`, the prompts are a stream: feeder(block) returns the
        next group's flat dict, None when none is ready yet (only when not
        block), or FEED_DONE when the stream is over; its prompts join the
        live run (one cache). Prompts whose bound exceeds the cache sized for
        the first group go to `leftover_sink` instead. `on_done(pid, tokens,
        scores, bbox_arr)` fires when a prompt completes; a
        `prompt_bound_override` sizes the cache's prompt area to at least
        that many tokens (surya_tpu prediction_loop)."""
        with self._on_stream():
            return self._prediction_loop(flat, recognition_batch_size, math_mode, feeder, leftover_sink, on_done,
                                         prompt_bound_override)

    def _prediction_loop(self, flat, recognition_batch_size, math_mode, feeder, leftover_sink, on_done,
                         prompt_bound_override):
        if feeder is not None and leftover_sink is None:
            leftover_sink = []
        predicted_tokens: List[List[int]] = []
        scores: List[List[float]] = []
        bboxes: List[List[np.ndarray]] = []

        B = recognition_batch_size or self.get_batch_size()
        cfg = self.config
        eos, pad, nop = cfg.eos_token_id, cfg.pad_token_id, self.processor.no_output_token
        # pinned mode: only the per-prompt token budget stops a prompt
        pin = bool(settings.RECOGNITION_PIN_DECODE)

        queue = deque()
        max_tokens = {}
        cache_len = None  # set once the first prompts size the cache

        def add_prompts(f, fit_check=False):
            """A group's prompts: ids in arrival order, enqueued widest
            first. With fit_check, a prompt whose bound and budget exceed the
            cache goes to leftover_sink."""
            base = len(predicted_tokens)
            group = list(zip(f["slices"], f["input_text"], f["task_names"]))
            for _, _, task in group:
                predicted_tokens.append([])
                scores.append([])
                bboxes.append([])
                max_tokens[len(predicted_tokens) - 1] = settings.RECOGNITION_MAX_TOKENS or self.tasks[task]["max_tokens"]
            for j in sorted(range(len(group)), key=lambda j: -group[j][0].shape[1]):
                img, txt, task = group[j]
                prompt = RecognitionPrompt(id=base + j, task_name=task, image=img, text=txt, math_mode=math_mode)
                if fit_check and self.processor.prompt_len_bound(
                        img.shape, self.tasks[task]["img_size"], task, txt, math_mode) + max_tokens[prompt.id] > cache_len:
                    leftover_sink.append(prompt)
                    continue
                queue.append(prompt)

        add_prompts(flat)
        feed_exhausted = feeder is None
        # an empty first group must not size the cache: pull until a prompt
        # exists or the stream ends
        while not queue and not feed_exhausted:
            nxt = feeder(True)
            if nxt is FEED_DONE:
                feed_exhausted = True
            else:
                add_prompts(nxt)

        n_slots = min(B, self.n_slots)
        # size the cache to the longest prompt bucket + generation budget of
        # this workload: decode attention reads every valid row each step
        max_prompt = int(prompt_bound_override or 0)
        for p in queue:
            max_prompt = max(max_prompt, self.processor.prompt_len_bound(
                p.image.shape, self.tasks[p.task_name]["img_size"], p.task_name, p.text, p.math_mode
            ))
        prompt_bucket = next((b for b in self.seq_buckets if b >= max_prompt), self.seq_buckets[-1])
        cache_len = min(
            cfg.max_sequence_length,
            -(-(prompt_bucket + max(max_tokens.values(), default=0)) // 256) * 256,
        )
        cache = qwen_decoder.init_cache(
            cfg.decoder, n_slots + 1, cache_len, self.dtype, self.device,
            quantize=settings.RECOGNITION_MODEL_QUANTIZE,
        )
        slot_prompt: List[Optional[int]] = [None] * n_slots
        # the slot state on the device (last token, active, repeat run), its
        # shadow on the host for scheduling, and the kill mask that carries
        # stops only the host sees down with the next dispatch
        state = (
            torch.full((n_slots + 1,), pad, dtype=torch.int32, device=self.device),
            torch.zeros((n_slots + 1,), dtype=torch.bool, device=self.device),
            torch.zeros((n_slots + 1,), dtype=torch.int32, device=self.device),
        )
        host_active = np.zeros(n_slots + 1, bool)
        pending_kill = np.zeros(n_slots + 1, bool)
        pbar = tqdm(total=len(predicted_tokens), desc="Recognizing Text", disable=self.disable_tqdm)

        def take_kill():
            kill = pending_kill.copy()
            pending_kill[:] = False
            return kill

        def decoding() -> bool:
            return any(slot_prompt[s] is not None and host_active[s] for s in range(n_slots))

        def finish(slot, device_knows: bool):
            """Free a slot. device_knows: the device stopped it itself (EOS or
            pad); otherwise the kill mask tells it with the next dispatch."""
            pid = slot_prompt[slot]
            slot_prompt[slot] = None
            host_active[slot] = False
            if not device_knows:
                pending_kill[slot] = True
            pbar.update(1)
            if on_done is not None:
                bb = bboxes[pid]
                on_done(pid, predicted_tokens[pid], scores[pid],
                        np.concatenate(bb, axis=0) if bb else np.zeros((0, 6), np.float32))

        def process_decode(packed):
            # a vectorized stop scan over the [slots, K] chunk: Python runs
            # per slot (extend and finish), never per token
            toks = packed[..., 0].astype(np.int32)
            chunk_scores = packed[..., 1]
            chunk_bboxes = packed[..., 2:]
            act = [s for s in range(n_slots) if slot_prompt[s] is not None and host_active[s]]
            if not act:
                return
            K = self.decode_chunk
            W = REPEAT_WINDOW
            ctoks = toks[act, :K]
            prior = np.array([len(predicted_tokens[slot_prompt[s]]) for s in act])
            budget = np.array([max_tokens[slot_prompt[s]] for s in act])
            if pin:
                # the budget is the only stop, and the device never sees it
                hit = prior[:, None] + np.arange(1, K + 1)[None, :] >= budget[:, None]
                any_stop = hit.any(axis=1)
                cut = np.where(any_stop, hit.argmax(axis=1), K - 1)
            else:
                tails = np.full((len(act), W - 1), -1, np.int32)
                for i, s in enumerate(act):
                    h = predicted_tokens[slot_prompt[s]][-(W - 1):]
                    if h:
                        tails[i, -len(h):] = h
                any_stop, cut = chunk_stop_scan(ctoks, prior, budget, tails, eos, pad, W)
            for i, s in enumerate(act):
                pid = slot_prompt[s]
                k = int(cut[i]) + 1
                predicted_tokens[pid].extend(ctoks[i, :k].tolist())
                scores[pid].extend(chunk_scores[s, :k].tolist())
                bboxes[pid].append(chunk_bboxes[s, :k])
                if any_stop[i]:
                    # EOS or pad at the cut: the device stopped the slot itself
                    finish(s, device_knows=(not pin) and int(ctoks[i, int(cut[i])]) in (eos, pad))

        def build_wave(slot_budget: int):
            """Pop prompts from the queue under the slot and patch budgets and
            pack their prefill batch: numpy only, run in the builder thread
            while the device works (one build at a time touches the queue)."""
            round_prompts: List[RecognitionPrompt] = []
            imgs: List[np.ndarray] = []
            patch_budget = self.patch_cap
            while queue and len(round_prompts) < slot_budget:
                img = self._prepare_image(queue[0].image, queue[0].task_name)
                need = self._estimate_window_slots(img)
                if round_prompts and need > patch_budget:
                    break
                round_prompts.append(queue.popleft())
                imgs.append(img)
                patch_budget -= need
            if not round_prompts:
                return None
            batch_rows = next(b for b in self.prefill_row_buckets if b >= len(round_prompts))
            with stage("recognition.prefill_build"):
                batch = self.processor.build_prefill_batch(
                    imgs,
                    [p.task_name for p in round_prompts],
                    [p.text for p in round_prompts],
                    [p.math_mode for p in round_prompts],
                    cfg.encoder,
                    batch_rows=batch_rows,
                    seq_buckets=self.seq_buckets,
                    patch_caps=self.patch_caps,
                )
            return round_prompts, batch, batch_rows

        def seed_from_prefill(packed, target_slots, round_prompts):
            """Host bookkeeping for prefill token 0; prompt i sits at row i.
            Its slots were taken when the wave was dispatched."""
            for row, (slot, prompt) in enumerate(zip(target_slots, round_prompts)):
                t = int(packed[row, 0])
                predicted_tokens[prompt.id].append(t)
                scores[prompt.id].append(0.0 if t in (eos, pad) else float(packed[row, 1]))
                bboxes[prompt.id].append(packed[row : row + 1, 2:])
                if not pin and t in (eos, nop):
                    finish(slot, device_knows=True)

        # one dispatch stays in flight: its outputs are read only after the
        # next dispatch is enqueued, so the host's wait and its scan of one
        # dispatch overlap the device's work on the next
        inflight = None

        def drain_inflight():
            nonlocal inflight
            if inflight is None:
                return
            rec, inflight = inflight, None
            with stage(f"recognition.drain_{rec['kind']}"):
                packed = self._wait(rec["handle"])
            if rec["kind"] == "prefill":
                seed_from_prefill(packed[0], rec["slots"], rec["prompts"])
            if len(packed) > 1 or rec["kind"] == "decode":
                process_decode(packed[-1])

        builder = ThreadPoolExecutor(max_workers=1)
        pending = None  # the build of the next wave, in the builder thread
        held = None  # a built wave waiting for enough free slots
        try:
            while (queue or held is not None or pending is not None or inflight is not None
                   or any(p is not None for p in slot_prompt) or not feed_exhausted):
                # streaming: top up when the queue can no longer fill the
                # largest wave; block only when the loop would otherwise idle
                if not feed_exhausted and len(queue) < self.prefill_row_buckets[-1]:
                    idle = not (queue or held is not None or pending is not None or inflight is not None
                                or any(p is not None for p in slot_prompt))
                    nxt = feeder(idle)
                    if nxt is FEED_DONE:
                        feed_exhausted = True
                    elif nxt is not None:
                        add_prompts(nxt, fit_check=True)
                        # leftovers run in a follow-up loop with a bar of its own
                        pbar.total = len(predicted_tokens) - len(leftover_sink)
                        pbar.refresh()
                frees = [i for i, p in enumerate(slot_prompt) if p is None]
                if held is None and pending is not None:
                    # wait for an unfinished build only when no slot could decode
                    if pending.done() or not decoding():
                        held, pending = pending.result(), None
                        if held is None:
                            continue
                if held is not None and len(held[0]) <= len(frees):
                    # the in-flight outputs land first: their stops free slots
                    # that must not be given to the wave's prompts before
                    drain_inflight()
                    frees = [i for i, p in enumerate(slot_prompt) if p is None]
                    (round_prompts, batch, batch_rows), held = held, None
                    target_slots = frees[: len(round_prompts)]
                    slot_idx = np.full(batch_rows, n_slots, np.int32)  # padding rows -> trash slot
                    slot_idx[: len(round_prompts)] = target_slots
                    row_valid = np.arange(batch_rows) < len(round_prompts)
                    # fuse the next decode chunk when no further wave can follow
                    fuse = self.fuse_decode and (
                        not queue or (len(frees) - len(round_prompts)) / n_slots <= self.min_prefill_ratio
                    )
                    with stage("recognition.prefill"):
                        handle, state = self._dispatch_prefill(cache, batch, slot_idx, row_valid, state,
                                                               take_kill(), pin, fuse)
                    # the dispatch is in flight: build the next wave meanwhile,
                    # sized to this one (at steady state its slots free up)
                    if queue and pending is None:
                        pending = builder.submit(build_wave, min(len(round_prompts), self.prefill_row_buckets[-1]))
                    for slot, prompt in zip(target_slots, round_prompts):
                        slot_prompt[slot] = prompt.id
                        host_active[slot] = True
                    inflight = {"kind": "prefill", "handle": handle, "slots": target_slots, "prompts": round_prompts,
                                "fused": fuse}
                elif held is None and pending is None and queue and len(frees) / n_slots > self.min_prefill_ratio:
                    # no wave built or building: start one; while slots decode
                    # the loop keeps sending decode chunks under it
                    pending = builder.submit(build_wave, min(len(frees), self.prefill_row_buckets[-1]))
                elif decoding():
                    # drain first when the in-flight outputs already exhaust
                    # every active slot's budget: a further chunk would decode
                    # K tokens the budget scan throws away
                    if inflight is not None:
                        if inflight["kind"] == "decode":
                            def pending_for(s):
                                return self.decode_chunk
                        else:
                            # a wave gives its new slots token 0 (and a fused
                            # chunk); the other slots get the fused chunk or nothing
                            new_slots = set(inflight["slots"])
                            fused_k = self.decode_chunk if inflight["fused"] else 0

                            def pending_for(s):
                                return (1 + fused_k) if s in new_slots else fused_k
                        if all(len(predicted_tokens[slot_prompt[s]]) + pending_for(s) >= max_tokens[slot_prompt[s]]
                               for s in range(n_slots) if slot_prompt[s] is not None and host_active[s]):
                            drain_inflight()
                            continue
                    # decode chunk N + 1 is enqueued before chunk N is read
                    with stage("recognition.decode"):
                        handle, state = self._dispatch_decode(cache, state, take_kill(), pin)
                    drain_inflight()
                    inflight = {"kind": "decode", "handle": handle}
                else:
                    drain_inflight()
        finally:
            builder.shutdown(wait=True)
            pbar.close()

        self.last_decoded_tokens += sum(len(t) for t in predicted_tokens)

        n = len(predicted_tokens)
        max_len = max((sum(b.shape[0] for b in bs) for bs in bboxes if bs), default=1)
        bbox_arr = np.zeros((n, max(max_len, 1), 6), np.float32)
        for i, bs in enumerate(bboxes):
            if bs:
                cat = np.concatenate(bs, axis=0)
                bbox_arr[i, : len(cat)] = cat
        return predicted_tokens, bbox_arr, scores

    # -- detokenization and assembly (host) ------------------------------------

    def get_bboxes_text(self, flat, predicted_tokens, scores, predicted_polygons, drop_repeated_text=False):
        char_predictions = []
        tok = self.processor.tokenizer
        eos, pad = self.config.eos_token_id, self.config.pad_token_id
        blank_bbox = [[0, 0], [0, 1], [1, 1], [1, 0]]

        for image_tokens, image_polygons, image_scores in zip(predicted_tokens, predicted_polygons, scores):
            if self.processor.no_output_token in image_tokens:
                char_predictions.append(None)
                continue
            if drop_repeated_text and detect_repeat_token(image_tokens):
                char_predictions.append([TextChar(text="", polygon=blank_bbox, confidence=0, bbox_valid=False)])
                continue

            image_polygons = image_polygons[: len(image_tokens)].tolist()
            # split the stream into qwen / special / utf-16 runs
            sequences = []
            current: List[tuple] = []
            current_kind = None
            for bbox, char_id, score in zip(image_polygons, image_tokens, image_scores):
                if char_id in (eos, pad):
                    break
                if char_id < tok.qwen_offset:
                    kind = "qwen"
                elif char_id < tok.special_token_offset:
                    kind = "special"
                else:
                    kind = "ocr"
                if kind != current_kind or kind == "special":
                    if current:
                        sequences.append((current, current_kind))
                    current, current_kind = [], kind
                current.append((char_id, score, bbox))
            if current:
                sequences.append((current, current_kind))

            img_chars: List[TextChar] = []
            for seq, kind in sequences:
                token_ids = [s[0] for s in seq]
                seq_scores = [s[1] for s in seq]
                if kind == "ocr":
                    text = tok.decode(token_ids, task=TaskNames.ocr_with_boxes)
                    polys = clean_close_polygons([s[2] for s in seq])
                    bbox_idx = 0
                    for ch in text:
                        img_chars.append(
                            TextChar(text=ch, polygon=polys[bbox_idx], confidence=seq_scores[bbox_idx], bbox_valid=True)
                        )
                        if bbox_idx < len(polys) - 1:
                            bbox_idx += 1
                elif kind == "special":
                    text = tok.decode(token_ids, task=TaskNames.ocr_without_boxes)
                    if text == NOMATH_TOKEN or re.match(r"<SCRIPT-\w+>", text):
                        continue
                    img_chars.append(TextChar(text=text, polygon=blank_bbox, confidence=seq_scores[0], bbox_valid=False))
                else:
                    text = tok.decode(token_ids, task=TaskNames.block_without_boxes)
                    img_chars.append(TextChar(text=text, polygon=blank_bbox, confidence=seq_scores[0], bbox_valid=False))
            char_predictions.append(img_chars)
        return char_predictions

    # -- public API ------------------------------------------------------------

    def __call__(
        self,
        images,
        task_names: Optional[List[str]] = None,
        det_predictor=None,
        detection_batch_size: Optional[int] = None,
        recognition_batch_size: Optional[int] = None,
        highres_images=None,
        bboxes=None,
        polygons=None,
        input_text=None,
        sort_lines: bool = False,
        math_mode: bool = True,
        return_words: bool = False,
        drop_repeated_text: bool = False,
    ) -> List[OCRResult]:
        """Recognize the text of PIL images: in the given line boxes
        (``bboxes``: per image a list of [x0, y0, x1, y1]) or polygons, or in
        the lines ``det_predictor`` finds (whole-page OCR; ``highres_images``
        are sliced in place of the pages where given). Whole-page OCR of more
        than RECOGNITION_DET_PIPELINE_PAGES pages streams detection into the
        running recognition, with the outputs of detecting every page first.
        One OCRResult per page, empty where no line is found."""
        if task_names is None:
            task_names = [TaskNames.ocr_with_boxes] * len(images)
        if len(images) != len(task_names) or any(t not in self.tasks for t in task_names):
            raise ValueError(f"need one known task per image, got {task_names}")
        self.last_decoded_tokens = 0
        images = convert_if_not_rgb(images)
        kw = dict(sort_lines=sort_lines, return_words=return_words, drop_repeated_text=drop_repeated_text)
        if bboxes is None and polygons is None:
            if det_predictor is None:
                raise ValueError("need a detection predictor (det_predictor=) or line boxes (bboxes=/polygons=)")
            highres_images = (convert_if_not_rgb(highres_images) if highres_images is not None
                              else [None] * len(images))
            G = settings.RECOGNITION_DET_PIPELINE_PAGES
            if G and len(images) > G:
                return self._recognize_streaming(images, task_names, det_predictor, G, detection_batch_size,
                                                 recognition_batch_size, highres_images, math_mode, **kw)
            flat = self.detect_and_slice_bboxes(
                images, task_names, det_predictor,
                detection_batch_size=detection_batch_size, highres_images=highres_images,
            )
        else:
            flat = self.slice_bboxes(images, task_names, bboxes=bboxes, polygons=polygons, input_text=input_text)
        return self._recognize_flat(images, flat, recognition_batch_size=recognition_batch_size,
                                    math_mode=math_mode, **kw)

    def _recognize_streaming(self, images, task_names, det_predictor, G, detection_batch_size,
                             recognition_batch_size, highres_images, math_mode, **kw) -> List[OCRResult]:
        """Whole-page OCR in page groups of G: detection of group k + 1 runs
        in a worker thread and each finished group feeds the live run (one
        cache, no drain at group boundaries); prompts that do not fit the
        first group's cache run in a follow-up loop, spliced back by id."""
        spans = [(s, min(s + G, len(images))) for s in range(0, len(images), G)]

        def detect_span(span):
            s, e = span
            return self.detect_and_slice_bboxes(
                images[s:e], task_names[s:e], det_predictor,
                detection_batch_size=detection_batch_size, highres_images=highres_images[s:e],
            )

        leftovers: List[RecognitionPrompt] = []
        with ThreadPoolExecutor(max_workers=1) as det_worker:
            first = det_worker.submit(detect_span, spans[0]).result()
            merged = {k: list(v) for k, v in first.items()}
            state = {"next": 1, "fut": det_worker.submit(detect_span, spans[1]) if len(spans) > 1 else None}

            def feeder(block):
                fut = state["fut"]
                if fut is None:
                    return FEED_DONE
                if not block and not fut.done():
                    return None
                f = fut.result()
                state["next"] += 1
                state["fut"] = det_worker.submit(detect_span, spans[state["next"]]) \
                    if state["next"] < len(spans) else None
                for k in merged:
                    merged[k].extend(f[k])
                return f

            predicted_tokens, bbox_arr, scores = self.prediction_loop(
                first, recognition_batch_size=recognition_batch_size, math_mode=math_mode,
                feeder=feeder, leftover_sink=leftovers,
            )

        if not merged["slices"]:
            return _empty_results(images)
        if leftovers:
            lt_toks, lt_bbox, lt_scores = self.prediction_loop(
                {"slices": [p.image for p in leftovers], "input_text": [p.text for p in leftovers],
                 "task_names": [p.task_name for p in leftovers]},
                recognition_batch_size=recognition_batch_size, math_mode=math_mode,
            )
            if lt_bbox.shape[1] > bbox_arr.shape[1]:
                bbox_arr = np.pad(bbox_arr, ((0, 0), (0, lt_bbox.shape[1] - bbox_arr.shape[1]), (0, 0)))
            for j, p in enumerate(leftovers):
                predicted_tokens[p.id] = lt_toks[j]
                scores[p.id] = lt_scores[j]
                bbox_arr[p.id, : lt_bbox.shape[1]] = lt_bbox[j]
        return self._assemble_results(images, merged, predicted_tokens, scores, bbox_arr, **kw)

    def stream(
        self,
        images,
        det_predictor,
        task_names=None,
        detection_batch_size: Optional[int] = None,
        recognition_batch_size: Optional[int] = None,
        group_pages: Optional[int] = None,
        math_mode: bool = True,
        sort_lines: bool = False,
        return_words: bool = False,
        drop_repeated_text: bool = False,
    ):
        """Serve a page stream: yields (index, OCRResult) in input order, each
        as soon as its page's lines are decoded and equal to what ``__call__``
        gives that page. `images` may be any iterable, an unbounded generator
        too: detection of later groups (of `group_pages`, default 4) and
        recognition of earlier ones overlap in one live run, and a page's
        host memory is released once its result is yielded. `task_names` may
        be an iterable beside `images` (default ocr_with_boxes).

        If the run fails mid-stream (detection, the device), every page that
        completed before the failure is yielded in order, then the error is
        raised. Closing the generator stops the feeder at the next wave
        boundary; dispatched prompts finish and are discarded. With a slow
        consumer at most RECOGNITION_STREAM_BUFFER_PAGES finished pages
        (default 4 x the group) are held: past that the feeder takes no new
        pages until the consumer catches up (surya_tpu's stream())."""
        G = group_pages or 4  # time to the first result grows with the group
        max_buffer = settings.RECOGNITION_STREAM_BUFFER_PAGES or 4 * G
        self.last_decoded_tokens = 0
        img_iter = iter(images)
        task_iter = iter(task_names) if task_names is not None else None

        def next_group():
            pages, tasks = [], []
            for img in img_iter:
                pages.append(img)
                tasks.append(next(task_iter) if task_iter else TaskNames.ocr_with_boxes)
                if len(pages) >= G:
                    break
            return pages, tasks

        def task_bound(tasks):
            """The cache's prompt area for the whole stream: the largest prompt
            each task allows (every registered task when the caller names
            tasks, since a later group may bring any), so that later prompts
            fit the live cache."""
            bound = 0
            for t in set(self.tasks if task_iter is not None else tasks):
                w, h = self.tasks[t]["img_size"]
                bound = max(bound, self.processor.prompt_len_bound((h, w, 3), (w, h), t, None, math_mode))
            return bound

        def detect_group(pages, tasks):
            pages = convert_if_not_rgb(pages)
            return self.detect_and_slice_bboxes(pages, tasks, det_predictor,
                                                detection_batch_size=detection_batch_size), pages

        events: queue_mod.Queue = queue_mod.Queue()
        # shared by the consumer (this generator) and the loop thread's feeder
        counts = {"pushed": 0, "consumed": 0}  # pages handed to the scheduler / yielded
        closed = threading.Event()  # the consumer abandoned the generator
        drained = threading.Event()  # the consumer made progress

        def push_pages(flat, pages):
            """Split a group's flat dict into per-page records; they reach the
            consumer before any of their prompts can complete."""
            recs, start = [], 0
            for i, img in enumerate(pages):
                n = flat["slice_map"][i]
                rec = {k: flat[k][start : start + n]
                       for k in ("slices", "polygons", "task_names", "input_text", "res_scales")}
                rec.update(image=img, n=n)
                recs.append(rec)
                start += n
            counts["pushed"] += len(recs)
            events.put(("pages", recs))

        first_pages, first_tasks = next_group()
        if not first_pages:
            return
        bound = task_bound(first_tasks)
        first_flat, first_pages = detect_group(first_pages, first_tasks)
        push_pages(first_flat, first_pages)

        leftovers: List[RecognitionPrompt] = []
        det_worker = ThreadPoolExecutor(max_workers=1)
        nxt_pages, nxt_tasks = next_group()
        state = {"fut": det_worker.submit(detect_group, nxt_pages, nxt_tasks) if nxt_pages else None}

        def feeder(block):
            if closed.is_set():
                return FEED_DONE  # abandoned: stop pulling the input at this wave boundary
            fut = state["fut"]
            if fut is None:
                return FEED_DONE
            if counts["pushed"] - counts["consumed"] >= max_buffer:
                # backpressure. A blocking call means the scheduler is idle
                # (every dispatched prompt finished), so waiting for the
                # consumer cannot deadlock; never wait while leftovers exist:
                # their pages complete only after this loop ends
                if not block:
                    return None
                while (counts["pushed"] - counts["consumed"] >= max_buffer
                       and not closed.is_set() and not leftovers):
                    drained.wait(0.1)
                    drained.clear()
                if closed.is_set():
                    return FEED_DONE
            if not block and not fut.done():
                return None
            flat, pages = fut.result()
            p2, t2 = next_group()
            state["fut"] = det_worker.submit(detect_group, p2, t2) if p2 else None
            push_pages(flat, pages)
            return flat

        def on_done(pid, tokens, pscores, bbox2d):
            events.put(("done", pid, list(tokens), list(pscores), bbox2d))

        def run_loop():
            try:
                self.prediction_loop(first_flat, recognition_batch_size=recognition_batch_size,
                                     math_mode=math_mode, feeder=feeder, leftover_sink=leftovers,
                                     on_done=on_done, prompt_bound_override=bound)
                events.put(("end", None))
            except BaseException as e:  # raised to the consumer, after the pages that completed
                events.put(("end", e))

        loop_thread = ThreadPoolExecutor(max_workers=1)
        loop_fut = loop_thread.submit(run_loop)

        # -- the consumer: assemble and yield pages in order as they complete
        page_recs: List[Optional[dict]] = []
        n_pids = 0
        outputs: dict = {}  # pid -> (tokens, scores, bbox2d)
        next_yield = 0
        ended = False
        error: Optional[BaseException] = None

        def page_ready(p):
            rec = page_recs[p]
            return rec is not None and all(pid in outputs for pid in rec["pids"])

        def assemble(p):
            rec = page_recs[p]
            flat_page = {k: rec[k] for k in ("slices", "polygons", "task_names", "input_text", "res_scales")}
            flat_page["slice_map"] = [rec["n"]]
            got = [outputs.pop(pid) for pid in rec["pids"]]
            bbox_arr = np.zeros((rec["n"], max([b.shape[0] for _, _, b in got] + [1]), 6), np.float32)
            for i, (_, _, b) in enumerate(got):
                bbox_arr[i, : b.shape[0]] = b
            [result] = self._assemble_results(
                [rec["image"]], flat_page, [t for t, _, _ in got], [s for _, s, _ in got], bbox_arr,
                sort_lines=sort_lines, return_words=return_words, drop_repeated_text=drop_repeated_text,
            )
            page_recs[p] = None  # release the page's memory
            return result

        try:
            while True:
                while not ended:
                    try:
                        ev = events.get(timeout=0.05)
                    except queue_mod.Empty:
                        if next_yield < len(page_recs) and page_ready(next_yield):
                            break
                        continue
                    if ev[0] == "pages":
                        for rec in ev[1]:
                            rec["pids"] = list(range(n_pids, n_pids + rec["n"]))
                            n_pids += rec["n"]
                            page_recs.append(rec)
                    elif ev[0] == "done":
                        outputs[ev[1]] = (ev[2], ev[3], ev[4])
                    else:  # the end; an error is raised after the pages that completed
                        ended, error = True, ev[1]
                        if error is None and leftovers:
                            # a later task's prompts outgrew the cache bound: a
                            # follow-up run, spliced back by id
                            lt_toks, lt_bbox, lt_scores = self.prediction_loop(
                                {"slices": [p.image for p in leftovers], "input_text": [p.text for p in leftovers],
                                 "task_names": [p.task_name for p in leftovers]},
                                recognition_batch_size=recognition_batch_size, math_mode=math_mode,
                            )
                            for j, p in enumerate(leftovers):
                                outputs[p.id] = (lt_toks[j], lt_scores[j], lt_bbox[j])
                    if next_yield < len(page_recs) and page_ready(next_yield):
                        break
                if next_yield >= len(page_recs) or not page_ready(next_yield):
                    if not ended:
                        continue
                    if error is not None:
                        raise error
                    if next_yield >= len(page_recs):
                        return
                    raise RuntimeError(f"stream ended with page {next_yield} incomplete")
                yield next_yield, assemble(next_yield)
                next_yield += 1
                counts["consumed"] += 1
                drained.set()
        finally:
            closed.set()
            drained.set()
            loop_thread.shutdown(wait=True)
            det_worker.shutdown(wait=True)

    def _recognize_flat(self, images, flat, recognition_batch_size=None, math_mode=True,
                        sort_lines=False, return_words=False, drop_repeated_text=False) -> List[OCRResult]:
        """Recognize an already sliced batch and assemble one OCRResult per
        page (empty where a page has no line)."""
        if not flat["slices"]:
            return _empty_results(images)
        predicted_tokens, bbox_arr, scores = self.prediction_loop(
            flat, recognition_batch_size=recognition_batch_size, math_mode=math_mode
        )
        return self._assemble_results(images, flat, predicted_tokens, scores, bbox_arr, sort_lines=sort_lines,
                                      return_words=return_words, drop_repeated_text=drop_repeated_text)

    def _assemble_results(self, images, flat, predicted_tokens, scores, bbox_arr, *,
                          sort_lines=False, return_words=False, drop_repeated_text=False) -> List[OCRResult]:
        """Detokenize and assemble one OCRResult per page. All flat lists,
        predicted_tokens, scores and bbox_arr rows are in flat's order."""
        if not flat["slices"]:
            return _empty_results(images)
        bbox_size = self.config.bbox_size
        image_sizes = [img.shape for img in flat["slices"]]
        predicted_polygons = prediction_to_polygon_batch(bbox_arr, image_sizes, bbox_size, bbox_size // 2)
        char_predictions = self.get_bboxes_text(
            flat, predicted_tokens, scores, predicted_polygons, drop_repeated_text=drop_repeated_text
        )

        results = []
        slice_start = 0
        for idx, image in enumerate(images):
            slice_end = slice_start + flat["slice_map"][idx]
            image_lines = char_predictions[slice_start:slice_end]
            polys = flat["polygons"][slice_start:slice_end]
            res_scales = flat["res_scales"][slice_start:slice_end]
            slice_start = slice_end

            lines = []
            for text_line, polygon, res_scale in zip(image_lines, polys, res_scales):
                if not text_line:
                    lines.append(TextLine(text="", polygon=polygon, chars=[], confidence=1, original_text_good=True))
                    continue
                confidence = float(np.mean([c.confidence for c in text_line]))
                poly_box = PolygonBox(polygon=polygon)
                for char in text_line:
                    char.rescale(res_scale, (1, 1))
                    char.shift(poly_box.bbox[0], poly_box.bbox[1])
                    char.clamp(poly_box.bbox)
                text_line = fix_unbalanced_tags(text_line, self.processor.tokenizer.special_tokens)
                text = clean_math_tags(unwrap_math("".join(c.text for c in text_line)))
                lines.append(
                    TextLine(
                        text=text,
                        polygon=polygon,
                        chars=text_line,
                        confidence=confidence,
                        words=words_from_chars(text_line, poly_box) if return_words else [],
                    )
                )
            if sort_lines:
                lines = sort_text_lines(lines)
            results.append(OCRResult(text_lines=lines, image_bbox=[0, 0, image.size[0], image.size[1]]))
        return results
