"""Text recognition predictor of the PyTorch port, with continuous batching.

Counterpart of surya_tpu/recognition/__init__.py for the ``bboxes=`` /
``polygons=`` path. The scheduler keeps everything that decides outputs:
the width-sorted queue, cache slots plus a trash slot, prefill waves under
slot and patch budgets with ``min_prefill_ratio``, prefill row buckets and
sequence buckets, a cache sized to the workload, per-chunk stop scans on the
host with kill masks sent down with the next dispatch, the device-side
repeat stop and pinned decode. It runs synchronously: one prefill or decode
chunk at a time, each ending in one device-to-host copy of its packed
outputs.
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import cv2
import numpy as np
import torch
from tqdm import tqdm

from surya_tpu.common.polygon import PolygonBox
from surya_tpu.input.processing import convert_if_not_rgb, slice_bboxes_from_image, slice_polys_from_image
from surya_tpu_torch.common.predictor import BasePredictor
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


class RecognitionPredictor(BasePredictor):
    batch_size = settings.RECOGNITION_BATCH_SIZE
    default_batch_sizes = {"cpu": 8, "cuda": 128}
    min_prefill_ratio: float = 0.2
    tasks = {
        TaskNames.ocr_with_boxes: {"img_size": (1024, 256), "max_tokens": 224},
        TaskNames.ocr_without_boxes: {"img_size": (1024, 256), "max_tokens": 224},
        TaskNames.block_without_boxes: {"img_size": (1024, 512), "max_tokens": 768},
    }

    def __init__(self, tiny: bool = False, device=None, jax_params: Optional[dict] = None):
        """tiny: the small test configuration; jax_params: the JAX foundation
        pytree as numpy leaves, whose weights the model takes (random weights
        from WEIGHT_SEED otherwise)."""
        self._tiny = tiny
        self._jax_params = jax_params
        super().__init__(device)

    def _load(self):
        self.model, self.config, self.processor = load_recognition_model(
            self._tiny, self.device, self._jax_params
        )
        self._jax_params = None
        self.last_decoded_tokens = 0  # tokens decoded by the last __call__
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

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

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
        last_token, active, run = state
        last_token, active = self._apply_kill(last_token, active, self._tensor(kill))
        layout = batch.layout
        slot_idx_t = self._tensor(slot_idx)
        tok, score, bbox = self.model.prefill(
            cache,
            self.processor.normalize_patch_rows(self._tensor(batch.patches), self.dtype),
            tuple(self._tensor(a) for a in layout.device_args),
            self._tensor(layout.llm_h_idx), self._tensor(layout.llm_w_idx),
            self._tensor(batch.input_ids), self._tensor(batch.img_gather),
            self._tensor(batch.seq_lens), slot_idx_t,
            kv_range=layout.kv_range, win_range=layout.win_range,
        )
        state = self._seed_slots(last_token, active, run, tok, slot_idx_t, self._tensor(row_valid), pin)
        return _pack(tok, score, bbox).cpu().numpy(), state

    def _decode(self, cache, state, kill, pin: bool):
        last_token, active, run = state
        last_token, active = self._apply_kill(last_token, active, self._tensor(kill))
        toks, scores, bboxes, last_token, active, run = self.model.decode_chunk(
            cache, last_token, active, self.decode_chunk, run=run,
            repeat_window=0 if pin else REPEAT_WINDOW, pin_decode=pin,
        )
        return _pack(toks, scores, bboxes).cpu().numpy(), (last_token, active, run)

    # -- slicing (host) --------------------------------------------------------

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
    def prediction_loop(self, flat: dict, recognition_batch_size=None, math_mode=True):
        """Continuous-batching scheduler over the prompts of `flat`. Returns
        (tokens per prompt, bbox array [n, T, 6], scores per prompt), in
        flat's order."""
        predicted_tokens: List[List[int]] = []
        scores: List[List[float]] = []
        bboxes: List[List[np.ndarray]] = []

        B = recognition_batch_size or self.get_batch_size()
        cfg = self.config
        eos, pad, nop = cfg.eos_token_id, cfg.pad_token_id, self.processor.no_output_token
        # pinned mode: only the per-prompt token budget stops a prompt
        pin = bool(settings.RECOGNITION_PIN_DECODE)

        max_tokens = {}
        group = list(zip(flat["slices"], flat["input_text"], flat["task_names"]))
        for i, (_, _, task) in enumerate(group):
            predicted_tokens.append([])
            scores.append([])
            bboxes.append([])
            max_tokens[i] = settings.RECOGNITION_MAX_TOKENS or self.tasks[task]["max_tokens"]
        queue = deque(
            RecognitionPrompt(id=j, task_name=group[j][2], image=group[j][0], text=group[j][1], math_mode=math_mode)
            for j in sorted(range(len(group)), key=lambda j: -group[j][0].shape[1])
        )

        n_slots = min(B, self.n_slots)
        # size the cache to the longest prompt bucket + generation budget of
        # this workload: decode attention reads every valid row each step
        max_prompt = 0
        for p in queue:
            max_prompt = max(max_prompt, self.processor.prompt_len_bound(
                p.image.shape, self.tasks[p.task_name]["img_size"], p.task_name, p.text, p.math_mode
            ))
        prompt_bucket = next((b for b in self.seq_buckets if b >= max_prompt), self.seq_buckets[-1])
        cache_len = min(
            cfg.max_sequence_length,
            -(-(prompt_bucket + max(max_tokens.values(), default=0)) // 256) * 256,
        )
        cache = qwen_decoder.init_cache(cfg.decoder, n_slots + 1, cache_len, self.dtype, self.device)
        slot_prompt: List[Optional[int]] = [None] * n_slots
        # device state per slot (last token, active, repeat run), and the kill
        # mask that carries stops only the host sees down with the next dispatch
        state = (
            torch.full((n_slots + 1,), pad, dtype=torch.int32, device=self.device),
            torch.zeros((n_slots + 1,), dtype=torch.bool, device=self.device),
            torch.zeros((n_slots + 1,), dtype=torch.int32, device=self.device),
        )
        pending_kill = np.zeros(n_slots + 1, bool)
        pbar = tqdm(total=len(predicted_tokens), desc="Recognizing Text", disable=self.disable_tqdm)

        def take_kill():
            kill = pending_kill.copy()
            pending_kill[:] = False
            return kill

        def finish(slot, device_knows: bool):
            """Free a slot. device_knows: the device stopped it itself (EOS or
            pad); otherwise the kill mask tells it with the next dispatch."""
            slot_prompt[slot] = None
            if not device_knows:
                pending_kill[slot] = True
            pbar.update(1)

        def process_decode(packed):
            toks = packed[..., 0].astype(np.int32)
            chunk_scores = packed[..., 1]
            chunk_bboxes = packed[..., 2:]
            act = [s for s in range(n_slots) if slot_prompt[s] is not None]
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
                    finish(s, device_knows=(not pin) and int(ctoks[i, int(cut[i])]) in (eos, pad))

        def build_wave(slot_budget: int):
            """Pop prompts from the queue under the slot and patch budgets and
            pack their prefill batch."""
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
            batch_rows = next(b for b in self.prefill_row_buckets if b >= len(round_prompts))
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
            """Host bookkeeping for prefill token 0; prompt i sits at row i."""
            for row, (slot, prompt) in enumerate(zip(target_slots, round_prompts)):
                t = int(packed[row, 0])
                predicted_tokens[prompt.id].append(t)
                scores[prompt.id].append(0.0 if t in (eos, pad) else float(packed[row, 1]))
                bboxes[prompt.id].append(packed[row : row + 1, 2:])
                if not pin and t in (eos, nop):
                    finish(slot, device_knows=True)

        while queue or any(p is not None for p in slot_prompt):
            frees = [i for i, p in enumerate(slot_prompt) if p is None]
            if queue and len(frees) / n_slots > self.min_prefill_ratio:
                round_prompts, batch, batch_rows = build_wave(min(len(frees), self.prefill_row_buckets[-1]))
                target_slots = frees[: len(round_prompts)]
                slot_idx = np.full(batch_rows, n_slots, np.int32)  # padding rows -> trash slot
                slot_idx[: len(round_prompts)] = target_slots
                row_valid = np.arange(batch_rows) < len(round_prompts)
                packed, state = self._prefill(cache, batch, slot_idx, row_valid, state, take_kill(), pin)
                for slot, prompt in zip(target_slots, round_prompts):
                    slot_prompt[slot] = prompt.id
                seed_from_prefill(packed, target_slots, round_prompts)
            else:
                # every occupied slot is still decoding: finish() frees a
                # slot the moment its prompt stops
                packed, state = self._decode(cache, state, take_kill(), pin)
                process_decode(packed)
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
        recognition_batch_size: Optional[int] = None,
        bboxes=None,
        polygons=None,
        input_text=None,
        sort_lines: bool = False,
        math_mode: bool = True,
        return_words: bool = False,
        drop_repeated_text: bool = False,
    ) -> List[OCRResult]:
        """Recognize the text in the given line boxes (``bboxes``: per image a
        list of [x0, y0, x1, y1]) or polygons of PIL images. Detection is not
        part of the port yet."""
        if task_names is None:
            task_names = [TaskNames.ocr_with_boxes] * len(images)
        if len(images) != len(task_names) or any(t not in self.tasks for t in task_names):
            raise ValueError(f"need one known task per image, got {task_names}")
        if bboxes is None and polygons is None:
            raise ValueError("the PyTorch port recognizes given lines only: pass bboxes= or polygons=")
        self.last_decoded_tokens = 0
        images = convert_if_not_rgb(images)
        flat = self.slice_bboxes(images, task_names, bboxes=bboxes, polygons=polygons, input_text=input_text)
        if not flat["slices"]:
            return [OCRResult(text_lines=[], image_bbox=[0, 0, img.size[0], img.size[1]]) for img in images]
        predicted_tokens, bbox_arr, scores = self.prediction_loop(
            flat, recognition_batch_size=recognition_batch_size, math_mode=math_mode
        )
        return self._assemble_results(
            images, flat, predicted_tokens, scores, bbox_arr,
            sort_lines=sort_lines, return_words=return_words, drop_repeated_text=drop_repeated_text,
        )

    def _assemble_results(self, images, flat, predicted_tokens, scores, bbox_arr, *,
                          sort_lines=False, return_words=False, drop_repeated_text=False) -> List[OCRResult]:
        """Detokenize and assemble one OCRResult per page. All flat lists,
        predicted_tokens, scores and bbox_arr rows are in flat's order."""
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
