"""Recognition input processor: image scaling and tiling, prompt assembly.

Counterpart of surya_tpu/recognition/processor.py. ``build_prefill_batch``
assembles one static-shape bundle per prefill wave (numpy): the padded uint8
patch array, the encoder layout plan, the right-padded token matrix and the
<IMAGE> scatter map; a wave whose patch rows all have R == G == B ships one
channel third of them (``_gray_ship``). ``normalize_patch_rows`` tiles such
a third back to [R|G|B] and rescales and normalizes the uint8 patches on the
device, in torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch
from PIL import Image

from surya_tpu_torch.models import qwen_encoder
from surya_tpu_torch.recognition.tokenizer import (
    BLOCK_WITHOUT_BOXES_TOKEN,
    EOI_TOKEN,
    EOS_TOKEN,
    IMAGE_ROTATED_TOKEN,
    IMAGE_TOKEN,
    NOMATH_TOKEN,
    NO_OUTPUT_TOKEN,
    OCR_WITHOUT_BOXES_BOS_TOKEN,
    OCR_WITH_BOXES_BOS_TOKEN,
    PAD_TOKEN,
    REGISTER_TOKENS,
    OCRTokenizer,
    TaskNames,
)
from surya_tpu_torch.settings import settings

# minimum crop edge after scale_to_fit; prompt_len_bound and the blank that
# stands in for a degenerate crop must agree with it
MIN_IMAGE_SIZE = 168

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclass
class PrefillBatch:
    """Static-shape inputs for one prefill wave (numpy)."""

    patches: np.ndarray  # [cap, patch_dim] uint8, or [cap, patch_dim / 3] gray (normalized on the device)
    layout: qwen_encoder.EncoderLayout
    input_ids: np.ndarray  # [rows, L] int32, right-padded
    img_gather: np.ndarray  # [rows, L] int32 image-token row, -1 = text position
    seq_lens: np.ndarray  # [rows] int32
    n_prompts: int  # real rows; the rest are padding
    # prompt i's row: i, or with n_shards > 1 a row of its data shard's block
    valid_rows: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.valid_rows is None:
            self.valid_rows = np.arange(self.n_prompts, dtype=np.int32)


class RecognitionProcessor:
    def __init__(self, tokenizer: OCRTokenizer, patch_size: int = 14, merge_size: int = 2,
                 num_register_tokens: int = 4):
        self.tokenizer = tokenizer
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.num_register_tokens = num_register_tokens
        st = tokenizer.system_tokens
        self.image_token_id = st[IMAGE_TOKEN]
        self.pad_token_id = st[PAD_TOKEN]
        self.eos_token_id = st[EOS_TOKEN]
        self.eoi_token_id = st[EOI_TOKEN]
        self.no_output_token = st[NO_OUTPUT_TOKEN]
        self.image_rotated_token = st[IMAGE_ROTATED_TOKEN]
        self.nomath_token = st[NOMATH_TOKEN]
        self.register_token_ids = [st[r] for r in REGISTER_TOKENS][:num_register_tokens]
        self.bos_token_id = {
            TaskNames.ocr_with_boxes: st[OCR_WITH_BOXES_BOS_TOKEN],
            TaskNames.ocr_without_boxes: st[OCR_WITHOUT_BOXES_BOS_TOKEN],
            TaskNames.block_without_boxes: st[BLOCK_WITHOUT_BOXES_TOKEN],
        }
        # special ids that never carry boxes (every special but the math tags),
        # and the math tags that open and close a math span
        math_ext = set(tokenizer.special_tokens["math_external"])
        mapping = tokenizer.SPECIAL_TOKEN_MAPPING
        self.ignore_bbox_token_ids = [v for k, v in mapping.items() if k not in math_ext]
        self.math_start_token_ids = [v for k, v in mapping.items() if k in math_ext and k != "</math>"]
        self.math_end_token_ids = [v for k, v in mapping.items() if k == "</math>"]
        # host-packing caches: the layout plan depends only on (grids, cap),
        # the prompt ids only on (task, n_tok, text, math, rotated); entries
        # are immutable
        self._plan_cache: dict = {}
        self._prompt_cache: dict = {}

    def _cached_prompt_ids(self, task: str, n_tok: int, text: str, math_mode: bool,
                           rotated: bool = False) -> List[int]:
        key = (task, n_tok, text, bool(math_mode), bool(rotated))
        ids = self._prompt_cache.get(key)
        if ids is None:
            if len(self._prompt_cache) >= 4096:
                self._prompt_cache.clear()
            ids = self._prompt_cache[key] = self.build_prompt_ids(task, n_tok, text, math_mode, rotated)
        return ids

    def _cached_plan(self, key, thunk):
        plan = self._plan_cache.get(key)
        if plan is None:
            if len(self._plan_cache) >= 256:
                self._plan_cache.clear()
            plan = self._plan_cache[key] = thunk()
        return plan

    # -- images ----------------------------------------------------------------

    @property
    def factor(self) -> int:
        return self.patch_size * self.merge_size

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size**2

    def image_processor(self, image: Image.Image) -> np.ndarray:
        """The page as a uint8 array: every later step (resize, tiling) works
        on uint8."""
        return np.asarray(image)

    @staticmethod
    def scale_to_fit(img: np.ndarray, max_size: Tuple[int, int],
                     min_size: Tuple[int, int] = (MIN_IMAGE_SIZE, MIN_IMAGE_SIZE)) -> np.ndarray:
        """Area-preserving rescale into the [min, max] pixel budget (LANCZOS4,
        floor on shrink, ceil on grow)."""
        height, width = img.shape[:2]
        if width == 0 or height == 0:
            return img
        current = width * height
        max_px = max_size[0] * max_size[1]
        min_px = min_size[0] * min_size[1]
        if current > max_px:
            s = (max_px / current) ** 0.5
            new_w, new_h = math.floor(width * s), math.floor(height * s)
        elif current < min_px:
            s = (min_px / current) ** 0.5
            new_w, new_h = math.ceil(width * s), math.ceil(height * s)
        else:
            return img
        return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LANCZOS4)

    def align_long_axis(self, image: np.ndarray) -> Tuple[np.ndarray, bool]:
        """(image turned 90 degrees counter-clockwise, True) for a tall image,
        else (image, False)."""
        h, w = image.shape[:2]
        if h > w:
            return cv2.rotate(image, cv2.ROTATE_90_COUNTERCLOCKWISE), True
        return image, False

    def tile_image(self, image: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Resize to a multiple of patch * merge (INTER_CUBIC, skipped when
        the sides already are) and flatten into per-patch uint8 rows in token
        order (cell_r, cell_c, dr, dc), each row channel-major (C, p, p).
        Returns (patches [n, 3*p*p], grid (h, w) in patch units)."""
        f = self.factor
        height, width = image.shape[:2]
        h_bar = max(f, math.ceil(height / f) * f)
        w_bar = max(f, math.ceil(width / f) * f)
        if (h_bar, w_bar) != (height, width):
            image = cv2.resize(image, (w_bar, h_bar), interpolation=cv2.INTER_CUBIC)
        if image.dtype != np.uint8:
            image = np.clip(np.round(image), 0, 255).astype(np.uint8)
        grid_h, grid_w = h_bar // self.patch_size, w_bar // self.patch_size
        m, p = self.merge_size, self.patch_size
        x = image.reshape(grid_h // m, m, p, grid_w // m, m, p, 3)
        x = x.transpose(0, 3, 1, 4, 6, 2, 5)  # cell_r, cell_c, dr, dc, C, p, p
        return np.ascontiguousarray(x.reshape(grid_h * grid_w, 3 * p * p)), (grid_h, grid_w)

    def normalize_patch_rows(self, patches: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """uint8 patch rows (channel-major (C, p, p)) -> ImageNet-normalized
        rows in `dtype`, on the patches' device. Rows of one channel third
        (``_gray_ship``) are tiled back to [R|G|B] first, bit for bit the
        three-channel rows. The constants are made on the device (no copy
        from the host, which would wait for it)."""
        p2 = self.patch_size**2
        if patches.shape[-1] == p2:
            patches = torch.cat([patches, patches, patches], dim=-1)
        dev = patches.device
        mean = torch.cat([torch.full((p2,), m, dtype=torch.float32, device=dev) for m in IMAGE_MEAN])
        std = torch.cat([torch.full((p2,), s, dtype=torch.float32, device=dev) for s in IMAGE_STD])
        return ((patches.float() / 255.0 - mean) / std).to(dtype)

    def _gray_ship(self, patch_buf: np.ndarray) -> np.ndarray:
        """The first channel third of the patch rows when every row has
        R == G == B (most OCR content), else the rows: a third of the bytes
        to the device. RECOGNITION_GRAYSCALE_SHIP=False always ships three."""
        if settings.RECOGNITION_GRAYSCALE_SHIP is False:
            return patch_buf
        p2 = self.patch_size**2
        a = patch_buf[..., :p2]
        if np.array_equal(a, patch_buf[..., p2 : 2 * p2]) and np.array_equal(a, patch_buf[..., 2 * p2 :]):
            return np.ascontiguousarray(a)
        return patch_buf

    def window_slots_needed(self, grid: Tuple[int, int]) -> int:
        """Layout slots an image occupies: its patch count (packed layout)."""
        return grid[0] * grid[1]

    def prompt_len_bound(self, image_shape, max_size: Tuple[int, int], task: str,
                         text: Optional[str], math_mode: bool = True) -> int:
        """Upper bound (exact + small slack) on the built prompt length for a
        raw crop of this shape, mirroring scale_to_fit + tile_image."""
        h, w = int(image_shape[0]), int(image_shape[1])
        if h <= 0 or w <= 0:
            h = w = self.factor
        cur = w * h
        max_px = max_size[0] * max_size[1]
        min_px = MIN_IMAGE_SIZE * MIN_IMAGE_SIZE
        if cur > max_px:
            s = (max_px / cur) ** 0.5
            w, h = math.floor(w * s), math.floor(h * s)
        elif cur < min_px:
            s = (min_px / cur) ** 0.5
            w, h = math.ceil(w * s), math.ceil(h * s)
        f = self.factor
        llm = max(1, math.ceil(h / f)) * max(1, math.ceil(w / f))
        llm = max(llm, math.ceil(MIN_IMAGE_SIZE / f) ** 2)  # the degenerate-crop blank
        n_text = len(self.tokenizer.encode(text, task=task)) if text else 0
        # registers + BOS + EOI + slack for <ROT>/<NO-MATH> prefixes
        return llm + len(self.register_token_ids) + 2 + n_text + 2

    # -- prompts ---------------------------------------------------------------

    def build_prompt_ids(self, task: str, n_image_tokens: int, text: str, math_mode: bool,
                         rotated: bool = False) -> List[int]:
        """[<ROT>] + <IMAGE>*n + registers + task BOS [+ <NO-MATH>] + input
        text + EOI."""
        ids = [self.image_token_id] * n_image_tokens + self.register_token_ids
        if rotated:
            ids = [self.image_rotated_token] + ids
        text_ids = self.tokenizer.encode(text, task=task) if text else []
        if not math_mode:
            text_ids = [self.nomath_token] + text_ids
        return ids + [self.bos_token_id[task]] + text_ids + [self.eoi_token_id]

    def build_prefill_batch(
        self,
        images: Sequence[np.ndarray],  # already scale_to_fit'ed uint8 crops
        tasks: Sequence[str],
        texts: Sequence[Optional[str]],
        math_modes: Sequence[bool],
        encoder_config,
        batch_rows: int,
        seq_buckets: Sequence[int],
        patch_caps: Sequence[int],
        n_shards: int = 1,
    ) -> PrefillBatch:
        """Tile every image, plan the encoder layout at the smallest capacity
        bucket that fits, and build the right-padded token matrix and the
        image-token scatter map. Prompt i sits at row i.

        n_shards > 1 (the data-sharded encoder of a mesh): the prompts go to
        n_shards groups of at most batch_rows / n_shards rows, balanced on
        patch need (LPT: largest first, each to the least-loaded group with
        a row free); each group has a packed plan of its own at one shared
        capacity bucket (plan_layout_sharded: every array gains a leading
        [n_shards] axis), its prompts take the rows of its block in order,
        and their <IMAGE> gathers index the group's own image tokens.
        valid_rows gives each prompt's row."""
        all_patches, grids, prompts = [], [], []
        for img, task, text, math_mode in zip(images, tasks, texts, math_modes):
            patches, grid = self.tile_image(img)
            all_patches.append(patches)
            grids.append(grid)
            n_tok = grid[0] * grid[1] // self.merge_size**2
            prompts.append(self._cached_prompt_ids(task, n_tok, text or "", math_mode))

        max_len = max((len(p) for p in prompts), default=1)
        L = next((b for b in seq_buckets if b >= max_len), None)
        if L is None:
            raise ValueError(f"prompt length {max_len} exceeds largest bucket {seq_buckets[-1]}")
        if n_shards > 1:
            return self._sharded_batch(all_patches, grids, prompts, encoder_config, batch_rows, L, patch_caps,
                                       n_shards)
        needed = sum(self.window_slots_needed(g) for g in grids)
        patch_cap = next((c for c in patch_caps if c >= needed), None)
        if patch_cap is None:
            raise ValueError(f"prefill needs {needed} window slots > largest cap {patch_caps[-1]}")

        patch_buf = np.zeros((patch_cap, self.patch_dim), np.uint8)
        if all_patches:
            cat = np.concatenate(all_patches, axis=0)
            patch_buf[: cat.shape[0]] = cat
        patch_buf = self._gray_ship(patch_buf)
        layout = self._cached_plan(
            (tuple(map(tuple, grids)), patch_cap, encoder_config),
            lambda: qwen_encoder.plan_layout(grids, encoder_config, patch_cap),
        )

        input_ids = np.full((batch_rows, L), self.pad_token_id, np.int32)
        img_gather = np.full((batch_rows, L), -1, np.int32)
        seq_lens = np.ones((batch_rows,), np.int32)
        llm_base = 0
        for i, (ids, grid) in enumerate(zip(prompts, grids)):
            row = np.asarray(ids, np.int32)
            input_ids[i, : len(ids)] = row
            n_tok = grid[0] * grid[1] // self.merge_size**2
            # <IMAGE> tokens are a contiguous run at the prompt head
            first = int(np.argmax(row == self.image_token_id))
            img_gather[i, first : first + n_tok] = np.arange(llm_base, llm_base + n_tok, dtype=np.int32)
            llm_base += n_tok
            seq_lens[i] = len(ids)

        return PrefillBatch(
            patches=patch_buf, layout=layout, input_ids=input_ids, img_gather=img_gather,
            seq_lens=seq_lens, n_prompts=len(prompts),
        )

    def _sharded_batch(self, all_patches, grids, prompts, encoder_config, batch_rows: int, L: int,
                       patch_caps: Sequence[int], n_shards: int) -> PrefillBatch:
        """build_prefill_batch's n_shards > 1 branch (surya_tpu's, line for line)."""
        rows_s = batch_rows // n_shards
        if rows_s * n_shards != batch_rows:
            raise ValueError(f"batch_rows {batch_rows} not divisible by {n_shards} shards")
        if len(prompts) > batch_rows:
            raise ValueError(f"{len(prompts)} prompts > {batch_rows} rows")
        needs = [self.window_slots_needed(g) for g in grids]
        groups: List[List[int]] = [[] for _ in range(n_shards)]
        loads = [0] * n_shards
        for i in sorted(range(len(grids)), key=lambda i: -needs[i]):
            g = min((g for g in range(n_shards) if len(groups[g]) < rows_s), key=lambda g: loads[g])
            groups[g].append(i)
            loads[g] += needs[i]
        cap = next((c for c in patch_caps if c >= max(loads, default=1)), None)
        if cap is None:
            raise ValueError(f"shard needs {max(loads)} window slots > largest cap {patch_caps[-1]}")

        patch_buf = np.zeros((n_shards, cap, self.patch_dim), np.uint8)
        for g, idxs in enumerate(groups):
            if idxs:
                cat = np.concatenate([all_patches[i] for i in idxs], axis=0)
                patch_buf[g, : cat.shape[0]] = cat
        shard_grids = [[grids[i] for i in idxs] for idxs in groups]
        layout = self._cached_plan(
            ("shard", tuple(tuple(map(tuple, sg)) for sg in shard_grids), tuple(map(tuple, groups)), cap,
             encoder_config),
            lambda: qwen_encoder.plan_layout_sharded(shard_grids, encoder_config, cap, orig_index=groups),
        )

        input_ids = np.full((batch_rows, L), self.pad_token_id, np.int32)
        img_gather = np.full((batch_rows, L), -1, np.int32)
        seq_lens = np.ones((batch_rows,), np.int32)
        valid_rows = np.zeros(len(prompts), np.int32)
        for g, idxs in enumerate(groups):
            llm_base = 0  # the group's own token index
            for pos, i in enumerate(idxs):
                r = g * rows_s + pos
                valid_rows[i] = r
                row = np.asarray(prompts[i], np.int32)
                input_ids[r, : len(row)] = row
                n_tok = grids[i][0] * grids[i][1] // self.merge_size**2
                first = int(np.argmax(row == self.image_token_id))
                img_gather[r, first : first + n_tok] = np.arange(llm_base, llm_base + n_tok, dtype=np.int32)
                llm_base += n_tok
                seq_lens[r] = len(row)
        return PrefillBatch(
            patches=self._gray_ship(patch_buf), layout=layout, input_ids=input_ids, img_gather=img_gather,
            seq_lens=seq_lens, n_prompts=len(prompts), valid_rows=valid_rows,
        )

    def decode(self, tokens: List[int], task: str) -> str:
        """Detokenize without the system ids (pad, EOS, registers, ...) and
        -100; formatting and math tags stay and come out as their tag text."""
        system_vals = set(self.tokenizer.system_tokens.values())
        return self.tokenizer.decode([t for t in tokens if t not in system_vals and t != -100], task=task)
