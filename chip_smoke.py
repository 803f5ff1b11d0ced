"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``surya_tpu_torch/csrc`` (one nvcc
per source, in parallel), checks each against its plain PyTorch version at
the shapes the given-lines path gives it and times it beside its bound and,
where one PyTorch call computes the same function, that call. Then:

- drives ``RecognitionPredictor`` at the production widths with random bf16
  weights over 4 synthetic pages of 8 given line boxes each (pinned to 40
  tokens per line, then with free-running stops), and shows through the
  kernels' launch counts that the path ran on K1, K2 and K3;
- runs one prefill and one decode step through the kernels and through the
  plain versions, with a bf16 and with an int8 KV cache, and compares them;
- drives whole-page OCR at production width, ``RecognitionPredictor(pages,
  det_predictor=DetectionPredictor())`` with the int8 KV cache, over 8
  synthetic 1024x1024 pages of 16 dark line bands each (the detector's blob
  hook makes random weights find them), pinned and free-running, and shows
  that it found every line and ran on K1, K2 and K3q (not K3);
- checks K1 and K2 against their plain versions at the shapes of that
  path's prefill wave (the layout plan of its 128 detected lines, its rows
  and sequence bucket), and runs that wave's prefill and one decode step
  through the int8 cache three ways, as above;
- holds K3 and K3q against their plain versions at the shape the pinned
  runs gave them (K3: given lines, K3q: whole page; the first decode call's
  lengths, cache rows S and chunk columns K, recorded by a stand-in for the
  decoder's `decode_attn` in this script), at steps 0, K/2 - 1 and K - 1;
- runs detection of 16 such pages with the device resize and the component
  stats on the card (their auto setting) and holds the boxes against the
  host path's (PIL, maps, the C++ CRAFT op) by the IoU rule of
  tests/test_device_postprocess.py, and one batch's resized pixels against
  PIL's double LANCZOS;
- drives whole-page OCR at the north star's shape (16 pages, int8 cache,
  40 pinned tokens a line) through the streaming det->rec path, the same
  with every output read after a device synchronise, and sequentially: the
  same lines and token counts, at least 95 % of the lines with the same
  token ids between the pipelined and the synchronised reads, K1, K2 and
  K3q launched;
- runs one whole-page call with the recognition dispatches under
  ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host sync), and
  ``stream()`` over a generator of the 16 pages (in order, the batch call's
  lines);
- drives ``LayoutPredictor`` at the JAX package's full width (DonutSwin
  768x768, depths (2, 2, 16, 2); ADETR 8 layers, 1024 wide) with random bf16
  weights over 16 pages of bench.py's shape (1240x1754, two tiles each), as
  called and cap-bound (no class taken for EOS or PAD, so every row decodes
  its 100 steps), printing each dispatch's AR steps and host syncs and the
  host enqueue time against the wall; and ``TableRecPredictor`` at full
  width with ``install_synthetic_tables`` (14 rows x 8 columns) over 4 crops
  of 768x768, whose rows, columns and recorded steps must be the script's.
  Neither path runs a hand-written kernel (the JAX package runs no Pallas
  kernel there), and neither launches one. Each model is also run in
  float32 on the card (TF32 off) and on the CPU with the same weights: the
  encoder outputs within relative error 1e-3;
- runs two ``RecognitionPredictor``s, each on its own stream, in two
  threads on the same given-lines pages: the token ids must equal those of
  the same two calls one after the other, and the decode kernel's merge
  counts must be a buffer per stream; and K3 on two streams in turn at a
  4096-row cache, so that calls of both run at once, each within tolerance
  of its plain version;
- drives ``RecognitionPredictor`` with int8 decoder weights
  (``RECOGNITION_WEIGHT_QUANTIZE``) over the 8 whole pages with the bf16 and
  the int8 cache, in turns with the bf16-weight predictor (the same random
  weights), and shows that it ran on K1, K2 and K3 or K3q; prints walls,
  the projections' bytes, the token agreement and a decode step's device
  time with each weight type; and holds the quantized decoder in float32 on
  the card against the CPU (greedy token ids equal);
- drives ``OCRErrorPredictor`` at full width over 256 texts, 64 in each of
  its four sequence buckets, and holds the model in float32 on the card
  against the CPU (logits within 1e-3 of the largest);
- runs the five CLIs (``surya_tpu_torch.scripts.*``: detect_text, ocr_text,
  ocr_latex, detect_layout, table_recognition) through their ``main(argv)``
  on a folder of 2 pages of bench.py's shape, with the predictors above
  wrapped in: each writes a results.json in the JAX CLIs' layout, and
  ocr_text and ocr_latex run on K1, K2 and K3; then ``python -m
  surya_tpu_torch.scripts.ocr_latex`` as a process of its own;
- writes each of the five models above as an upstream checkpoint directory
  (``write_checkpoint``: upstream's torch key names and layouts, bf16
  storage, config.json, a small Qwen2 BPE or a WordPiece vocab.txt) and
  builds its predictor from it twice, converting and then reading the
  converted-weight cache: every parameter bitwise equal to the source
  model's, the outputs equal to the source predictor's (token ids of 8
  whole pages of bench.py's shape, detection heatmaps, layout and table
  boxes, OCR error labels), and the checkpoint-loaded recognition path on
  K1, K2 and K3; each write and load timed.

The random-weight phases point the five ``*_MODEL_CHECKPOINT`` settings at
a path that does not exist, so that no predictor resolves or fetches a
default ``s3://`` checkpoint. The exporter (``upstream_state_dict``,
``write_checkpoint``) also serves tests/test_torch_checkpoint.py, which
holds its key set to what the JAX package's ``convert_torch`` reads; the
module imports without a card, and only running it needs one.

K3 and K3q are also held against their plain versions, and timed, at the
free-running path's 512-row cache: ragged lengths at three (step, layer)
pairs (the step-37 case is the long-cache row), every slot at 512 rows and at the ragged mean, the
edges of a split (lengths 0, 1, T - 1, T, T + 1, S - 1 and S at the first
and last step), the floor (every length 0 at step 0) and 300 slots of ragged
lengths. K3's library time
is one `scaled_dot_product_attention` call over the cache and chunk joined
beforehand; no PyTorch call reads an int8 cache with row scales, so K3q has
none.

K1's full-attention and windowed blocks are reported as two entries, each
with its own launches; for each plan the script prints the query-key pairs
K1 computes after skipping the key tiles outside its spans (modelled from
the kernel's span rule) against the pairs the plan needs. K1 is also held
against its plain version where no layout plan takes it: query rows outside
their window, clamped window starts, and a window that is no multiple of its
64-key tile.

Exits non-zero on any failure and when no CUDA device is present. Prints the
card's name and power limit, one JSON line with the kernels' results, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

# the five checkpoint settings; the random-weight phases point them at a path
# that does not exist, so that no predictor resolves (or fetches) a default
# s3:// checkpoint, nor the process that phase 18 starts
CHECKPOINT_SETTINGS = ("DETECTOR_MODEL_CHECKPOINT", "RECOGNITION_MODEL_CHECKPOINT", "LAYOUT_MODEL_CHECKPOINT",
                       "TABLE_REC_MODEL_CHECKPOINT", "OCR_ERROR_MODEL_CHECKPOINT")

if __name__ == "__main__":  # the settings are read when the port is first imported
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the GPU")
    os.environ.setdefault("ALLOW_RANDOM_WEIGHTS", "true")
    os.environ.setdefault("DISABLE_TQDM", "true")
    for _name in CHECKPOINT_SETTINGS:
        os.environ[_name] = os.devnull

from PIL import Image, ImageDraw  # noqa: E402

from surya_tpu_torch.detection import DetectionPredictor, resize_on_device  # noqa: E402
from surya_tpu_torch.layout import LayoutPredictor  # noqa: E402
from surya_tpu_torch.layout.slicer import ImageSlicer  # noqa: E402
from surya_tpu_torch.models import qwen_decoder  # noqa: E402
from surya_tpu_torch.models.adetr import DoneWatch  # noqa: E402
from surya_tpu_torch.models.efficientvit import install_blob_detector  # noqa: E402
from surya_tpu_torch.models.qwen_encoder import EncoderConfig, plan_layout  # noqa: E402
from surya_tpu_torch.ops import _build, decode_attn, flash  # noqa: E402
from surya_tpu_torch.recognition import RecognitionPredictor  # noqa: E402
from surya_tpu_torch.recognition.loader import DEFAULT_ENCODER  # noqa: E402
from surya_tpu_torch.models.layout_model import ID_TO_LABEL  # noqa: E402
from surya_tpu_torch.settings import settings  # noqa: E402
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables  # noqa: E402
from surya_tpu_torch.models.distilbert import DistilBert  # noqa: E402
from surya_tpu_torch.models.foundation import FoundationModel  # noqa: E402
from surya_tpu_torch import nn as pnn  # noqa: E402
from surya_tpu_torch.common.checkpoint import cache_path  # noqa: E402
from surya_tpu_torch.common.weights import fold_batchnorm  # noqa: E402
from surya_tpu_torch.nn import QuantLinear  # noqa: E402
from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer  # noqa: E402
from surya_tpu_torch.recognition.tokenizer import DEFAULT_SPECIAL_TOKENS  # noqa: E402
from surya_tpu_torch.ocr_error import OCRErrorPredictor  # noqa: E402
from surya_tpu_torch.ocr_error import random_model as ocr_error_random_model  # noqa: E402
from surya_tpu_torch.recognition.loader import random_model  # noqa: E402
from surya_tpu_torch.scripts import (  # noqa: E402
    detect_layout, detect_text, ocr_latex, ocr_text, table_recognition,
)

SEED = 0
N_PAGES, LINES_PER_PAGE, PIN_TOKENS = 4, 8, 40
# line crops: sides multiples of 28 px, area in [168^2, 1024*256], so the
# processor neither rescales nor resizes them
LINE_SHAPES = [(56, 504), (56, 700), (84, 840), (56, 980), (84, 560), (56, 616), (84, 952), (56, 812)]
# whole-page OCR: 8 pages (the JAX predictor's sequential det->rec limit),
# one detection chunk each, 16 dark bands of 24 px every 62 px
OCR_PAGES, OCR_LINES, OCR_PAGE_SIZE = 8, 16, 1024
# whole-page OCR at the north star's shape (bench.py: 16 pages, 40 pinned
# tokens a line), in two detection groups of 8 pages through the streaming path
NORTH_STAR_PAGES, PIPELINE_PAGES = 16, 8
# the share of lines whose token ids must agree between the pipelined
# streaming run and the same run reading every output after a device
# synchronise (the same waves); a stale output buffer would give garbage far
# below it. Against the sequential run, whose waves hold other lines, the
# share is printed only: with random weights the logits' near-ties are many,
# and bf16 GEMMs over other rows flip them (0.4805 of the lines agreed in my
# first run on the card)
TOKEN_AGREEMENT = 0.95
# the device resize (bf16 operands) against PIL's double LANCZOS: the share of
# pixels within one level and the mean |diff|, set from the same products
# emulated on the CPU on these pages (0.94 and 0.62) before the first card run
RESIZE_WITHIN_1, RESIZE_MEAN = 0.90, 0.75
# layout and table recognition at full width, as bench.py:468-503 times them:
# layout of 16 pages of its page shape (1240x1754, 40 text lines; two tiles
# each), table rec of 4 crops of 768x768 of them with install_synthetic_tables'
# 14-row x 8-column table of 8 cell candidates a row
LAYOUT_PAGES, TABLE_CROPS = 16, 4
TABLE_ROWS, TABLE_COLS, TABLE_CELLS = 14, 8, 8
# float32 on the card (TF32 off) against the CPU on the same weights: the
# encoder output's relative error (norm of the difference over the norm) at
# most this; the AR tokens' agreement is printed (random weights flip ties)
ENCODER_REL_ERR, F32_MAX_BOXES = 1e-3, 8
# int8 decoder weights (RECOGNITION_WEIGHT_QUANTIZE): the projections a
# decoder layer quantizes, and the decode step timed with each weight type
# (slots with the trash slot, cache rows, chunk columns, step, valid rows)
PROJECTIONS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
               "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
DECODE_STEP = (129, 256, 64, 31, 64)
# OCR error: texts a sequence bucket, and the words of a text for each (each
# word one token of the hash vocabulary, plus CLS and SEP); float32 on the
# card against the CPU: the logits' largest difference over the largest logit
OCR_ERROR_TEXTS = 64
OCR_ERROR_WORDS = {64: (10, 62), 128: (63, 126), 256: (127, 254), 512: (255, 510)}
LOGITS_REL_ERR = 1e-3
# the five CLIs on a folder of pages of bench.py's shape: CLI -> (its module,
# the predictors it builds, extra arguments, the kernels it must launch)
CLI_PAGES = 2
RECOGNITION_KERNELS = ["segmented_block_attention", "causal_flash_attention", "gqa_decode"]
CLIS = {
    "detect_text": (detect_text, ("DetectionPredictor",), ["--images"], []),
    "ocr_text": (ocr_text, ("DetectionPredictor", "RecognitionPredictor"), [], RECOGNITION_KERNELS),
    "ocr_latex": (ocr_latex, ("RecognitionPredictor",), [], RECOGNITION_KERNELS),
    "detect_layout": (detect_layout, ("LayoutPredictor",), ["--images"], []),
    "table_recognition": (table_recognition, ("LayoutPredictor", "TableRecPredictor"),
                          ["--skip_table_detection"], []),
}
# the keys of a page's row in each CLI's results.json (the JAX CLIs')
CLI_KEYS = {
    "detect_text": {"bboxes", "vertical_lines", "image_bbox", "page"},
    "ocr_text": {"text_lines", "image_bbox", "page"},
    "ocr_latex": {"equation", "page"},
    "detect_layout": {"bboxes", "image_bbox", "sliced", "page"},
    "table_recognition": {"cells", "unmerged_cells", "rows", "cols", "image_bbox", "page", "table_idx"},
}
# kernel vs plain version, elementwise: both round an fp32 result to bf16, so
# they may differ by one bf16 spacing (2^-7 relative) plus a small floor
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 1e-3
MODEL_RATIO = 2.0  # see check_model_paths: bf16 rounding compounds over 18 layers either way
# the least time of a call: bytes over HBM bandwidth or bf16 operations over
# the dense tensor-core peak (NVIDIA H100 SXM data sheet), whichever is larger
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12
# the kernels line's entries: name -> (source, the TPU kernel it replaces).
# K1's full-attention and windowed blocks are one kernel at two shapes, each
# an entry of its own.
KERNELS = {
    "segmented_block_attention[full]": ("surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:215"),
    "segmented_block_attention[window]": ("surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:215"),
    "causal_flash_attention": ("surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:64"),
    "gqa_decode": ("surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:187"),
    "gqa_decode_int8": ("surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:167"),
}
COUNTERS = {  # kernel -> (wrapper, its launch counter)
    "segmented_block_attention": (flash.segmented_block_attention, "launches"),
    "causal_flash_attention": (flash.causal_flash_attention, "launches"),
    "gqa_decode": (decode_attn.gqa_decode, "launches"),
    "gqa_decode_int8": (decode_attn.gqa_decode, "launches_q"),
}
K1_BY_RANGE = "segmented_block_attention by kv_range"
# K3's library call: the first of these SDPA backends that takes a boolean
# mask with enable_gqa (the fused ones first)
DECODE_SDPA_BACKENDS = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def reset_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    flash.segmented_block_attention.launches_by_range = {}


def read_counts() -> dict:
    counts = {n: getattr(fn, attr) for n, (fn, attr) in COUNTERS.items()}
    counts[K1_BY_RANGE] = dict(flash.segmented_block_attention.launches_by_range)
    return counts


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device time of one call. `reps` calls are captured in a CUDA
    graph after a warm-up and the graph is replayed between two CUDA events,
    so the host's cost of launching does not enter the time. The warm-up and
    the capture run on one side stream: the decode kernel's merge counts are
    kept per stream and must exist before a capture on it. cold: each call
    follows a write of 64 MiB, more than the 50 MB L2, as a decode step
    finds the cache it reads; the time of the writes alone is subtracted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the graph: allocator, library handles
    torch.cuda.current_stream().wait_stream(side)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda") if cold else None

    def replay_ms(body) -> float:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                body()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    if not cold:
        return replay_ms(fn)
    return replay_ms(lambda: (flush.zero_(), fn())) - replay_ms(flush.zero_)


def compare(name, kernel, plain, results, work, library=None, reps=20, cold=False, report=False, entry=None):
    """Hold a kernel against its plain version on the same inputs. work:
    (operations, bytes) the call needs; cold: time each call with a cold L2
    (see cuda_ms); report: the case is the kernel's main-path shape, whose
    times, bound and library time go in the kernels line; entry: that
    line's entry (default: the name up to "["). Returns the case's times."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
    err = diff.max().item()
    n_bad = int((diff > KERNEL_RTOL * mag + KERNEL_ATOL).sum())
    ms, plain_ms = cuda_ms(kernel, reps, cold), cuda_ms(plain, max(2, reps // 4), cold)
    flops, nbytes = work
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    library_ms = cuda_ms(library, max(2, reps // 4), cold) if library is not None else None
    print(f"  {name}: max_abs_err {err:.3e} (|ref| max {mag.max().item():.3f}; tol {KERNEL_RTOL:.4g}*|ref| "
          f"+ {KERNEL_ATOL}: {n_bad} outside); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops:.4g} ops, {nbytes:.4g} bytes: {100 * bound_ms / ms:.1f} % of the bound)"
          + (f", library call {library_ms:.4f} ms" if library is not None else ""))
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} elements of the kernel's output disagree with its plain version")
    res = results.setdefault(entry or name.split("[")[0], {"max_abs_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    if report:
        res.update(timed)
    return timed


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def synthetic_pages(rng):
    """4 noisy 1024x1024 pages; line i of each page is a dark-on-light band."""
    pages, bboxes = [], []
    for _ in range(N_PAGES):
        arr = rng.integers(200, 256, (1024, 1024, 3), dtype=np.uint8)
        boxes = []
        for i, (h, w) in enumerate(LINE_SHAPES):
            y0 = 16 + 124 * i
            arr[y0 : y0 + h, 12 : 12 + w] = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
            boxes.append([12, y0, 12 + w, y0 + h])
        pages.append(Image.fromarray(arr))
        bboxes.append(boxes)
    return pages, bboxes


def synthetic_full_pages(rng, n=OCR_PAGES):
    """n noisy 1024x1024 pages of 16 dark line bands each, 24 px tall every
    62 px, of random widths: what the detector's blob hook sees as lines."""
    pages = []
    for _ in range(n):
        arr = rng.integers(200, 256, (OCR_PAGE_SIZE, OCR_PAGE_SIZE, 3), dtype=np.uint8)
        for i in range(OCR_LINES):
            y0, w = 24 + 62 * i, int(rng.integers(300, 960))
            arr[y0 : y0 + 24, 32 : 32 + w] = rng.integers(0, 80, (24, w, 1), dtype=np.uint8)
        pages.append(Image.fromarray(arr))
    return pages


def randn(gen, *shape, scale=0.3):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def to_cuda(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to("cuda")


def computed_pairs(gid: np.ndarray, starts: np.ndarray, kv_range: int) -> int:
    """The query-key pairs K1 computes for one head, modelled from its span
    rule (warp_span in csrc/flash_attn.cu), not counted on the card. Each 16
    query rows span the keys from the start of their first row's group run
    to the end of their last row's, clipped to their window (the whole
    window for rows not inside it); each 64-row CTA walks the union of its 4
    warps' spans in 64-key tiles, and a warp computes the tiles that meet
    its own span."""
    S = gid.size
    bounds = np.concatenate([[0], np.flatnonzero(gid[1:] != gid[:-1]) + 1, [S]])
    run_start, run_end = np.repeat(bounds[:-1], np.diff(bounds)), np.repeat(bounds[1:], np.diff(bounds))
    r0 = np.arange(0, S, 16)
    kv0 = np.clip(starts[r0 // flash.PLAN_CHUNK].astype(np.int64), 0, S - kv_range)
    kv1 = kv0 + kv_range
    inside = (r0 >= kv0) & (r0 + 16 <= kv1)
    lo = np.where(inside, np.maximum(run_start[r0], kv0), kv0).reshape(-1, 4)
    hi = np.where(inside, np.minimum(run_end[r0 + 15], kv1), kv1).reshape(-1, 4)
    pairs = 0
    for w_lo, w_hi in zip(lo, hi):
        kt = w_lo.min() + 64 * np.arange(-(-(w_hi.max() - w_lo.min()) // 64))
        pairs += 16 * 64 * int(((kt[None] < w_hi[:, None]) & (kt[None] + 64 > w_lo[:, None])).sum())
    return pairs


def segmented_inputs(gen, S, H, D):
    """q, k, v: [S, H, D] bf16, k and v strided views of one fused qkv
    tensor, as the encoder passes them; unit-scale queries for peaky
    attention."""
    qkv = randn(gen, S, 3, H, D)
    return (qkv[:, 0].float() / 0.3).to(torch.bfloat16), qkv[:, 1], qkv[:, 2]


def check_segmented(results, plan, gen, tag, report=False):
    """K1 over the layout plan of one prefill wave: its full-attention and
    its windowed blocks, each reported as an entry of its own."""
    cfg = EncoderConfig(**DEFAULT_ENCODER)
    S, H, D = plan.cap, cfg.num_heads, cfg.head_dim
    q, k, v = segmented_inputs(gen, S, H, D)
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))  # [1, H, S, D] for the library call
    for label, gid, starts, rng_len in [
        ("full", plan.seg_id, plan.kv_starts, plan.kv_range),
        ("window", plan.win_id, plan.win_starts, plan.win_range),
    ]:
        gid_t, starts_t = to_cuda(gid), to_cuda(starts)
        # the work this plan needs: each real patch attends the patches of its own group
        _, sizes = np.unique(gid[gid >= 0], return_counts=True)
        pairs = int((sizes.astype(np.int64) ** 2).sum())
        print(f"  K1 [{tag}, {label}] S={S} H={H} D={D} kv_range={rng_len} "
              f"(kv_starts max {int(starts.max())}, {pairs} query-key pairs in {len(sizes)} groups)")
        done = computed_pairs(gid, starts, rng_len)
        print(f"    pairs per head, modelled from the span rule: the kernel computes {done} "
              f"({done / pairs:.2f} x the plan's), the whole windows hold {S * rng_len} ({S * rng_len / pairs:.2f} x)")
        mask = (gid_t[:, None] == gid_t[None, :])[None, None]

        def library():
            # the fused backends take the dense mask without forming the S x S
            # scores, which at the whole-page S (32768) would not fit the card
            with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        compare(
            f"segmented_block_attention[{tag}, {label}]",
            lambda: flash.segmented_block_attention(q, k, v, gid_t, starts_t, rng_len),
            lambda: flash.segmented_block_attention_reference(q, k, v, gid_t, starts_t, rng_len),
            results,
            work=(4 * pairs * H * D, 4 * nbytes(q)),
            library=library,
            report=report,
            entry=f"segmented_block_attention[{label}]",
        )


def check_segmented_edges(gen):
    """K1 where no layout plan takes it, at the encoder's width. Contiguous
    groups of 1 to 300 slots; half the 128-row query chunks lie inside their
    window, the other half start it anywhere in [-200, S), so their rows lie
    partly or wholly outside it (a row with no valid key averages its window)
    and some starts are clamped; the window, 1000 keys, is no multiple of
    the 64-key tile."""
    cfg = EncoderConfig(**DEFAULT_ENCODER)
    S, H, D, kv_range = 8192, cfg.num_heads, cfg.head_dim, 1000
    rng = np.random.default_rng(SEED)
    gid = np.repeat(np.arange(S, dtype=np.int32), rng.integers(1, 301, S))[:S]
    n = S // flash.PLAN_CHUNK
    starts = flash.PLAN_CHUNK * np.arange(n) - rng.integers(0, kv_range - flash.PLAN_CHUNK + 1, n)
    anywhere = rng.random(n) < 0.5
    starts = np.where(anywhere, rng.integers(-200, S, n), starts).astype(np.int32)
    kv0 = np.clip(starts.astype(np.int64), 0, S - kv_range)
    keys = gid[kv0[:, None] + np.arange(kv_range)]  # [n, kv_range]
    valid = (gid.reshape(n, -1)[:, :, None] == keys[:, None, :]).sum(-1)  # [n, 128]
    rows = (kv0[:, None] <= np.arange(S).reshape(n, -1)) & (np.arange(S).reshape(n, -1) < kv0[:, None] + kv_range)
    pairs = int(np.where(valid > 0, valid, kv_range).sum())  # rows without a valid key take the window
    print(f"  K1 [edges] S={S} H={H} D={D} kv_range={kv_range}: {int(anywhere.sum())} of {n} chunks start "
          f"their window anywhere; {int((~rows).sum())} rows lie outside it, {int((valid == 0).sum())} have no "
          f"valid key")
    q, k, v = segmented_inputs(gen, S, H, D)
    gid_t, starts_t = to_cuda(gid), to_cuda(starts)
    compare(
        "segmented_block_attention[edges]",
        lambda: flash.segmented_block_attention(q, k, v, gid_t, starts_t, kv_range),
        lambda: flash.segmented_block_attention_reference(q, k, v, gid_t, starts_t, kv_range),
        {},
        work=(4 * pairs * H * D, 4 * nbytes(q)),
    )


def check_causal(results, B, L, gen, report=False):
    """K2 over B right-padded prompts of bucket L."""
    qc, kc, vc = randn(gen, B, L, 12, 128, scale=1.0), randn(gen, B, L, 4, 128), randn(gen, B, L, 4, 128)
    print(f"  K2 B={B} L={L} H=12 kvh=4 D=128")
    qt, kt, vt = (x.transpose(1, 2) for x in (qc, kc, vc))
    compare(
        f"causal_flash_attention[{B}x{L}]",
        lambda: flash.causal_flash_attention(qc, kc, vc),
        lambda: flash.causal_flash_attention_reference(qc, kc, vc),
        results,
        work=(4 * B * 12 * 128 * (L * (L + 1) // 2), 2 * nbytes(qc) + nbytes(kc, vc)),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        report=report,
    )


def decode_inputs(gen, B, S, K, layers=10):
    """q, bf16 cache and chunk, and the same cache quantized to int8, at the
    decoder's widths (12/4 heads, D = 128)."""
    qd = randn(gen, B, 12, 128, scale=1.0)
    kcache, vcache = randn(gen, layers, B, 4, S, 128), randn(gen, layers, B, 4, S, 128)
    ck, cv = randn(gen, layers, B, 4, K, 128), randn(gen, layers, B, 4, K, 128)
    (kq, ks), (vq, vs) = qwen_decoder.quantize_kv(kcache), qwen_decoder.quantize_kv(vcache)
    return qd, (kcache, vcache), (kq, vq, ks, vs), (ck, cv)


def decode_library(qd, kcache, vcache, lens, ck, cv, step, layer):
    """K3's yardstick: one scaled_dot_product_attention call (enable_gqa, a
    boolean mask) over the layer's cache and chunk joined into one K/V
    beforehand, outside the timed call. The first backend in
    DECODE_SDPA_BACKENDS that takes these inputs is used and named. The port
    never calls it. Returns (call, backend name)."""
    S, K = kcache.shape[3], ck.shape[3]
    kj, vj = torch.cat([kcache[layer], ck[layer]], dim=2), torch.cat([vcache[layer], cv[layer]], dim=2)
    cols = torch.arange(S + K, device="cuda")
    mask = torch.where(cols < S, cols[None] < lens[:, None].long(), cols[None] - S <= step)[:, None, None, :]
    qh = qd[:, :, None, :]
    for backend in DECODE_SDPA_BACKENDS:
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qh, kj, vj, attn_mask=mask, enable_gqa=True)[:, :, 0]
        try:
            call()
        except RuntimeError:  # this backend does not take a boolean mask with enable_gqa
            continue
        return call, backend.name
    raise RuntimeError("no SDPA backend takes K3's inputs")


def check_decode_case(results, label, inputs, lens_np, step, layer, library=False):
    """K3 and K3q on one (lengths, step, layer) case, each within tolerance
    of its plain version, timed with a cold L2 as a decode step finds the
    cache. Returns {kernel: its times}."""
    qd, (kcache, vcache), (kq, vq, ks, vs), (ck, cv) = inputs
    B, S, K = qd.shape[0], kcache.shape[3], ck.shape[3]
    lens = to_cuda(lens_np)
    rows = int(lens_np.sum())  # valid cache rows of each kv head, over all slots
    ops = 4 * 12 * 128 * (rows + B * (step + 1))
    chunk_bytes = 2 * B * 4 * (step + 1) * 128 * 2
    other = 2 * nbytes(qd) + nbytes(lens)
    print(f"  K3 B={B} S={S} K={K} step={step} layer={layer}, {label} lengths "
          f"(longest {int(lens_np.max())}; {rows} valid cache rows per kv head)")
    lib_call = None
    if library:
        lib_call, backend = decode_library(qd, kcache, vcache, lens, ck, cv, step, layer)
        ref = decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer)
        print(f"    library call: SDPA, {backend} backend, max_abs_err {(lib_call().float() - ref.float()).abs().max().item():.3e} "
              f"against the plain version")
    timed = {"gqa_decode": compare(
        f"gqa_decode[{step}, {label}]",
        lambda: decode_attn.gqa_decode(qd, kcache, vcache, lens, ck, cv, step, layer),
        lambda: decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer),
        results,
        work=(ops, 2 * rows * 4 * 128 * 2 + chunk_bytes + other),
        library=lib_call,
        cold=True,  # a decode step reads each layer's cache once
    )}
    print("  K3q, the same with an int8 cache and bf16 row scales" +
          ("; no PyTorch call reads an int8 cache with row scales, so it has no library time" if library else ""))
    timed["gqa_decode_int8"] = compare(
        f"gqa_decode_int8[{step}, {label}]",
        lambda: decode_attn.gqa_decode(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
        lambda: decode_attn.gqa_decode_reference(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
        results,
        work=(ops, 2 * rows * 4 * (128 + 2) + chunk_bytes + other),
        cold=True,
    )
    return timed


def check_decode(results, gen):
    """K3 and K3q at the free-running path's cache: 128 slots + trash, 10
    layers, a 512-row cache, 64-column chunks; K3q reads the same cache
    quantized to int8. Ragged lengths at three (step, layer) pairs, the first
    the long-cache row of PERF.md; every slot at the longest length and every
    slot at the ragged mean (the same longest slot with twice the rows, and
    the same rows with a shorter longest slot); the edges of the kernels'
    partition in one batch (lengths 0 and 1, each side of a 16-row sub-tile,
    of a T = SPLIT_ROWS split, and of S) at the first and last step; and the
    floor, every length 0 at step 0: the fixed cost of a call and of the
    timing. Then 300 slots of ragged lengths over 2 layers, a slot count no
    recognition batch here reaches, at the last step. Returns the long-cache
    row's times."""
    B, S3, K = 129, 512, 64
    inputs = decode_inputs(gen, B, S3, K)
    ragged = np.random.default_rng(SEED).integers(0, S3 + 1, B).astype(np.int32)
    ragged[:4] = [0, 1, 117, S3]
    mean = int(round(ragged.mean()))
    sub, T = 16, decode_attn.SPLIT_ROWS  # a warp's sub-tile (SUB in csrc/decode_attn.cu), a split's rows
    edges = np.resize(np.array([0, 1, sub - 1, sub, sub + 1, T - 1, T, T + 1, S3 - 1, S3], np.int32), B)
    cases = [("ragged", ragged, 37, 7), ("ragged", ragged, 0, 0), ("ragged", ragged, 63, 9),
             (f"all {S3}", np.full(B, S3, np.int32), 37, 7), (f"all {mean}", np.full(B, mean, np.int32), 37, 7),
             ("edge", edges, 0, 3), ("edge", edges, K - 1, 3), ("floor: all 0", np.zeros(B, np.int32), 0, 0)]
    timed = [check_decode_case(results, label, inputs, lens_np, step, layer, library=i == 0)
             for i, (label, lens_np, step, layer) in enumerate(cases)]
    many = np.random.default_rng(SEED + 1).integers(0, S3 + 1, 300).astype(np.int32)
    check_decode_case(results, "300 slots, ragged", decode_inputs(gen, many.size, S3, K, layers=2), many, K - 1, 1)
    return timed[0]


class DecodeShapes:
    """For one predictor run, the decoder's `decode_attn` becomes a stand-in
    (in this script only) whose `gqa_decode` keeps, for each decode kernel,
    the first call's lengths (a device copy: no sync) and its cache and
    chunk shapes, then calls the wrapper."""

    def __init__(self):
        self.first = {}

    def __enter__(self):
        def record(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale=None, v_scale=None):
            kernel = "gqa_decode" if k_scale is None else "gqa_decode_int8"
            if kernel not in self.first:
                self.first[kernel] = dict(lengths=lengths.clone(), cache=tuple(k_cache.shape),
                                          chunk=tuple(chunk_k.shape))
            return decode_attn.gqa_decode(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale, v_scale)

        qwen_decoder.decode_attn = types.SimpleNamespace(
            gqa_decode=record, gqa_decode_reference=decode_attn.gqa_decode_reference)
        return self

    def __exit__(self, *exc):
        qwen_decoder.decode_attn = decode_attn


def check_decode_main_path(results, gen, shapes, long_cache):
    """K3 at the first decode call of the pinned given-lines run, K3q at that
    of the pinned whole-page run: their lengths, S and K, random inputs, at
    steps 0, K/2 - 1 and K - 1 (a chunk runs every step once). The kernels
    line takes their mean as the main-path entry and lists each step, and
    the ragged S = 512 step-37 case as the long-cache row."""
    for kernel, rec in shapes.items():
        layers, B, kvh, S, _ = rec["cache"]
        K = rec["chunk"][3]
        lens_np = rec["lengths"].cpu().numpy().astype(np.int32)
        print(f"  {kernel} main path: {B} slots, S={S}, K={K}, {int((lens_np > 0).sum())} slots with cache rows "
              f"(lengths {int(lens_np.min())} to {int(lens_np.max())})")
        inputs = decode_inputs(gen, B, S, K, layers)
        by_step = {}
        for step in (0, K // 2 - 1, K - 1):
            by_step[str(step)] = check_decode_case(
                results, "main path", inputs, lens_np, step, layers - 1, library=kernel == "gqa_decode"
            )[kernel]
        keys = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if kernel == "gqa_decode" else ())
        res = results[kernel]
        res.update({k: float(np.mean([t[k] for t in by_step.values()])) for k in keys})
        res.setdefault("library_ms", None)
        res.update(bound_by=by_step[str(K - 1)]["bound_by"], main_path=dict(slots=B, S=S, K=K), by_step=by_step,
                   long_cache=long_cache[kernel])
        print(f"    {kernel}: mean over steps {list(by_step)}: {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({100 * res['bound_ms'] / res['ms']:.1f} %)")


def first_wave(pred, flat):
    """The prefill batch of the predictor's first wave over flat's lines, as
    its scheduler builds it: widest line first, the row bucket that fits.
    Returns (batch, number of lines)."""
    order = sorted(range(len(flat["slices"])), key=lambda j: -flat["slices"][j].shape[1])
    if len(order) > pred.prefill_row_buckets[-1]:
        raise ValueError(f"{len(order)} lines do not fit one wave")
    imgs = [pred._prepare_image(flat["slices"][j], flat["task_names"][j]) for j in order]
    batch = pred.processor.build_prefill_batch(
        imgs, [flat["task_names"][j] for j in order], [flat["input_text"][j] for j in order], [True] * len(imgs),
        pred.config.encoder, batch_rows=next(b for b in pred.prefill_row_buckets if b >= len(imgs)),
        seq_buckets=pred.seq_buckets, patch_caps=pred.patch_caps,
    )
    return batch, len(imgs)


def check_lines(results, pages, lines_per_page):
    n_lines = sum(len(r.text_lines) for r in results)
    if len(results) != len(pages) or any(len(r.text_lines) != lines_per_page for r in results):
        raise AssertionError(f"expected {len(pages)} pages of {lines_per_page} lines, "
                             f"got {[len(r.text_lines) for r in results]}")
    for r in results:
        for line in r.text_lines:
            if not (isinstance(line.text, str) and np.isfinite(line.confidence) and 0 <= line.confidence <= 1):
                raise AssertionError(f"bad line {line.text!r} {line.confidence}")
            if any(not np.isfinite(c.confidence) for c in line.chars):
                raise AssertionError("non-finite char confidence")
    return n_lines


def set_pin(pin: bool):
    settings.RECOGNITION_PIN_DECODE = pin
    settings.RECOGNITION_MAX_TOKENS = PIN_TOKENS if pin else None


def run_predictor(pred, pages, bboxes, pin: bool):
    set_pin(pin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pred(pages, bboxes=bboxes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, check_lines(results, pages, LINES_PER_PAGE), pred.last_decoded_tokens


class TimedDetector:
    """A DetectionPredictor whose calls are timed, to the end of their work on the card."""

    def __init__(self, det):
        self.det, self.wall = det, 0.0

    def __call__(self, images, batch_size=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.det(images, batch_size=batch_size)
        torch.cuda.synchronize()
        self.wall += time.perf_counter() - t0
        return out


def run_full_page(pred, det, pages, pin: bool):
    """Whole-page OCR; returns (detection wall, recognition wall, lines, tokens)."""
    set_pin(pin)
    timed = TimedDetector(det)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pred([p.copy() for p in pages], det_predictor=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return timed.wall, wall - timed.wall, check_lines(results, pages, OCR_LINES), pred.last_decoded_tokens


class Detector:
    """A DetectionPredictor whose calls are timed without synchronising:
    a call returns host boxes, so it ends after its device work, and a
    synchronise would wait for recognition's stream too."""

    def __init__(self, det):
        self.det, self.calls = det, []

    def __call__(self, images, batch_size=None):
        t0 = time.perf_counter()
        out = self.det(images, batch_size=batch_size)
        self.calls.append(time.perf_counter() - t0)
        return out


def bbox_iou(a, b):
    ix0, iy0, ix1, iy1 = max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union else 0.0


def hold_boxes(host, dev, min_iou=0.8, max_extra=1):
    """The IoU rule of tests/test_device_postprocess.py: box counts within
    max_extra, and every host box but max_extra matched at IoU >= min_iou."""
    h_boxes, d_boxes = [b.bbox for b in host.bboxes], [b.bbox for b in dev.bboxes]
    matched = sum(max((bbox_iou(hb, db) for db in d_boxes), default=0.0) >= min_iou for hb in h_boxes)
    if abs(len(h_boxes) - len(d_boxes)) > max_extra or matched < len(h_boxes) - max_extra:
        raise AssertionError(f"stats-path boxes: {len(d_boxes)} against {len(h_boxes)} host boxes, "
                             f"{matched} matched at IoU >= {min_iou}")


def check_detection(det, pages, power):
    """Detection of the pages on the card with the device resize and stats
    left at auto (on for CUDA) against both off (PIL on the host, the maps
    path, the C++ CRAFT op), by the IoU rule; then the device-resized pixels
    of one batch against PIL's double LANCZOS, and against the same products
    on the CPU (bf16 operands, float32 results)."""
    res = {}
    for label, value in [("device resize + stats (auto)", None), ("host resize + maps", False)]:
        settings.DETECTOR_DEVICE_RESIZE = settings.DETECTOR_ON_DEVICE_POSTPROCESS = value
        det([p.copy() for p in pages])  # warm-up at these shapes
        before = (det.stats_batches, det.maps_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[label] = det([p.copy() for p in pages])
        wall = time.perf_counter() - t0
        n_stats, n_maps = det.stats_batches - before[0], det.maps_batches - before[1]
        n_boxes = sum(len(r.bboxes) for r in res[label])
        print(f"    {label}: {len(pages)} pages, {n_boxes} boxes, {n_stats} stats batches, {n_maps} maps batches; "
              f"detection {wall:.4f} s, {len(pages) / wall:.2f} pages/s [{power}]")
        if value is None and not (n_stats > 0 and n_maps == 0):
            raise AssertionError(f"auto settings took the stats path in {n_stats} batches, the maps path in {n_maps}")
    settings.DETECTOR_DEVICE_RESIZE = settings.DETECTOR_ON_DEVICE_POSTPROCESS = None
    for host, dev in zip(res["host resize + maps"], res["device resize + stats (auto)"]):
        if len(host.bboxes) != OCR_LINES:
            raise AssertionError(f"the host path found {len(host.bboxes)} lines on a page of {OCR_LINES}")
        hold_boxes(host, dev)
    print(f"    stats-path boxes held against the host path's: every page within the IoU rule")

    parts = [p.convert("RGB") for p in pages[: det.pipeline_cap(settings.DETECTOR_PIPELINE_BATCH, det.get_batch_size())]]
    buf, (uniq, gid) = det._canvas(parts, len(parts))
    Vs, Hs = det._resize_mats(uniq, 1 << (len(uniq) - 1).bit_length(), tuple(buf.shape[1:3]))
    card_px = resize_on_device(buf.cuda(), Vs, Hs, torch.from_numpy(gid).cuda(), det.dtype)
    cpu_px = resize_on_device(buf, Vs.cpu(), Hs.cpu(), torch.from_numpy(gid), det.dtype)
    card_px = card_px.expand(-1, 3, -1, -1).permute(0, 2, 3, 1).cpu().numpy()
    cpu_px = cpu_px.expand(-1, 3, -1, -1).permute(0, 2, 3, 1).numpy()
    pil = np.stack([det.prepare_image(p.copy()) for p in parts]).astype(np.float32)
    d_pil, d_cpu = np.abs(card_px - pil), np.abs(card_px - cpu_px)
    print(f"    device resize of one batch ({len(parts)} chunks {buf.shape[1]}x{buf.shape[2]}x{buf.shape[3]} -> "
          f"{pil.shape[1]}x{pil.shape[2]}, {det.dtype}): against PIL mean |diff| {d_pil.mean():.4f}, "
          f"within 1 level {(d_pil <= 1).mean():.4f}, max {d_pil.max():.0f}; against the CPU's products "
          f"within 1 level {(d_cpu <= 1).mean():.6f}, max {d_cpu.max():.0f}")
    if (d_pil <= 1).mean() < RESIZE_WITHIN_1 or d_pil.mean() > RESIZE_MEAN:
        raise AssertionError(f"the device resize is further from PIL than {RESIZE_WITHIN_1} within 1 level, "
                             f"mean {RESIZE_MEAN}")
    if (d_cpu <= 1).mean() < 0.999:
        raise AssertionError("the device resize disagrees with the same products on the CPU")


def run_pages(pred, det, pages, pipeline_pages: int):
    """Whole-page OCR of pages with RECOGNITION_DET_PIPELINE_PAGES set as
    given. Returns (results, wall, detection calls' walls, the token ids of
    every line in page order)."""
    settings.RECOGNITION_DET_PIPELINE_PAGES = pipeline_pages
    timed, runs = Detector(det), []
    loop = pred.prediction_loop

    def recording(*args, **kwargs):
        runs.append(loop(*args, **kwargs))
        return runs[-1]

    pred.prediction_loop = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = pred([p.copy() for p in pages], det_predictor=timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del pred.prediction_loop
    if len(runs) != 1:
        raise AssertionError(f"{len(runs)} recognition loops ran (leftovers?), want 1")
    return results, wall, timed.calls, runs[0][0]


def agreement(tokens, ref):
    """(share of lines whose token ids equal ref's, share with the same token
    0, the median index of the first token that differs, over the lines that
    differ; None when none does)."""
    first = [next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None) for x, y in zip(tokens, ref)]
    differ = [i for i in first if i is not None]
    return (float(np.mean([x == y for x, y in zip(tokens, ref)])),
            float(np.mean([x[:1] == y[:1] for x, y in zip(tokens, ref)])),
            float(np.median(differ)) if differ else None)


def check_north_star(pred, det, pages, power):
    """Whole-page OCR at bench.py's shape (16 pages, int8 cache, 40 pinned
    tokens a line) through the streaming path (detection of the second group
    of 8 pages in a worker thread, feeding the live run), the same with every
    output read only after a device synchronise, and sequentially. All three
    must find the same lines and decode the same token count; the pipelined
    and the synchronised streaming runs, whose waves are the same, must agree
    on the token ids of at least TOKEN_AGREEMENT of the lines (a read of a
    copy that has not landed would not). Returns the streaming run's results."""
    set_pin(True)
    settings.RECOGNITION_MODEL_QUANTIZE = True
    run_pages(pred, det, pages, PIPELINE_PAGES)  # warm-up at these shapes
    fetch = pred._fetch

    def fetch_then_synchronise(*tensors):
        handle = fetch(*tensors)
        torch.cuda.synchronize()
        return handle

    out = {}
    for label, g, synchronised in [("streaming", PIPELINE_PAGES, False),
                                   ("streaming, reads after a synchronise", PIPELINE_PAGES, True),
                                   ("sequential", 0, False)]:
        reset_counts()
        if synchronised:
            pred._fetch = fetch_then_synchronise
        try:
            results, wall, det_calls, tokens = run_pages(pred, det, pages, g)
        finally:
            pred.__dict__.pop("_fetch", None)
        launches = read_counts()
        n_l = check_lines(results, pages, OCR_LINES)
        n_t = sum(len(t) for t in tokens)
        rec_wall = wall - det_calls[0]  # recognition starts once the first group is detected
        print(f"    {label} (RECOGNITION_DET_PIPELINE_PAGES={g}): {len(pages)} pages, {n_l} lines, {n_t} tokens; "
              f"wall {wall:.4f} s, detection {sum(det_calls):.4f} s in {len(det_calls)} calls, recognition after "
              f"the first detection call {rec_wall:.4f} s; {len(pages) / wall:.2f} pages/s, {n_l / wall:.2f} "
              f"lines/s [{power}]")
        if n_t != PIN_TOKENS * n_l:
            raise AssertionError(f"{label}: {n_t} tokens for {n_l} lines, want {PIN_TOKENS} a line")
        out[label] = (results, tokens, launches)
    s_res, s_tok, s_launch = out["streaming"]
    for label in ("streaming, reads after a synchronise", "sequential"):
        res, tok, _ = out[label]
        if len(tok) != len(s_tok) or any(
                [ln.polygon for ln in a.text_lines] != [ln.polygon for ln in b.text_lines] for a, b in zip(s_res, res)):
            raise AssertionError(f"the streaming and the {label} run found other lines")
        same, same0, first = agreement(tok, s_tok)
        print(f"    token ids against the streaming run, {label}: {same:.4f} of the lines the same, {same0:.4f} "
              f"with the same token 0, the first difference at token {first} (median)")
        if label != "sequential" and same < TOKEN_AGREEMENT:
            raise AssertionError(f"the pipelined reads agree with the synchronised ones on {same:.4f} of the lines")
    assert_launched("streaming whole-page", s_launch,
                    ["segmented_block_attention", "causal_flash_attention", "gqa_decode_int8"], ["gqa_decode"])
    settings.RECOGNITION_DET_PIPELINE_PAGES = PIPELINE_PAGES
    return s_res


def check_sync_free_dispatch(pred, det, pages, power):
    """One whole-page call, free-running, whose recognition dispatches
    (uploads, the device programs, the enqueued copies of their outputs:
    prefill waves with their fused chunks, then decode chunks) run under
    torch.cuda.set_sync_debug_mode("error"): any hidden host sync in them
    raises. The drains' event waits lie outside. Sequential, so detection
    (whose component flood checks its convergence on the host) has ended
    before the first dispatch."""
    guarded = {"_dispatch_prefill": 0, "_dispatch_decode": 0}
    for name in guarded:
        fn = getattr(pred, name)

        def under_debug(*args, _fn=fn, _name=name, **kwargs):
            guarded[_name] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        setattr(pred, name, under_debug)
    set_pin(False)  # free-running: a wave's fused chunk leaves decoding slots, so decode chunks follow
    try:
        results, wall, _, _ = run_pages(pred, det, pages, 0)
    finally:
        for name in guarded:
            delattr(pred, name)
        set_pin(True)
    n_l = check_lines(results, pages, OCR_LINES)
    print(f"    {guarded['_dispatch_prefill']} prefill and {guarded['_dispatch_decode']} decode dispatches under "
          f"sync debug mode \"error\": no host sync; {n_l} lines, wall {wall:.4f} s [{power}]")
    if not all(guarded.values()):
        raise AssertionError(f"dispatches under the debug mode: {guarded}")


def check_stream(pred, det, pages, batch_results, power):
    """stream() over a generator of the pages, in groups of PIPELINE_PAGES
    (the batch call's detection batches, so the same boxes): yields in order,
    each page's lines and polygons those of the batch call."""
    t0 = time.perf_counter()
    first, got = None, []
    for i, res in pred.stream((p.copy() for p in pages), det, group_pages=PIPELINE_PAGES):
        if first is None:
            first = time.perf_counter() - t0
        got.append((i, res))
    wall = time.perf_counter() - t0
    if [i for i, _ in got] != list(range(len(pages))):
        raise AssertionError(f"stream() yielded pages {[i for i, _ in got]}")
    for (_, a), b in zip(got, batch_results):
        if [ln.polygon for ln in a.text_lines] != [ln.polygon for ln in b.text_lines]:
            raise AssertionError("a streamed page's lines differ from the batch call's")
    n_l = check_lines([r for _, r in got], pages, OCR_LINES)
    print(f"    stream(): {len(pages)} pages in order, {n_l} lines as the batch call's; first page after "
          f"{first:.4f} s, all after {wall:.4f} s, {len(pages) / wall:.2f} pages/s [{power}]")


def check_model_paths(pred, flat, quantize: bool):
    """One prefill wave over flat's lines (the first_wave batch), then one
    decode step over the cache it filled (bf16, or int8 with quantize), run
    three ways on the same weights and inputs: bf16 through the kernels,
    bf16 through the plain versions, and float32 through the plain versions.
    The kernel path must be no further from the float32 run than MODEL_RATIO
    times the plain bf16 path is."""
    proc = pred.processor
    batch, _ = first_wave(pred, flat)
    rows, L = batch.input_ids.shape
    lay = batch.layout
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(pred.device)

    enc_args = tuple(t(a) for a in lay.device_args)
    dec = pred.config.decoder
    slots = torch.arange(rows, device=pred.device)

    def run(model, use_kernels, dtype):
        patches = proc.normalize_patch_rows(t(batch.patches), dtype)
        img = model.encode_images(patches, enc_args, t(lay.llm_h_idx), t(lay.llm_w_idx),
                                  lay.kv_range, lay.win_range, use_kernels=use_kernels)
        embeds = model.embed_prompt_tokens(t(batch.input_ids), t(batch.img_gather), img)
        nk, nv, last = model.decoder.prefill(embeds, t(batch.seq_lens), use_kernels=use_kernels)
        cache = qwen_decoder.init_cache(dec, rows, -(-L // 256) * 256, dtype, pred.device, quantize=quantize)
        qwen_decoder.merge_prefill(cache, nk, nv, t(batch.seq_lens), slots)
        ck = torch.zeros((dec.num_hidden_layers, rows, dec.num_key_value_heads, 8, dec.head_dim),
                         dtype=dtype, device=pred.device)
        emb = model.token_embed(t(batch.input_ids[:, 0].astype(np.int64)))
        hid = model.decoder.decode_step_chunked(cache, ck, torch.zeros_like(ck), emb, 0,
                                                cache["len"].clone(), use_kernels=use_kernels)
        return {"image tokens": img[: lay.n_llm_tokens], "prefill hidden": last, "decode hidden": hid}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    with torch.inference_mode():
        before = read_counts()
        kern = run(pred.model, True, pred.dtype)
        used = {n: c - before[n] for n, c in read_counts().items() if n in COUNTERS}
        plain = run(pred.model, False, pred.dtype)
        model32 = copy.deepcopy(pred.model).float()
        ref = run(model32, False, torch.float32)
        del model32
    decode_kernel = "gqa_decode_int8" if quantize else "gqa_decode"
    other = "gqa_decode" if quantize else "gqa_decode_int8"
    if used[decode_kernel] != dec.num_hidden_layers or used[other]:
        raise AssertionError(f"the kernel path's decode step ran {used}, want {decode_kernel} once a layer")
    for key in kern:
        e_k, e_p = rel(kern[key], ref[key]), rel(plain[key], ref[key])
        print(f"  {rows} rows, {'int8' if quantize else 'bf16'} cache, {key}: rel err vs float32 plain: kernels {e_k:.3e}, "
              f"plain bf16 {e_p:.3e}; kernels vs plain bf16 {rel(kern[key], plain[key]):.3e}")
        if not (np.isfinite(e_k) and e_k <= MODEL_RATIO * e_p):
            raise AssertionError(f"{key}: kernel path is further from float32 than {MODEL_RATIO}x the plain path")


def bench_pages(n: int):
    """Pages of bench.py's shape: 1240x1754, 40 lines of text."""
    pages = []
    for k in range(n):
        img = Image.new("RGB", (1240, 1754), "white")
        draw = ImageDraw.Draw(img)
        for i in range(40):
            draw.text((60, 40 + i * 42), f"Line {i} of page {k}: the quick brown fox jumps over the lazy dog.",
                      fill="black")
        pages.append(img)
    return pages


def synchronised(fn, *args):
    """fn(*args) and its wall, to the end of its work on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def float32_against_cpu(label, cls, config, pixels, generate):
    """The model at `config` in float32 on the card (TF32 off) and on the CPU
    with the same weights, on uint8 pixels [B, H, W, 3]: the encoder outputs'
    relative error must be at most ENCODER_REL_ERR; generate(model, x) gives
    per-step (valid [B, M], tokens [B, M, ...]) whose agreement is printed."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = cls(device="cuda", config=config, dtype=torch.float32).model
        cpu = cls(device="cpu", config=config).model
        cpu.load_state_dict(gpu.state_dict())
        x = (torch.from_numpy(pixels).float() / 255.0 - 0.5) / 0.5
        with torch.inference_mode():
            enc_g, enc_c = gpu.encoder(x.cuda()).cpu(), cpu.encoder(x)
            (valid_g, tok_g), (valid_c, tok_c) = generate(gpu, x.cuda()), generate(cpu, x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = float((enc_g - enc_c).norm() / enc_c.norm())
    valid_g, valid_c = valid_g.cpu(), valid_c.cpu()
    either = valid_g | valid_c
    same = valid_g & valid_c & (tok_g.cpu() == tok_c).all(-1)
    share = float(same.sum() / either.sum()) if either.any() else 1.0
    print(f"    float32 on the card (TF32 off) against the CPU, {label}: encoder output {tuple(enc_c.shape)} relative "
          f"error {rel:.3e} (limit {ENCODER_REL_ERR:.0e}); {int(same.sum())} of {int(either.sum())} recorded steps "
          f"({share:.4f}) with equal tokens")
    if not rel <= ENCODER_REL_ERR:
        raise AssertionError(f"{label}: the card's float32 encoder is {rel:.3e} from the CPU's")


def layout_tokens(model, x):
    boxes, _, valid = model.generate(x)
    return valid, boxes.to(torch.int32)  # the (box, label) token fed back, as integers


def run_layout(lay, pages, label, power):
    """One timed layout call; checks and prints it. Returns the results."""
    reset_counts()
    results, wall = synchronised(lay, pages)
    launches = read_counts()
    run = lay.last_run
    n = len(pages)
    if len(results) != n or sum(run["tiles"]) != 2 * n:
        raise AssertionError(f"{len(results)} results of {sum(run['tiles'])} tiles for {n} pages")
    for r in results:
        if not r.sliced or r.image_bbox != [0, 0, 1240, 1754]:
            raise AssertionError(f"a page came back unjoined: sliced {r.sliced}, {r.image_bbox}")
        for b in r.bboxes:
            if b.label not in ID_TO_LABEL.values() or not np.isfinite(np.asarray(b.polygon)).all():
                raise AssertionError(f"bad layout box {b.label} {b.polygon}")
    print(f"    {label}: {n} pages, {sum(run['tiles'])} tiles in {len(run['tiles'])} dispatches of {run['tiles']} "
          f"tiles; AR steps run {run['steps']}, host syncs {run['host_syncs']} (per dispatch); "
          f"{sum(len(r.bboxes) for r in results)} boxes after joining")
    print(f"    {label}: wall {wall:.4f} s, {wall / n:.4f} s/page; host enqueue of the dispatches "
          f"{run['enqueue_s']:.4f} s of the wall [{power}]")
    if any(launches[k] for k in COUNTERS):
        raise AssertionError(f"the layout path launched {launches}")
    return results


def check_layout(pages, power):
    """LayoutPredictor at the JAX package's full default width with random
    bf16 weights on bench.py's pages: each page two tiles, every result a
    joined, sliced page of finite boxes with known labels; the AR steps, host
    syncs and host enqueue time of each dispatch printed. Run as a user calls
    it, and cap-bound: with no class taken for EOS or PAD, every row decodes
    max_boxes steps (bench.py's layout split is that upper bound). Then the
    float32 check on one page, cap-bound at F32_MAX_BOXES steps. Returns the
    predictor."""
    t0 = time.perf_counter()
    lay = LayoutPredictor(device="cuda")
    c = lay.config
    print(f"    model built in {time.perf_counter() - t0:.1f} s: DonutSwin {c.encoder.image_size}, embed_dim "
          f"{c.encoder.embed_dim}, depths {c.encoder.depths}, heads {c.encoder.num_heads}, window "
          f"{c.encoder.window_size}; ADETR {c.decoder.num_hidden_layers} layers, {c.decoder.hidden_size} wide, "
          f"{c.decoder.num_attention_heads}/{c.decoder.num_key_value_heads} heads, double residual "
          f"{c.decoder.double_residual_flow}; max_boxes {c.max_boxes}; {lay.dtype} [{power}]")
    capped = dataclasses.replace(c, eos_token_id=-1, pad_token_id=-1)
    lay(pages[:2])  # warm-up (cuBLAS, cuDNN, allocator)
    run_layout(lay, pages, "as called", power)
    lay.model.config = capped
    try:
        run_layout(lay, pages, f"cap-bound ({c.max_boxes} steps)", power)
    finally:
        lay.model.config = c
    if lay.last_run["steps"] != [c.max_boxes] * len(lay.last_run["tiles"]):
        raise AssertionError(f"the cap-bound run stopped at {lay.last_run['steps']}")
    tiles, _ = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE).slice([pages[0]])
    float32_against_cpu("layout, one page (2 tiles), cap-bound at 8 steps", LayoutPredictor,
                        dataclasses.replace(capped, max_boxes=F32_MAX_BOXES),
                        np.stack([lay.prepare_image(t) for t in tiles]), layout_tokens)
    return lay


def table_tokens(model, x):
    enc = model.encode(x)
    B = x.shape[0]
    vec = torch.ones((B, 3, 10), dtype=torch.int32, device=x.device)  # bos, the whole-table query, query end
    vec[:, 1, :6] = torch.tensor([512, 512, 1024, 1024, 512, 512])
    vec[:, 1, 6:] = torch.tensor([4 + 5, 5, 5, 5])
    vec[:, 2] = 4
    bufs = model.generate(enc, vec, torch.full((B,), 3, dtype=torch.int32, device=x.device), F32_MAX_BOXES)
    tok = torch.cat([bufs["bbox"].to(torch.int32)] + [bufs[k][..., None] for k in ("category", "merges", "colspan",
                                                                                  "is_header")], -1)
    return bufs["valid"], tok


def check_table_rec(pages, power):
    """TableRecPredictor at the JAX package's full default width with random
    bf16 weights and install_synthetic_tables on 4 crops of 768x768 (as
    bench.py makes them): every table has the script's rows and columns, and
    the passes recorded the script's steps. Then the float32 check on one
    crop. Returns the predictor, with the synthetic tables installed."""
    t0 = time.perf_counter()
    tab = TableRecPredictor(device="cuda")
    c = tab.config
    print(f"    model built in {time.perf_counter() - t0:.1f} s: DonutSwin depths {c.encoder.depths}, encoder_length "
          f"{c.encoder.encoder_length}; ADETR {c.decoder.num_hidden_layers} layers, {c.decoder.hidden_size} wide, "
          f"{c.decoder.num_attention_heads}/{c.decoder.num_key_value_heads} heads, double residual "
          f"{c.decoder.double_residual_flow}; max_boxes {c.max_boxes}; {tab.dtype} [{power}]")
    install_synthetic_tables(tab, TABLE_ROWS, TABLE_COLS, TABLE_CELLS)
    crops = [p.crop((100, 100, 868, 868)) for p in pages[:TABLE_CROPS]]
    tab(crops[:1])  # warm-up
    reset_counts()
    results, wall = synchronised(tab, crops)
    launches = read_counts()
    run = tab.last_run
    n = len(crops)
    for r in results:
        if len(r.rows) != TABLE_ROWS or len(r.cols) != TABLE_COLS or not r.cells:
            raise AssertionError(f"a table came back with {len(r.rows)} rows, {len(r.cols)} columns, "
                                 f"{len(r.cells)} cells; the script gives {TABLE_ROWS} x {TABLE_COLS}")
        if {cell.row_id for cell in r.cells} != set(range(TABLE_ROWS)):
            raise AssertionError("a row has no cell")
    passes = run["passes"]
    want = [n * (TABLE_ROWS + TABLE_COLS), n * TABLE_ROWS * TABLE_CELLS]
    got = [passes[0]["recorded"], sum(p["recorded"] for p in passes[1:])]
    if len(results) != n or got != want:
        raise AssertionError(f"the passes recorded {got} steps, the script gives {want}")
    print(f"    {n} tables: rows {[len(r.rows) for r in results]}, columns {[len(r.cols) for r in results]}, cells "
          f"{[len(r.cells) for r in results]} (unmerged {[len(r.unmerged_cells) for r in results]}); recorded "
          f"steps {got[0]} rows and columns, {got[1]} cell candidates, as the script gives")
    print(f"    passes: {[(p['rows'], p['steps'], p['host_syncs']) for p in passes]} (rows, AR steps, host syncs); "
          f"cell pass batch {run['cell_batch']}")
    print(f"    wall {wall:.4f} s, {wall / n:.4f} s/table; host enqueue of the passes "
          f"{sum(p['enqueue_s'] for p in passes):.4f} s of the wall [{power}]")
    if any(launches[k] for k in COUNTERS):
        raise AssertionError(f"the table-rec path launched {launches}")
    float32_against_cpu("table rec, one crop, the whole-table pass to 8 steps", TableRecPredictor, c,
                        np.stack([tab.prepare_image(crops[0].convert("RGB"))]), table_tokens)
    return tab


def recognized_tokens(pred, pages, bboxes):
    """Given-lines recognition; the token ids of every line, in order."""
    loop, runs = pred.prediction_loop, []

    def recording(*args, **kwargs):
        runs.append(loop(*args, **kwargs))
        return runs[-1]

    pred.prediction_loop = recording
    try:
        pred([p.copy() for p in pages], bboxes=bboxes)
    finally:
        del pred.prediction_loop
    return [list(map(int, t)) for run in runs for t in run[0]]


def check_two_predictors(pred, pages, bboxes, power):
    """Two RecognitionPredictors (each on its own stream, the same weights,
    the same pages and slot count) decoding at once in two threads give the
    token ids of the same two calls one after the other, and the decode
    kernel's merge counts are two buffers, one per stream."""
    set_pin(True)
    settings.RECOGNITION_MODEL_QUANTIZE = False
    pred2 = RecognitionPredictor(device="cuda")
    recognized_tokens(pred2, pages, bboxes)  # warm-up
    (seq, seq_wall) = synchronised(lambda: [recognized_tokens(p, pages, bboxes) for p in (pred, pred2)])
    out, errors = [None, None], []

    def work(i, p):
        try:
            out[i] = recognized_tokens(p, pages, bboxes)
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    reset_counts()
    threads = [threading.Thread(target=work, args=(i, p)) for i, p in enumerate((pred, pred2))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    launches = read_counts()
    n_slots = {key[2] for key in decode_attn._COUNTS}
    buffers = {key[1]: buf.data_ptr() for key, buf in decode_attn._COUNTS.items()
               if key[1] in (pred._stream.cuda_stream, pred2._stream.cuda_stream)}
    same = [a == b for a, b in zip(out, seq)]
    print(f"    two predictors in two threads: {sum(map(len, out))} lines, wall {wall:.4f} s (one after the other "
          f"{seq_wall:.4f} s); token ids equal to the sequential calls' for each: {same}; K3 launches "
          f"{launches['gqa_decode']}; merge-count buffers by stream {len(buffers)} ({len(set(buffers.values()))} "
          f"distinct, slot x kv-head sizes {sorted(n_slots)}) [{power}]")
    if not all(same) or len(out[0]) != len(pages) * LINES_PER_PAGE:
        raise AssertionError("two predictors decoding at once gave other token ids than one after the other")
    if len(buffers) != 2 or len(set(buffers.values())) != 2:
        raise AssertionError(f"the two predictors' streams do not have a merge-count buffer each: {buffers}")
    if launches["gqa_decode"] <= 0:
        raise AssertionError("the threaded run launched no K3")


def check_decode_on_two_streams(gen, power, reps=20):
    """K3 launched in turn on two streams with the same slot count, at a
    cache long enough (4096 rows, every split merged) that the calls of the
    two streams run at once on the card: every output must equal its plain
    version within the kernel tolerance. With one merge-count buffer for
    both, a split of one call could count the other's and merge partials
    not yet written; the two predictors of check_two_predictors launch
    their short calls too far apart to show that."""
    B, S, K, step = 129, 4096, 64, 63
    cases = []
    for _ in range(2):
        qd, (kc, vc), _, (ck, cv) = decode_inputs(gen, B, S, K, layers=1)
        args = (qd, kc, vc, to_cuda(np.full(B, S, np.int32)), ck, cv, step, 0)
        cases.append((torch.cuda.Stream(), args, decode_attn.gqa_decode_reference(*args).float()))
    torch.cuda.synchronize()
    outs = [[], []]
    t0 = time.perf_counter()
    for _ in range(reps):
        for (stream, args, _), out in zip(cases, outs):
            with torch.cuda.stream(stream):
                out.append(decode_attn.gqa_decode(*args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad, worst = 0, 0.0
    for (_, _, ref), out in zip(cases, outs):
        for o in out:
            err = (o.float() - ref).abs()
            bad += int((err > KERNEL_RTOL * ref.abs() + KERNEL_ATOL).any())
            worst = max(worst, err.max().item())
    print(f"    K3 on two streams in turn, {reps} calls each (B={B}, S={S}, every split merged): {2 * reps} calls in "
          f"{wall * 1e3:.2f} ms, {bad} outside the tolerance, max_abs_err {worst:.3e} [{power}]")
    if bad:
        raise AssertionError(f"{bad} K3 calls on two streams at once disagree with the plain version")


def projection_bytes(decoder) -> int:
    """Bytes of the decoder's seven projections a layer (weights, scales and
    biases): what a decode step streams for them."""
    return sum(t.numel() * t.element_size() for layer in decoder.layers for name in PROJECTIONS
               for m in [layer.get_submodule(name)] for t in (*m.parameters(), *m.buffers()))


def decode_step_ms(model, gen) -> float:
    """Device time of one decode step (all layers, the kernels' path) of the
    model at DECODE_STEP's shape, bf16 cache, from a CUDA-graph replay."""
    dec, dtype = model.config.decoder, model.token_embed.weight.dtype
    B, S, K, step, length = DECODE_STEP
    cache = qwen_decoder.init_cache(dec, B, S, dtype, "cuda")
    cache["len"].fill_(length)
    ck = torch.zeros((dec.num_hidden_layers, B, dec.num_key_value_heads, K, dec.head_dim), dtype=dtype, device="cuda")
    cv, emb, base = torch.zeros_like(ck), randn(gen, B, dec.hidden_size, scale=1.0).to(dtype), cache["len"].clone()
    with torch.inference_mode():
        return cuda_ms(lambda: model.decoder.decode_step_chunked(cache, ck, cv, emb, step, base), reps=10)


def greedy_decoder_tokens(model, device, steps=8):
    """Greedy token ids of the decoder alone (plain attention) over seeded
    random prompt embeddings: the prefill's token, then `steps` decode
    steps. Returns (tokens [B, steps + 1], the smallest top-2 logit gap)."""
    dec = model.config.decoder
    g = torch.Generator().manual_seed(SEED)
    B, L = 16, 32
    embeds = (torch.randn((B, L, dec.hidden_size), generator=g) * 0.5).to(device)
    seq_lens = torch.randint(8, L + 1, (B,), generator=g).to(device)
    tokens, gaps = [], []

    def sample(hidden):
        logits = (hidden @ model.token_embed.weight.T + model.lm_head_bias).float()
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        tokens.append(logits.argmax(-1))
        return tokens[-1]

    with torch.inference_mode():
        nk, nv, last = model.decoder.prefill(embeds, seq_lens, use_kernels=False)
        cache = qwen_decoder.init_cache(dec, B, 64, torch.float32, device)
        qwen_decoder.merge_prefill(cache, nk, nv, seq_lens, torch.arange(B, device=device))
        ck = torch.zeros((dec.num_hidden_layers, B, dec.num_key_value_heads, steps, dec.head_dim), device=device)
        cv, base = torch.zeros_like(ck), cache["len"].clone()
        token = sample(last)
        for step in range(steps):
            hidden = model.decoder.decode_step_chunked(cache, ck, cv, model.token_embed(token), step, base,
                                                       use_kernels=False)
            token = sample(hidden)
    return torch.stack(tokens, 1).cpu(), min(gaps)


def check_int8_weights(pred, det, pages, gen, power):
    """RecognitionPredictor with RECOGNITION_WEIGHT_QUANTIZE (int8 decoder
    projections) at production width, random bf16 weights from the seed of
    the bf16-weight predictor `pred` (the same weights, quantized): whole-page
    OCR of the 8 synthetic pages, pinned, with the bf16 and the int8 cache,
    in turns with `pred` (bf16, int8, int8, bf16 weights). Each run finds
    every line and decodes 40 tokens a line; the int8-weight runs launch K1,
    K2 and K3 (bf16 cache) or K3q (int8 cache). Prints walls, lines/s, the
    projections' bytes, the token agreement with the bf16-weight run (random
    weights flip near-ties, so it is printed only) and a decode step's device
    time with each weight type. Then the quantized decoder in float32 on the
    card (TF32 off) against the CPU at 2 layers: greedy token ids equal."""
    t0 = time.perf_counter()
    settings.RECOGNITION_WEIGHT_QUANTIZE = True
    try:
        qpred = RecognitionPredictor(device="cuda")
    finally:
        settings.RECOGNITION_WEIGHT_QUANTIZE = False
    swapped = [isinstance(layer.get_submodule(n), QuantLinear) for layer in qpred.model.decoder.layers
               for n in PROJECTIONS]
    if not all(swapped):
        raise AssertionError(f"{swapped.count(False)} decoder projections are not int8")
    q_bytes, b_bytes = projection_bytes(qpred.model.decoder), projection_bytes(pred.model.decoder)
    print(f"    int8-weight model built in {time.perf_counter() - t0:.1f} s: {len(swapped)} projections int8; "
          f"their bytes {q_bytes} against {b_bytes} in bf16 ({q_bytes / b_bytes:.4f})")
    set_pin(True)
    for cache in ("bf16", "int8"):
        settings.RECOGNITION_MODEL_QUANTIZE = cache == "int8"
        decode = "gqa_decode_int8" if cache == "int8" else "gqa_decode"
        for p in (pred, qpred):
            run_pages(p, det, pages, PIPELINE_PAGES)  # warm-up at these shapes
        walls, tokens = {"bf16": [], "int8": []}, {}
        for weights, p in [("bf16", pred), ("int8", qpred), ("int8", qpred), ("bf16", pred)]:
            reset_counts()
            results, wall, det_calls, tokens[weights] = run_pages(p, det, pages, PIPELINE_PAGES)
            launches = read_counts()
            n_l, n_t = check_lines(results, pages, OCR_LINES), sum(len(t) for t in tokens[weights])
            if n_t != PIN_TOKENS * n_l:
                raise AssertionError(f"{n_t} tokens for {n_l} lines, want {PIN_TOKENS} a line")
            walls[weights].append(wall)
            print(f"    {weights} weights, {cache} cache: {len(pages)} pages, {n_l} lines, {n_t} tokens; wall "
                  f"{wall:.4f} s (detection {sum(det_calls):.4f} s), {n_l / wall:.2f} lines/s [{power}]")
            if weights == "int8":
                assert_launched(f"int8 weights, {cache} cache", launches,
                                ["segmented_block_attention", "causal_flash_attention", decode],
                                ["gqa_decode" if cache == "int8" else "gqa_decode_int8"])
        same, same0, first = agreement(tokens["int8"], tokens["bf16"])
        print(f"    {cache} cache: int8 against bf16 weights, walls {' '.join(f'{w:.4f}' for w in walls['int8'])} "
              f"against {' '.join(f'{w:.4f}' for w in walls['bf16'])} s (ratio "
              f"of the means {np.mean(walls['int8']) / np.mean(walls['bf16']):.4f}); token ids {same:.4f} of the "
              f"lines the same, {same0:.4f} with the same token 0, the first difference at token {first} (median)")
    settings.RECOGNITION_MODEL_QUANTIZE = False
    b_ms, q_ms = decode_step_ms(pred.model, gen), decode_step_ms(qpred.model, gen)
    B, S, K, step, length = DECODE_STEP
    print(f"    one decode step, {B} slots, cache {S} rows ({length} valid), step {step} of {K}, device time: bf16 "
          f"weights {b_ms:.4f} ms, int8 weights {q_ms:.4f} ms ({q_ms / b_ms:.4f}x) [{power}]")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    config = qpred.config
    small = dataclasses.replace(config, encoder=dataclasses.replace(config.encoder, depth=1, fullatt_block_indexes=(0,)),
                                decoder=dataclasses.replace(config.decoder, num_hidden_layers=2))
    settings.RECOGNITION_WEIGHT_QUANTIZE = True
    try:
        gpu = random_model(small, "cuda", dtype=torch.float32)
        with torch.device("meta"):
            cpu = FoundationModel(small)
            qwen_decoder.quantize_weights(cpu.decoder)
        cpu = cpu.to_empty(device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        (tok_g, gap_g), (tok_c, gap_c) = greedy_decoder_tokens(gpu, "cuda"), greedy_decoder_tokens(cpu.eval(), "cpu")
    finally:
        settings.RECOGNITION_WEIGHT_QUANTIZE = False
        torch.backends.cuda.matmul.allow_tf32 = tf32
    same = int((tok_g == tok_c).sum())
    print(f"    int8-weight decoder, 2 layers, float32 on the card (TF32 off) against the CPU: {same} of "
          f"{tok_c.numel()} greedy token ids equal (smallest top-2 logit gap {gap_c:.3e} on the CPU, "
          f"{gap_g:.3e} on the card)")
    if same != tok_c.numel():
        raise AssertionError("the int8-weight decoder gives other token ids on the card than on the CPU")


def ocr_error_texts(rng):
    """OCR_ERROR_TEXTS texts a sequence bucket, in bucket order: texts of
    random words (each word one token of the hash vocabulary, plus CLS and
    SEP), so that each batch of 64 fills one bucket."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    texts, buckets = [], []
    for bucket, (lo, hi) in OCR_ERROR_WORDS.items():
        for _ in range(OCR_ERROR_TEXTS):
            n = int(rng.integers(lo, hi + 1))
            lengths = rng.integers(2, 9, n)
            chars = "".join(rng.choice(letters, int(lengths.sum())))
            ends = np.cumsum(lengths)
            texts.append(" ".join(chars[e - k:e] for e, k in zip(ends, lengths)))
            buckets.append(bucket)
    return texts, buckets


def check_ocr_error(power):
    """OCRErrorPredictor at full width (DistilBERT 6 layers, 768 wide, 12
    heads), random bf16 weights, on OCR_ERROR_TEXTS texts in each of the four
    sequence buckets: every text labelled, the batches at the expected rows
    and buckets, no hand-written kernel launched (the JAX package runs plain
    attention here). Then the model in float32 on the card (TF32 off)
    against the CPU on 4 texts a bucket: logits within LOGITS_REL_ERR of the
    largest. Returns the predictor."""
    t0 = time.perf_counter()
    oe = OCRErrorPredictor(device="cuda")
    c = oe.config
    print(f"    model built in {time.perf_counter() - t0:.1f} s: {c.n_layers} layers, dim {c.dim}, {c.n_heads} heads, "
          f"FFN {c.hidden_dim}, vocab {c.vocab_size}; batch {oe.get_batch_size()}; {oe.model.classifier.weight.dtype} "
          f"[{power}]")
    texts, buckets = ocr_error_texts(np.random.default_rng(SEED + 3))
    oe(texts)  # warm-up at these shapes
    reset_counts()
    result, wall = synchronised(oe, texts)
    launches = read_counts()
    rows = oe.get_batch_size()
    want = [(rows, b) for b in OCR_ERROR_WORDS for _ in range(-(-OCR_ERROR_TEXTS // rows))]
    if len(result.labels) != len(texts) or oe.last_run["batches"] != want:
        raise AssertionError(f"{len(result.labels)} labels for {len(texts)} texts in batches "
                             f"{oe.last_run['batches']}, want {want}")
    per_bucket = {b: {lab: sum(1 for x, y in zip(buckets, result.labels) if x == b and y == lab)
                      for lab in ("good", "bad")} for b in OCR_ERROR_WORDS}
    print(f"    {len(texts)} texts, batches (rows, bucket) {oe.last_run['batches']}; labels by bucket {per_bucket}; "
          f"wall {wall:.4f} s, {len(texts) / wall:.1f} texts/s [{power}]")
    if any(launches[k] for k in COUNTERS):
        raise AssertionError(f"the OCR error path launched {launches}")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = ocr_error_random_model(c, "cuda", dtype=torch.float32)
        cpu = DistilBert(c).eval()
        cpu.load_state_dict(gpu.state_dict())
        worst = 0.0
        for b in OCR_ERROR_WORDS:
            enc = oe.processor([t for t, x in zip(texts, buckets) if x == b][:4])
            ids = np.pad(np.asarray(enc["input_ids"], np.int32), ((0, 0), (0, b - len(enc["input_ids"][0]))))
            mask = np.pad(np.asarray(enc["attention_mask"], np.int32), ((0, 0), (0, b - len(enc["input_ids"][0]))))
            with torch.inference_mode():
                lg = gpu(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu()
                lc = cpu(torch.from_numpy(ids), torch.from_numpy(mask))
            worst = max(worst, float((lg - lc).abs().max() / lc.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"    float32 on the card (TF32 off) against the CPU, 4 texts a bucket: logits within {worst:.3e} of the "
          f"largest (limit {LOGITS_REL_ERR:.0e})")
    if not worst <= LOGITS_REL_ERR:
        raise AssertionError(f"the card's float32 logits are {worst:.3e} from the CPU's")
    return oe


def check_clis(pred, det, lay, tab, power):
    """The five CLIs on a folder of CLI_PAGES pages of bench.py's shape,
    each called in-process through its main(argv) with the predictors of
    the earlier phases wrapped in (the detector with the blob hook, the
    table recognizer with the synthetic tables, as the CPU tests wrap
    theirs), bf16 cache, 40 pinned tokens a line: each writes a
    results.json in the JAX CLIs' layout, and ocr_text and ocr_latex launch
    K1, K2 and K3. Then ocr_latex once more as a subprocess, `python -m
    surya_tpu_torch.scripts.ocr_latex`, with no wrapper (full width, random
    weights). ocr_text runs without --images: its text renderer fetches a
    font from the network."""
    set_pin(True)
    settings.RECOGNITION_MODEL_QUANTIZE = False
    built = {"DetectionPredictor": det, "RecognitionPredictor": pred, "LayoutPredictor": lay,
             "TableRecPredictor": tab}

    def check_rows(name, out):
        rows = json.loads((out / "pages" / "results.json").read_text())
        keys = CLI_KEYS[name]
        if list(rows) != [f"page_{i}" for i in range(CLI_PAGES)] or any(
                [r["page"] for r in v] != [1] or set(v[0]) != keys for v in rows.values()):
            raise AssertionError(f"{name}: results.json is not in the JAX layout: "
                                 f"{ {k: [sorted(r) for r in v] for k, v in rows.items()} }")
        return rows

    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "pages"
        folder.mkdir()
        for i, page in enumerate(bench_pages(CLI_PAGES)):
            page.save(folder / f"page_{i}.png")
        for name, (module, classes, extra, launched) in CLIS.items():
            saved = {cls: getattr(module, cls) for cls in classes}
            for cls in classes:
                setattr(module, cls, lambda *a, _p=built[cls], **k: _p)
            out = Path(tmp) / name
            reset_counts()
            try:
                _, wall = synchronised(module.main, [str(folder), "--output_dir", str(out), *extra])
            finally:
                for cls, fn in saved.items():
                    setattr(module, cls, fn)
            launches = read_counts()
            rows = check_rows(name, out)
            what = {"detect_text": lambda r: f"{len(r['bboxes'])} boxes",
                    "ocr_text": lambda r: f"{len(r['text_lines'])} lines",
                    "ocr_latex": lambda r: f"{len(r['equation'])} characters",
                    "detect_layout": lambda r: f"{len(r['bboxes'])} boxes",
                    "table_recognition": lambda r: f"{len(r['rows'])} rows, {len(r['cols'])} columns, "
                                                   f"{len(r['cells'])} cells"}[name]
            print(f"    {name} {' '.join(extra)}: {', '.join(what(v[0]) for v in rows.values())}; wall {wall:.4f} s "
                  f"for {CLI_PAGES} pages [{power}]")
            assert_launched(f"CLI {name}", {k: v for k, v in launches.items() if k != K1_BY_RANGE}, launched,
                            [k for k in COUNTERS if k not in launched])
        env = dict(os.environ, RECOGNITION_MAX_TOKENS=str(PIN_TOKENS), RECOGNITION_PIN_DECODE="true")
        out = Path(tmp) / "ocr_latex_subprocess"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "surya_tpu_torch.scripts.ocr_latex", str(folder),
                               "--output_dir", str(out)], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"python -m surya_tpu_torch.scripts.ocr_latex exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        rows = check_rows("ocr_latex", out)
        print(f"    python -m surya_tpu_torch.scripts.ocr_latex (a process of its own, full width, no wrapper): exit "
              f"0, {[len(v[0]['equation']) for v in rows.values()]} characters; wall {wall:.4f} s with the start, "
              f"the model build and the kernels' load [{power}]")


# -- checkpoints under the upstream key names ----------------------------------
# The round-trip phase (and tests/test_torch_checkpoint.py) writes a port model
# as upstream ships its checkpoint: the torch key names and layouts that the
# JAX package's convert_torch functions read (surya_tpu/models/*.py), stored
# in the model's own dtype (bf16 on the card), with a config.json in the JAX
# loaders' keys and the tokenizer files (a Qwen2 BPE for recognition, a
# WordPiece vocab.txt for OCR error).

_SWIN_NAMES = [  # DonutSwin encoder + ADETR decoder (layout and table rec)
    (r"^encoder\.patch_embed\.", "encoder.embeddings.patch_embeddings.projection."),
    (r"^encoder\.embed_norm\.", "encoder.embeddings.norm."),
    (r"^encoder\.position_embeddings$", "encoder.position_embeddings"),
    (r"^encoder\.stages\.(\d+)\.downsample\.", r"encoder.encoder.layers.\1.downsample."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.norm1\.", r"encoder.encoder.layers.\1.blocks.\2.layernorm_before."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.norm2\.", r"encoder.encoder.layers.\1.blocks.\2.layernorm_after."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.attn\.(query|key|value)\.",
     r"encoder.encoder.layers.\1.blocks.\2.attention.self.\3."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.attn\.proj\.", r"encoder.encoder.layers.\1.blocks.\2.attention.output.dense."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.attn\.rel_bias$",
     r"encoder.encoder.layers.\1.blocks.\2.attention.self.relative_position_bias_table"),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.mlp\.fc1\.", r"encoder.encoder.layers.\1.blocks.\2.intermediate.dense."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.mlp\.fc2\.", r"encoder.encoder.layers.\1.blocks.\2.output.dense."),
    (r"^decoder\.", "decoder.model."),
    (r"^embedder\.", "decoder.model.embed_tokens."),
    (r"^heads\.", "decoder.box_property_heads."),
    (r"^(pre_output_norm|lm_head|bbox_head)\.", r"decoder.\1."),
]
# port parameter name -> upstream key: the first rule that matches rewrites it
UPSTREAM_NAMES = {
    "detection": [
        (r"^stem\.in_conv\.", "vit.stem.in_conv."),
        (r"^stem\.(res\d+)\.", r"vit.stem.\1.main."),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.(?:down|fused|mb)\.", r"vit.stages.\1.blocks.\2.main."),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.vit\.attn\.aggreg_dw\.", r"vit.stages.\1.blocks.\2.context_module.main.aggreg.0.0."),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.vit\.attn\.aggreg_pw\.", r"vit.stages.\1.blocks.\2.context_module.main.aggreg.0.1."),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.vit\.attn\.", r"vit.stages.\1.blocks.\2.context_module.main."),
        (r"^stages\.(\d+)\.blocks\.(\d+)\.vit\.mlp\.", r"vit.stages.\1.blocks.\2.local_module.main."),
        (r"^head\.linear_c\.(\d+)\.", r"decode_head.linear_c.\1.proj."),
        (r"^head\.", "decode_head."),
    ],
    "recognition": [
        (r"^vision_encoder\.patch_embed\.weight$", "vision_encoder.patch_embed.proj.weight"),
        (r"^vision_encoder\.merger\.mlp(\d)\.", r"vision_encoder.merger.mlp.\1."),
        (r"^token_embed\.", "embedder.token_embed."),
        (r"^lm_head_bias$", "lm_head.bias"),
        (r"^(vision_encoder|decoder|img_w_embed|img_h_embed|bbox_head)\.", r"\1."),
    ],
    "layout": _SWIN_NAMES,
    "table_rec": _SWIN_NAMES,
    "ocr_error": [
        (r"^(word_embeddings|position_embeddings)\.", r"distilbert.embeddings.\1."),
        (r"^embed_layer_norm\.", "distilbert.embeddings.LayerNorm."),
        (r"^layers\.(\d+)\.(q_lin|k_lin|v_lin|out_lin)\.", r"distilbert.transformer.layer.\1.attention.\2."),
        (r"^layers\.(\d+)\.(lin1|lin2)\.", r"distilbert.transformer.layer.\1.ffn.\2."),
        (r"^layers\.(\d+)\.", r"distilbert.transformer.layer.\1."),
        (r"^(pre_classifier|classifier)\.", r"\1."),
    ],
}


def upstream_name(kind: str, name: str) -> str:
    for pattern, repl in UPSTREAM_NAMES[kind]:
        new, n = re.subn(pattern, repl, name, count=1)
        if n:
            return new
    raise KeyError(f"{kind}: no upstream key for the port's parameter {name}")


def swin_relative_position_index(window: int) -> torch.Tensor:
    """A Swin block's relative_position_index buffer (the loaders recompute it)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def upstream_state_dict(kind: str, model, config, gen: torch.Generator) -> dict:
    """The port `model` of `kind` as upstream's torch state dict: CPU tensors
    in the model's dtype under the upstream keys and layouts (the Conv3d
    patch embed, the [1, L, D] position embeddings, the Swin index buffers).
    A folded batch-norm is written as weight, bias, running_mean,
    running_var and num_batches_tracked: its scale and bias as weight and
    bias, random statistics (var in [0.5, 1.5)) drawn from `gen`. The fold
    cannot be inverted, so the model's folded scale and bias are then set,
    in place, to the fold of what was written (the loaders' arithmetic): the
    model is the one the checkpoint holds."""
    out = {}
    norms = {n: m for n, m in model.named_modules() if isinstance(m, pnn.FoldedBatchNorm)}
    for name, bn in norms.items():
        up = upstream_name(kind, f"{name}.weight").removesuffix(".weight")
        eps = 1e-5 if name == "head.batch_norm" else config.layer_norm_eps  # as efficientvit.convert_torch
        n, dt = bn.weight.numel(), bn.weight.dtype
        stats = (torch.randn(n, generator=gen, device=gen.device) * 0.1).to(dt), \
            (torch.rand(n, generator=gen, device=gen.device) + 0.5).to(dt)
        written = [t.detach().cpu().clone() for t in (bn.weight, bn.bias, *stats)]
        out.update(zip((f"{up}.weight", f"{up}.bias", f"{up}.running_mean", f"{up}.running_var"), written))
        out[f"{up}.num_batches_tracked"] = torch.tensor(0)
        folded = fold_batchnorm(*(t.float().numpy() for t in written), eps=eps)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(folded["scale"]))
            bn.bias.copy_(torch.from_numpy(folded["bias"]))
    skip = {f"{n}.{p}" for n in norms for p in ("weight", "bias")}
    for name, t in model.state_dict().items():
        if name in skip:
            continue
        t = t.detach().cpu()
        if kind == "recognition" and name == "vision_encoder.patch_embed.weight":
            e = config.encoder  # [out, in*t*p*p] -> the Conv3d's [out, in, t, p, p]
            t = t.reshape(t.shape[0], e.in_channels, e.temporal_patch_size, e.patch_size, e.patch_size)
        elif name == "encoder.position_embeddings":
            t = t[None]
        out[upstream_name(kind, name)] = t.clone()
    if kind in ("layout", "table_rec"):
        for i, depth in enumerate(config.encoder.depths):
            for b in range(depth):
                out[f"encoder.encoder.layers.{i}.blocks.{b}.attention.self.relative_position_index"] = \
                    swin_relative_position_index(config.encoder.window_size)
    return out


def upstream_config(kind: str, config) -> dict:
    """config.json in the keys the JAX package's loaders read."""
    c = dataclasses.asdict(config)
    if kind == "detection":
        c["image_size"] = {"height": config.image_size[0], "width": config.image_size[1]}
    elif kind == "recognition":
        c["vision_encoder"] = c.pop("encoder")
        c["special_ocr_tokens"] = DEFAULT_SPECIAL_TOKENS
    elif kind == "layout":
        c["decoder"].update(vocab_size=config.vocab_size, bbox_size=config.bbox_size,
                            skew_scaler=config.skew_scaler, label_count=config.label_count)
    elif kind == "table_rec":
        c["decoder"].update(property_embed_size=config.property_embed_size, box_embed_size=config.box_embed_size)
    return c


def write_qwen2_tokenizer(path: Path) -> None:
    """A byte-level BPE in Qwen2's files (vocab.json, merges.txt) that
    ``transformers.Qwen2Tokenizer`` loads offline: the 248 byte values UTF-8
    uses, 7 merges and <|endoftext|>, 256 entries in all, so that the OCR
    tokenizer's ids are those of the random-weight byte fallback."""
    printable = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    rest = [b for b in range(256) if b not in printable]
    char = {b: chr(b) for b in printable} | {b: chr(256 + i) for i, b in enumerate(rest)}  # GPT-2's byte map
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"), ("o", "n")]
    tokens = [char[b] for b in range(0xF8)] + [a + b for a, b in merges] + ["<|endoftext|>"]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}, ensure_ascii=False),
                                     encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")


def write_wordpiece_vocab(path: Path, size: int) -> None:
    """A WordPiece vocab.txt of `size` lines in BERT's layout ([PAD] 0, [UNK]
    100, [CLS] 101, [SEP] 102, [MASK] 103): letters, digits and punctuation,
    the same as ## pieces, then unused slots."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,;:!?'\"()-")
    tokens = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              *chars, *("##" + c for c in chars)]
    tokens += [f"[unused{i}]" for i in range(99, 99 + size - len(tokens))]
    (path / "vocab.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")


def write_checkpoint(path: Path, kind: str, model, config, gen: torch.Generator) -> int:
    """Write `model` (of `kind`) into `path` as an upstream checkpoint
    directory: model.safetensors, config.json and the tokenizer files.
    Returns the safetensors file's size in bytes."""
    from safetensors.torch import save_file

    path.mkdir(parents=True, exist_ok=True)
    save_file(upstream_state_dict(kind, model, config, gen), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(upstream_config(kind, config)))
    if kind == "recognition":
        write_qwen2_tokenizer(path)
    elif kind == "ocr_error":
        write_wordpiece_vocab(path, config.vocab_size)
    return (path / "model.safetensors").stat().st_size


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().contiguous().flatten().view(torch.uint8), b.detach().contiguous().flatten().view(torch.uint8))


def check_checkpoints(pred, det, lay, tab, oe, power):
    """The checkpoint round trip at full width. Each of the five models of
    the earlier phases (random bf16 weights on the card) is written as an
    upstream checkpoint directory (upstream key names and layouts, bf16
    storage, config.json, tokenizer files; ``write_checkpoint``), and its
    predictor is built from that directory twice: the first build converts
    and writes the converted-weight cache, the second reads the cache. Every
    parameter of both must equal the source model's bit for bit, and the
    outputs must equal the source predictor's: the token ids of 8 whole
    pages of bench.py's shape (bf16 cache, pinned, through the detection
    predictor above), on which the checkpoint-loaded recognition predictor
    must launch K1, K2 and K3; detection's heatmaps; layout's boxes
    (cap-bound) and table recognition's (synthetic tables); OCR error's
    labels. The directory is deleted at the end."""
    settings.RECOGNITION_WEIGHT_QUANTIZE = settings.RECOGNITION_MODEL_QUANTIZE = False
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    root = Path(tempfile.mkdtemp(prefix="surya_checkpoints_"))
    sources = {"recognition": (pred, RecognitionPredictor), "detection": (det, DetectionPredictor),
               "layout": (lay, LayoutPredictor), "table_rec": (tab, TableRecPredictor),
               "ocr_error": (oe, OCRErrorPredictor)}
    loaded = {}
    try:
        for kind, (src, cls) in sources.items():
            path = root / kind
            t0 = time.perf_counter()
            size = write_checkpoint(path, kind, src.model, src.config, gen)
            t_write = time.perf_counter() - t0
            first, t_first = synchronised(cls, str(path))
            cache = cache_path(str(path), kind, next(src.model.parameters()).dtype)
            if not cache.exists():
                raise AssertionError(f"{kind}: no converted-weight cache at {cache}")
            second, t_second = synchronised(cls, str(path))
            want = src.model.state_dict()
            for label, p in (("converted", first), ("cached", second)):
                got = p.model.state_dict()
                bad = [k for k in want if k not in got or not bitwise_equal(got[k], want[k])]
                if list(got) != list(want) or bad or p.config != src.config:
                    raise AssertionError(f"{kind}, {label}: {len(bad)} tensors differ from the source model, "
                                         f"e.g. {bad[:3]}; config equal: {p.config == src.config}")
            n = sum(t.numel() for t in want.values())
            print(f"    {kind}: {len(want)} tensors, {n} parameters; {size / 1e6:.1f} MB of safetensors "
                  f"written in {t_write:.2f} s; built from the checkpoint in {t_first:.2f} s (conversion and "
                  f"the cache's write), from the cache ({cache.stat().st_size / 1e6:.1f} MB) in {t_second:.2f} s; "
                  f"every parameter of both bitwise equal to the source [{power}]")
            loaded[kind] = first
            del second

        pages = bench_pages(OCR_PAGES)
        set_pin(True)
        _, wall_src, _, want = run_pages(pred, det, pages, 0)
        reset_counts()
        _, wall_ck, _, got = run_pages(loaded["recognition"], det, pages, 0)
        counts = read_counts()
        print(f"    recognition, {OCR_PAGES} whole pages of 1240x1754 (bf16 cache, pinned {PIN_TOKENS}): {len(got)} "
              f"lines, {sum(map(len, got))} tokens; source {wall_src:.3f} s, checkpoint-loaded {wall_ck:.3f} s "
              f"[{power}]")
        assert_launched("checkpoint-loaded recognition", counts, RECOGNITION_KERNELS, ["gqa_decode_int8"])
        if got != want or not got:
            same = sum(a == b for a, b in zip(got, want))
            raise AssertionError(f"token ids differ from the source predictor's: {same} of {len(want)} lines equal")
        set_pin(False)

        x = torch.from_numpy(np.stack([det.prepare_image(p.convert("RGB")) for p in pages[:4]]))
        x = x.cuda().permute(0, 3, 1, 2).to(det.dtype) / 255.0
        with torch.inference_mode():
            heat, heat_ck = det.model.apply_heat(x), loaded["detection"].model.apply_heat(x)
        if not torch.equal(heat, heat_ck):
            raise AssertionError(f"detection heatmaps differ by {(heat - heat_ck).abs().max().item():.3e}")

        llay = loaded["layout"]
        capped = dataclasses.replace(lay.config, eos_token_id=-1, pad_token_id=-1)
        tiles, _ = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE).slice([pages[0]])
        tile_pixels = torch.from_numpy(np.stack([lay.prepare_image(t) for t in tiles])).cuda()
        lay.model.config = llay.model.config = capped
        try:
            boxes, boxes_ck = (p([q.copy() for q in pages[:2]]) for p in (lay, llay))
            with torch.inference_mode():  # the box loop's raw outputs: boxes, class logits, valid flags
                steps, steps_ck = (p._generate(tile_pixels, DoneWatch(p.device)) for p in (lay, llay))
        finally:
            lay.model.config, llay.model.config = lay.config, llay.config
        if [r.model_dump() for r in boxes] != [r.model_dump() for r in boxes_ck] or not torch.equal(steps, steps_ck):
            raise AssertionError("layout boxes differ from the source predictor's")

        install_synthetic_tables(loaded["table_rec"], TABLE_ROWS, TABLE_COLS, TABLE_CELLS)
        crops = [p.crop((100, 100, 868, 868)) for p in pages[:TABLE_CROPS]]
        tables, tables_ck = (p([c.copy() for c in crops]) for p in (tab, loaded["table_rec"]))
        if [r.model_dump() for r in tables] != [r.model_dump() for r in tables_ck]:
            raise AssertionError("table recognition's boxes differ from the source predictor's")

        texts = ocr_error_texts(np.random.default_rng(SEED + 6))[0][:OCR_ERROR_TEXTS]
        oe.processor = WordPieceTokenizer.from_pretrained(str(root / "ocr_error"))  # the checkpoint's vocab.txt
        labels, labels_ck = (p(texts).labels for p in (oe, loaded["ocr_error"]))
        if labels != labels_ck:
            raise AssertionError("OCR error labels differ from the source predictor's")
        print(f"    outputs equal to the source predictors': detection heatmaps {tuple(heat.shape)}; layout "
              f"{sum(len(r.bboxes) for r in boxes)} boxes on 2 pages and the box loop's {int(steps[..., -1].sum())} "
              f"valid steps of {len(tiles)} tiles (cap-bound); {len(tables)} tables of "
              f"{[len(r.cells) for r in tables]} cells; {len(labels)} OCR error labels; the phase "
              f"{time.perf_counter() - t_phase:.1f} s [{power}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def assert_launched(label, run_counts, launched, not_launched=()):
    print(f"    {label}: {run_counts}")
    for n in launched:
        if run_counts[n] <= 0:
            raise AssertionError(f"{n} was never launched in the {label} run")
    for n in not_launched:
        if run_counts[n]:
            raise AssertionError(f"{n} was launched {run_counts[n]} times in the {label} run")


def main():
    name = torch.cuda.get_device_name(0)
    power = card()
    print(f"[1] card: {power}")
    lib = _build.library()
    steps = ", ".join(f"{n} {s:.1f} s" for n, s in lib.step_seconds.items())
    print(f"    kernels built in {lib.build_seconds:.1f} s (nvcc processes: {steps}; their sum "
          f"{sum(lib.step_seconds.values()):.1f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())

    print("[2] kernels vs plain versions at the given-lines shapes (bf16, CUDA events)")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # K1 over the given-lines wave (32 lines), K2 at its prefill (32 rows,
    # bucket 128) and at the largest bucket; K3 and K3q
    grids = [(h // 14, w // 14) for h, w in LINE_SHAPES] * N_PAGES
    cap = 4096
    while cap < sum(a * b for a, b in grids):
        cap *= 2
    check_segmented(results, plan_layout(grids, EncoderConfig(**DEFAULT_ENCODER), cap), gen, "given lines")
    check_segmented_edges(gen)
    for B, L in [(32, 128), (2, 1536)]:
        check_causal(results, B, L, gen)
    long_cache = check_decode(results, gen)

    print("[3] RecognitionPredictor at production width, random bf16 weights, given line boxes")
    t0 = time.perf_counter()
    pred = RecognitionPredictor(device="cuda")
    print(f"    model built in {time.perf_counter() - t0:.1f} s")
    pages, bboxes = synthetic_pages(np.random.default_rng(SEED))
    run_predictor(pred, pages[:1], bboxes[:1], pin=True)  # warm-up (cuBLAS, allocator)
    counts, shapes = {}, {}
    for label, pin in [("pinned 40", True), ("free-running", False)]:
        reset_counts()
        with DecodeShapes() as rec:
            wall, n_l, n_t = run_predictor(pred, pages, bboxes, pin=pin)
        if pin:
            shapes["gqa_decode"] = rec.first["gqa_decode"]
        counts[label] = read_counts()
        if pin and n_t != PIN_TOKENS * N_PAGES * LINES_PER_PAGE:
            raise AssertionError(f"pinned run decoded {n_t} tokens, want {PIN_TOKENS} per line")
        print(f"    {label}: {wall:.3f} s wall, {n_l / wall:.2f} lines/s, {n_t} tokens, "
              f"{n_t / wall:.1f} decoded tokens/s [{power}]")

    print("[4] kernel launches in each predictor run")
    for label, run_counts in counts.items():
        assert_launched(label, run_counts, ["segmented_block_attention", "causal_flash_attention", "gqa_decode"],
                        ["gqa_decode_int8"])
        by_range = run_counts[K1_BY_RANGE]
        if sum(by_range.values()) != run_counts["segmented_block_attention"]:
            raise AssertionError(f"K1 launches by kv_range {by_range} do not add up")

    print("[5] kernels vs plain versions inside the model")
    for quantize in (False, True):
        check_model_paths(pred, pred.slice_bboxes(pages[:1], ["ocr_with_boxes"], bboxes=bboxes[:1]), quantize)

    print("[6] whole-page OCR at production width, int8 KV cache: DetectionPredictor -> RecognitionPredictor")
    t0 = time.perf_counter()
    det = DetectionPredictor(device="cuda")
    install_blob_detector(det)
    print(f"    detection model built in {time.perf_counter() - t0:.1f} s")
    settings.RECOGNITION_MODEL_QUANTIZE = True
    ocr_pages = synthetic_full_pages(np.random.default_rng(SEED + 1))
    run_full_page(pred, det, ocr_pages, pin=True)  # warm-up at the measured shapes (cuDNN, cuBLAS, allocator)
    for label, pin in [("whole-page pinned 40", True), ("whole-page free-running", False)]:
        reset_counts()
        with DecodeShapes() as rec:
            det_wall, rec_wall, n_l, n_t = run_full_page(pred, det, ocr_pages, pin=pin)
        if pin:
            shapes["gqa_decode_int8"] = rec.first["gqa_decode_int8"]
        counts[label] = read_counts()
        if pin and n_t != PIN_TOKENS * n_l:
            raise AssertionError(f"pinned run decoded {n_t} tokens for {n_l} lines, want {PIN_TOKENS} per line")
        wall = det_wall + rec_wall
        print(f"    {label}: {OCR_PAGES} pages, {n_l} lines, {n_t} tokens; detection {det_wall:.3f} s, "
              f"recognition {rec_wall:.3f} s; {OCR_PAGES / wall:.2f} pages/s, {n_l / wall:.2f} lines/s [{power}]")
        assert_launched(label, counts[label],
                        ["segmented_block_attention", "causal_flash_attention", "gqa_decode_int8"], ["gqa_decode"])

    print("[7] kernels vs plain versions at the whole-page wave's shapes, and inside the model with the int8 cache")
    flat = pred.detect_and_slice_bboxes([p.copy() for p in ocr_pages], ["ocr_with_boxes"] * OCR_PAGES, det)
    batch, n_lines = first_wave(pred, flat)
    if n_lines != OCR_PAGES * OCR_LINES or counts["whole-page pinned 40"]["segmented_block_attention"] != \
            pred.config.encoder.depth:
        raise AssertionError(f"the whole-page lines ({n_lines}) did not run as one prefill wave")
    check_segmented(results, batch.layout, gen, "whole page", report=True)
    check_causal(results, *batch.input_ids.shape, gen, report=True)
    check_model_paths(pred, flat, quantize=True)
    settings.RECOGNITION_MODEL_QUANTIZE = False

    print("[8] K3 and K3q at the shapes the pinned runs gave them (K3: given lines, K3q: whole page)")
    check_decode_main_path(results, gen, shapes, long_cache)

    north_pages = synthetic_full_pages(np.random.default_rng(SEED + 2), NORTH_STAR_PAGES)
    print("[9] detection on the card: device resize and component stats (auto) against the host path")
    check_detection(det, north_pages, power)
    print(f"[10] whole-page OCR at the north star's shape: {NORTH_STAR_PAGES} pages, int8 cache, pinned "
          f"{PIN_TOKENS} tokens, streaming against sequential")
    batch_results = check_north_star(pred, det, north_pages, power)
    print("[11] the recognition dispatch path under torch.cuda.set_sync_debug_mode(\"error\")")
    check_sync_free_dispatch(pred, det, north_pages, power)
    print(f"[12] stream() over a generator of the {NORTH_STAR_PAGES} pages")
    check_stream(pred, det, north_pages, batch_results, power)
    settings.RECOGNITION_MODEL_QUANTIZE = False
    set_pin(False)

    layout_pages = bench_pages(LAYOUT_PAGES)
    print(f"[13] layout analysis at full width, random bf16 weights: {LAYOUT_PAGES} pages of 1240x1754")
    lay = check_layout(layout_pages, power)
    print(f"[14] table recognition at full width, random bf16 weights, synthetic {TABLE_ROWS} x {TABLE_COLS} "
          f"tables: {TABLE_CROPS} crops of 768x768")
    tab = check_table_rec(layout_pages, power)
    print("[15] two RecognitionPredictors decoding at once in two threads, against one after the other")
    check_two_predictors(pred, pages, bboxes, power)
    check_decode_on_two_streams(gen, power)
    set_pin(False)
    print(f"[16] int8 decoder weights (RECOGNITION_WEIGHT_QUANTIZE) at production width: whole-page OCR of "
          f"{OCR_PAGES} pages, bf16 and int8 cache, against bf16 weights")
    check_int8_weights(pred, det, ocr_pages, gen, power)
    print(f"[17] OCR error detection at full width, random bf16 weights: {OCR_ERROR_TEXTS} texts in each of the "
          f"sequence buckets {list(OCR_ERROR_WORDS)}")
    oe = check_ocr_error(power)
    print(f"[18] the five CLIs on {CLI_PAGES} pages of 1240x1754, then ocr_latex as a process of its own")
    check_clis(pred, det, lay, tab, power)
    set_pin(False)
    print("[19] checkpoint round trip at full width: the five models written as upstream checkpoints (bf16), "
          "their predictors built from them twice (conversion, then the cache)")
    check_checkpoints(pred, det, lay, tab, oe, power)

    # launches: the pinned run of each kernel's path (K3, bf16 cache: given
    # lines; the others: whole-page OCR, int8 cache). K1's full-attention and
    # windowed blocks differ in window length (the wave's plan has both).
    page = counts["whole-page pinned 40"]
    lay = batch.layout
    if lay.kv_range == lay.win_range:
        raise AssertionError("the whole-page plan's full and window ranges coincide: launches cannot be split")
    launches = {
        "segmented_block_attention[full]": page[K1_BY_RANGE].get(lay.kv_range, 0),
        "segmented_block_attention[window]": page[K1_BY_RANGE].get(lay.win_range, 0),
        "causal_flash_attention": page["causal_flash_attention"],
        "gqa_decode": counts["pinned 40"]["gqa_decode"],
        "gqa_decode_int8": page["gqa_decode_int8"],
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "main_path", "by_step",
            "long_cache")
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": launches[n],
         **{key: results[n][key] for key in keys if key in results[n]}}
        for n, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
