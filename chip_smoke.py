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
  lengths, cache rows S and chunk columns K, recorded by a stand-in for
  ``FoundationModel.launch_chunk`` in this script), at steps 0, K/2 - 1 and
  K - 1;
- runs detection of 16 such pages with the device resize and the component
  stats on the card (their auto setting) and holds the boxes against the
  host path's (PIL, maps, the C++ CRAFT op) by the IoU rule of
  tests/test_device_postprocess.py, and one batch's resized pixels against
  PIL's double LANCZOS;
- drives whole-page OCR of 16 of those synthetic pages (int8 cache, 40
  pinned tokens a line, 64-step chunks) through the streaming det->rec
  path, the same with every output read after a device synchronise, and
  sequentially: the same lines and token counts, at least 95 % of the
  lines with the same token ids between the pipelined and the synchronised
  reads, K1, K2 and K3q launched;
- runs one whole-page call with the recognition dispatches under
  ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host sync), and
  ``stream()`` over a generator of the 16 pages (in order, the batch call's
  lines);
- drives ``LayoutPredictor`` at the JAX package's full width (DonutSwin
  768x768, depths (2, 2, 16, 2); ADETR 8 layers, 1024 wide) with random bf16
  weights over 16 pages of bench.py's shape (1240x1754, two tiles each), as
  called and cap-bound (no class taken for EOS or PAD, so every row decodes
  its 100 steps), printing each dispatch's AR steps and the host enqueue
  time against the wall; and ``TableRecPredictor`` at full
  width with ``install_synthetic_tables`` (14 rows x 8 columns) over 4 crops
  of 768x768, whose rows, columns and recorded steps must be the script's.
  Neither path runs a hand-written kernel (the JAX package runs no Pallas
  kernel there), and neither launches one. Each model is also run in
  float32 on the card (TF32 off) and on the CPU with the same weights: the
  encoder outputs within relative error 1e-3;
- runs two ``RecognitionPredictor``s, each on its own stream, in two
  threads on the same given-lines pages: the token ids must equal those of
  the same two calls one after the other; and K3 on two streams in turn,
  4 slots of a 2048-row cache in clusters, so that calls of both run at
  once, each within tolerance of its plain version;
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
  K1, K2 and K3; each write and load timed;
- (phases 20 to 23) the mesh (surya_tpu_torch/parallel/mesh.py) on logical
  meshes of cuda:0 (a device repeated): given-lines recognition, pinned, on
  2x2, 1x2 and 2x1 meshes with the bf16 and the int8 KV cache, on the
  unsharded predictor's weights; each mesh wrapper of the path (K1-mesh on
  the 1x2 mesh, K2-mesh and K3-mesh or K3q-mesh on all) launched on every
  shard, nothing through the gathered path, no plain version on the card;
  the wall and the launches a decode step against the unsharded run's, the
  token agreement with it (printed only); the first wave's prefill and one
  decode step held against the unsharded path by relative error, as phase 5
  holds the kernels. Then the three wrappers on a 2x2 logical mesh at the
  shapes those runs gave them, each held against its plain version on the
  gathered inputs and timed a shard beside one shard's bound, plain version
  and library call; detection, layout, table recognition and OCR error on a
  2x1 logical mesh against the unsharded predictors; and, on a machine of
  more than one card, the recognition meshes and the batch predictors'
  2x1 mesh over distinct cards (a line says when that is not run). A logical mesh measures the sharded code
  path, not multi-card scaling;
- (phase 24) the web server, ``surya_tpu_torch.scripts.web_app``: a
  ``make_server(port=0)`` whose registry holds the predictors above (the
  detector with the blob hook, recognition with the bf16 cache and 40
  pinned tokens, layout, table rec with the synthetic tables, OCR error),
  served from a thread; a client posts detect, ocr (with detection and
  with ``skip_text_detection``), layout, and table (over the whole image
  and driven by layout) on 2 PNG pages of bench.py's shape, twice each:
  every answer's result equals the same predictor's direct call, the ocr
  requests launch K1, K2 and K3 (no K3q) and the others launch none, and
  the handler threads' decode-chunk replays run on recognition's stream;
  ``GET /``, ``/healthz``, an unknown action (404) and ``ocr_error`` on an
  image (400); four ocr requests at once each answered with the sequential
  result; ten warm ocr requests with the same ``memory_allocated`` after
  the 2nd and the 10th, and no module output carrying a grad_fn in any
  request from the first (whose captures run the modules in Python; a
  warm ocr request only replays graphs); a PDF
  through detect where pypdfium2 imports; then ``python -m
  surya_tpu_torch.scripts.web_app --port 0`` as a process of its own (full
  width, random weights, build directories of its own): its URL line,
  ``/healthz`` and one ocr page, no traceback on its stderr. Each action's
  first and median warm request walls are printed beside the direct call's;
- (phase 25) ``streamlit_app.main()`` and ``texify_app.run()`` under a
  stub streamlit module, every button pressed and one page uploaded, on
  the predictors above: both run to completion and launch K1, K2 and K3.
- (phase 26) bench.py's workload through the port, copied part for part
  from bench.py: its environment (random weights, 40 pinned tokens a line,
  a 40-step decode chunk, the bf16 KV cache), read into the settings before
  a new ``DetectionPredictor()`` (with the blob hook) and
  ``RecognitionPredictor()`` are built at full width; 16 pages of its
  ``build_page()`` (1240x1754, 40 lines at ``font_size=22``; a Pillow that
  cannot draw at a size fails the phase); its warm-ups, then the best of 3
  ``rec(pages, det_predictor=det)`` trials. Every trial must launch K1, K2
  and K3 and never K3q, find on every page the warm-up detection's line
  count and decode exactly 40 tokens a line. One line, ``BENCH_WORKLOAD
  {...}``, gives the best trial's pages/s, the three walls, boxes and
  tokens a page, its ``common/profiling`` stage split, its launches and the
  card, one more trial's device busy share under ``torch.profiler``; the
  same for 3 trials with the programs eager and the loops graphed
  (``programs_eager``: the AR loops alone graphed) and for 3 with everything plain
  (``plain``), each trial's launches equal to the graphed trials'; then
  K1, K2 and K3 are held against their plain versions at the shapes of the
  first wave and first decode call of a warm-up whose prefill ran eagerly,
  and the kernels line carries those times and the best graphed trial's
  launches under ``bench_workload``.
- (phase 27) the checkpoint-validation command,
  ``surya_tpu_torch.scripts.validate_checkpoints``, and its six accuracy
  stages (``surya_tpu_torch/benchmark``): (a) ``main()`` over all six
  gates on checkpoint directories written from the detection, recognition,
  layout and table rec models above, with the settings read anew
  (ALLOW_RANDOM_WEIGHTS off, no token cap) and each stage's
  ``load_hf_dataset`` replaced by 2 in-memory rows of the port's synthetic
  pages: random weights fail the gates, so it must exit with "gates
  failed", every gate "below threshold" or "pass" and never an error, the
  six result files with the JAX stages' keys; recognition and texify launch
  K1, K2 and K3 and no K3q, the other four stages no kernel; (b) ``python
  -m surya_tpu_torch.scripts.validate_checkpoints --smoke --max_rows 2`` as
  a process of its own: exit 0, "smoke run complete", detection,
  recognition and table recognition "below threshold" or "pass", the other
  three "skipped".
- (phase 28) the AR loops as the predictors run them on the card, a CUDA
  graph replay whose steps sit in IF nodes (``common/graphs.py``), against
  their eager loop (the same step function, the cond read on the host) on
  the same inputs: recognition's decode chunk at production width from a
  random cache of 129 slots (bf16 cache pinned and free-running, a wave
  whose every slot stops at its first step, the int8 cache, int8 weights),
  and from 9 slots of a 1536-row cache, bf16 and int8, where each (slot,
  kv head) is a cluster of K3's CTAs, twice each; layout of the 16 pages as called and cap-bound; table rec of
  the synthetic tables. Token ids, classes, valid flags, cache lengths and
  the steps run must be equal; score and box differences, the cache's
  bytes, each graph's capture time and memory pool are printed. Then whole
  recognition calls whose cache lengths alternate (three lengths in turn,
  then a longer one, then all four in turn) from an empty slot-cache store:
  each length captured once while the store is long enough, the longer one
  replacing the store and its graphs once (7 captures in all).
- (phase 29) the one-shot programs as the predictors run them on the card,
  CUDA graph replays (``common/graphs.ProgramGraphs``), against their plain
  version (``graphs.EagerPrograms``) on the same inputs, each twice: the
  detection stats program with and without the device resize on 4 pages of
  ``build_page()`` and on a page whose one line is a spiral, the maps
  program, and the component flood alone on the spiral's mask (its loop a
  WHILE node: as many blocks of rounds as the host loop); recognition's
  prefill wave of 2 pages' lines into a 129-slot cache whose other slots
  decode, alone and fused with its decode chunk, pinned and free-running;
  and whole-page OCR through the streaming path whose second page group has
  another page size, so that the detection worker thread captures while the
  main thread replays. Every output must be equal (labels, stats, counts,
  thresholds, token ids, scores, boxes, slot state, cache bytes); each
  key's capture time and reserved memory, and the keys the whole-page
  phases and phase 26 captured, are printed.

The random-weight phases point the five ``*_MODEL_CHECKPOINT`` settings at
a path that does not exist, so that no predictor resolves or fetches a
default ``s3://`` checkpoint, and the OCR render's font fetch at a refused
loopback port. The exporter (``upstream_state_dict``,
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
with its own launches; for each plan, and for the K1-mesh shard, the
script prints K1's launch (CTAs, threads, K/V stages, shared memory, CTAs
an SM, and the registers and spills ptxas gave it) and the query-key pairs
K1 computes after skipping the key tiles outside its warpgroups' spans
(modelled from the kernel's span rule) against the pairs the plan needs.
K1 is also held against its plain version where no layout plan takes it:
query rows outside their window, clamped window starts, and a window that
is no multiple of its 64-key tile.

The kernels line also lists the three mesh wrappers (K3-mesh twice, bf16
and int8 cache), each with its launches in the meshed run of its path and by
shard, and its times a shard.

Exits non-zero on any failure and when no CUDA device is present. Prints the
card's name and power limit, one JSON line with the kernels' results, and as
its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --lfm2

holds what LFM2-8B-A1B's decoder adds against plain versions at its widths
(K2 and K3 at head dim 64 with 4 query heads a kv head, the sparse-expert
layer at a decode step's and a prefill wave's tokens; each of its four
glue kernels against its plain function on the same inputs), times them
(the layer also on its plain path, and each glue kernel alone beside its
bound and its plain function), prints the device work of one layer call,
which must be those four kernels and the two grouped GEMMs (each
``prepare_grouped_gemm_data`` and CUTLASS's kernel: eight launches),
counts each glue kernel's launches over a call of the recognition
predictor with the whole decoder replayed from its CUDA graphs (equal to
the sparse layer calls, 22 a decoder pass), and prints one
``LFM2_SMOKE`` JSON line. With ``--tree DIR`` it
times another tree's layer (an unpacked parent: its glue as PyTorch
launches).

    python3 chip_smoke.py --kernels [--tree DIR]

holds the kernels against their plain versions and times them at fixed
main-path shapes only (K1 over a whole-page-like plan, K2 at 128 x 128 and
its mesh shard, K3 and K3q at main-path-like lengths, the long cache, the
mesh shard, and the caches recognition sizes for fewer slots), through the
wrappers' public calls, and prints their times as one ``KERNELS_AB`` JSON
line. With ``--tree DIR`` it imports the port from DIR (an unpacked other
commit, for example the parent, or a copy of kernel_variants.py's), so two
trees can be timed in turns in one process each on one card; that tree's
decode launches are then not held to this file's cluster rule.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import ctypes
import dataclasses
import gc
import importlib
import io
import json
import os
import re
import select
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

# the five checkpoint settings; the random-weight phases point them at a path
# that does not exist, so that no predictor resolves (or fetches) a default
# s3:// checkpoint, nor the process that phase 18 starts
CHECKPOINT_SETTINGS = ("DETECTOR_MODEL_CHECKPOINT", "RECOGNITION_MODEL_CHECKPOINT", "LAYOUT_MODEL_CHECKPOINT",
                       "TABLE_REC_MODEL_CHECKPOINT", "OCR_ERROR_MODEL_CHECKPOINT")
FONT_DL_BASE = "http://127.0.0.1:9"  # nothing listens there

if __name__ == "__main__":  # the settings are read when the port is first imported
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the GPU")
    if "--tree" in sys.argv:  # --kernels or --lfm2 with --tree DIR: the port of another tree (an unpacked commit)
        sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]))
    os.environ.setdefault("ALLOW_RANDOM_WEIGHTS", "true")
    os.environ.setdefault("DISABLE_TQDM", "true")
    for _name in CHECKPOINT_SETTINGS:
        os.environ[_name] = os.devnull
    # the OCR render's font fetch (debug/fonts.py) goes to a refused
    # loopback port: it fails at once, and the render uses PIL's font
    os.environ["RECOGNITION_FONT_DL_BASE"] = FONT_DL_BASE

from PIL import Image, ImageDraw  # noqa: E402

from surya_tpu_torch.detection import DetectionPredictor, resize_on_device  # noqa: E402
from surya_tpu_torch.detection.util import get_total_splits, split_image  # noqa: E402
from surya_tpu_torch.ops import connected_components as cc  # noqa: E402
from surya_tpu_torch.layout import LayoutPredictor  # noqa: E402
from surya_tpu_torch.layout.loader import layout_config  # noqa: E402
from surya_tpu_torch.layout.slicer import ImageSlicer  # noqa: E402
from surya_tpu_torch.models import qwen_decoder, qwen_encoder  # noqa: E402
from surya_tpu_torch.models.foundation import MeshedFoundation, slot_sources  # noqa: E402
from surya_tpu_torch.parallel.mesh import Sharded, make_mesh, split_range  # noqa: E402
from surya_tpu_torch.models.efficientvit import install_blob_detector  # noqa: E402
from surya_tpu_torch.models.qwen_encoder import EncoderConfig, plan_layout  # noqa: E402
from surya_tpu_torch.ops import _build, decode_attn, flash  # noqa: E402
from surya_tpu_torch.recognition import RecognitionPredictor  # noqa: E402
from surya_tpu_torch.recognition.loader import DEFAULT_ENCODER  # noqa: E402
from surya_tpu_torch.models.layout_model import ID_TO_LABEL  # noqa: E402
from surya_tpu_torch.settings import Settings, load_dotenv, settings  # noqa: E402
from surya_tpu_torch.table_rec import PROMPT_BUCKETS, TableRecPredictor, install_synthetic_tables  # noqa: E402
from surya_tpu_torch.models.table_rec_model import BOX_DIM  # noqa: E402
from surya_tpu_torch.models.distilbert import DistilBert  # noqa: E402
from surya_tpu_torch.models.foundation import FoundationModel  # noqa: E402
from surya_tpu_torch import nn as pnn  # noqa: E402
from surya_tpu_torch.common import graphs, profiling  # noqa: E402
from surya_tpu_torch.common.checkpoint import cache_path  # noqa: E402
from surya_tpu_torch.common.weights import fold_batchnorm  # noqa: E402
from surya_tpu_torch.nn import QuantLinear  # noqa: E402
from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer  # noqa: E402
from surya_tpu_torch.recognition.tokenizer import DEFAULT_SPECIAL_TOKENS  # noqa: E402
from surya_tpu_torch.ocr_error import OCRErrorPredictor  # noqa: E402
from surya_tpu_torch.ocr_error import SEQ_BUCKETS as OCR_ERROR_SEQ_BUCKETS  # noqa: E402
from surya_tpu_torch.ocr_error import random_model as ocr_error_random_model  # noqa: E402
from surya_tpu_torch.recognition.loader import random_model  # noqa: E402
from surya_tpu_torch.recognition.util import REPEAT_WINDOW  # noqa: E402
from surya_tpu_torch.scripts import (  # noqa: E402
    detect_layout, detect_text, ocr_latex, ocr_text, streamlit_app, table_recognition, texify_app, web_app,
)
from surya_tpu_torch.common.util import expand_bbox, rescale_bbox  # noqa: E402
from surya_tpu_torch.debug.draw import draw_text_on_image  # noqa: E402

SEED = 0
N_PAGES, LINES_PER_PAGE, PIN_TOKENS = 4, 8, 40
# line crops: sides multiples of 28 px, area in [168^2, 1024*256], so the
# processor neither rescales nor resizes them
LINE_SHAPES = [(56, 504), (56, 700), (84, 840), (56, 980), (84, 560), (56, 616), (84, 952), (56, 812)]
# whole-page OCR: 8 pages (the JAX predictor's sequential det->rec limit),
# one detection chunk each, 16 dark bands of 24 px every 62 px
OCR_PAGES, OCR_LINES, OCR_PAGE_SIZE = 8, 16, 1024
# whole-page OCR of 16 synthetic pages with the int8 cache, 40 pinned tokens a
# line, in two detection groups of 8 pages through the streaming path (bench.py's
# page count, not its pages, cache or chunk: phase 26 runs those)
STREAM_PAGES, PIPELINE_PAGES = 16, 8
# bench.py's workload (phase 26), copied from bench.py: its environment
# (:50-57; it never sets RECOGNITION_MODEL_QUANTIZE, so the KV cache is bf16),
# 16 pages of its build_page() of 40 lines each, and the best of 3 full trials
BENCH_PAGES, BENCH_LINES, BENCH_TRIALS = 16, 40, 3
# phase 26's configurations: label -> (programs graphed, loops graphed), the
# summary key of each after the first, and the stages whose split it prints
BENCH_CONFIGS = {"graphed": (True, True), "loops graphed, programs eager": (False, True), "plain": (False, False)}
BENCH_CONFIG_KEYS = {"loops graphed, programs eager": "programs_eager", "plain": "plain"}
BENCH_STAGES = ("recognition.prefill", "recognition.detect", "recognition.prefill_build", "recognition.drain_prefill")
BENCH_ENV = {"ALLOW_RANDOM_WEIGHTS": "true", "RECOGNITION_MAX_TOKENS": str(PIN_TOKENS),
             "RECOGNITION_PIN_DECODE": "true", "RECOGNITION_DECODE_CHUNK": str(PIN_TOKENS), "DISABLE_TQDM": "true"}
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
    "gqa_decode_int8": ("surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:187"),
    # the mesh wrappers: the same kernels, launched once a shard
    "segmented_block_attention_shard_map": ("surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:130"),
    "causal_flash_attention_shard_map": ("surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:159"),
    "gqa_decode_shard_map": ("surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:301"),
    "gqa_decode_shard_map_int8": ("surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:301"),
}
COUNTERS = {  # kernel -> (wrapper, its launch counter)
    "segmented_block_attention": (flash.segmented_block_attention, "launches"),
    "causal_flash_attention": (flash.causal_flash_attention, "launches"),
    "gqa_decode": (decode_attn.gqa_decode, "launches"),
    "gqa_decode_int8": (decode_attn.gqa_decode, "launches_q"),
    "segmented_block_attention_shard_map": (flash.segmented_block_attention_shard_map, "launches"),
    "causal_flash_attention_shard_map": (flash.causal_flash_attention_shard_map, "launches"),
    "gqa_decode_shard_map": (decode_attn.gqa_decode_shard_map, "launches"),
    "gqa_decode_shard_map_int8": (decode_attn.gqa_decode_shard_map, "launches_q"),
}
MESH_WRAPPERS = (flash.segmented_block_attention_shard_map, flash.causal_flash_attention_shard_map,
                 decode_attn.gqa_decode_shard_map)
K1_BY_RANGE = "segmented_block_attention by kv_range"
# K3's library call: the first of these SDPA backends that takes a boolean
# mask with enable_gqa (the fused ones first)
DECODE_SDPA_BACKENDS = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def reset_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    flash.segmented_block_attention.launches_by_range = {}
    for fn in MESH_WRAPPERS:
        fn.launches_by_shard, fn.launches_gathered = {}, 0


def read_counts() -> dict:
    """The launch counts; and for each mesh wrapper its launches by shard
    ("<name> by shard") and the gathered path's ("gathered", all three)."""
    counts = {n: getattr(fn, attr) for n, (fn, attr) in COUNTERS.items()}
    counts[K1_BY_RANGE] = dict(flash.segmented_block_attention.launches_by_range)
    for fn in MESH_WRAPPERS:
        counts[f"{fn.__name__} by shard"] = dict(fn.launches_by_shard)
    counts["gathered"] = sum(fn.launches_gathered for fn in MESH_WRAPPERS)
    return counts


def release() -> None:
    """Free what the objects just dropped held on the card: a collection
    first (a predictor can sit in a reference cycle until one), then the
    allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def memory() -> str:
    """The card's memory as the allocator holds it."""
    return (f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


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
    the capture run on one side stream. cold: each call
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
    return timed_case(name, hold(name, out, ref), kernel, plain, results, work, library, reps, cold, report, entry)


def hold(name, out, ref) -> float:
    """A kernel's output against its plain version's, elementwise within
    KERNEL_RTOL * |ref| + KERNEL_ATOL; returns the largest difference."""
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
    err = diff.max().item()
    n_bad = int((diff > KERNEL_RTOL * mag + KERNEL_ATOL).sum())
    print(f"  {name}: max_abs_err {err:.3e} (|ref| max {mag.max().item():.3f}; tol {KERNEL_RTOL:.4g}*|ref| "
          f"+ {KERNEL_ATOL}: {n_bad} outside)")
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} elements of the kernel's output disagree with its plain version")
    return err


def timed_case(name, err, kernel, plain, results, work, library=None, reps=20, cold=False, report=False,
               entry=None, calls=1):
    """Time a held case: the kernel's, the plain version's and the library
    call's device time (kernel's over `calls` launches: a mesh wrapper's
    shards run one after another on one card), the bound of the work one
    launch needs; record err and, with report, the times in results."""
    ms, plain_ms = cuda_ms(kernel, reps, cold) / calls, cuda_ms(plain, max(2, reps // 4), cold)
    flops, nbytes = work
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    library_ms = cuda_ms(library, max(2, reps // 4), cold) if library is not None else None
    print(f"    {name}: kernel {ms:.4f} ms{' a launch' if calls > 1 else ''}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops:.4g} ops, {nbytes:.4g} bytes: {100 * bound_ms / ms:.1f} % of the bound)"
          + (f", library call {library_ms:.4f} ms" if library is not None else ""))
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
    rule (csrc/flash_attn.cu), not counted on the card. Each 64 query rows
    (a warpgroup's) span the keys from the start of their first row's group
    run to the end of their last row's, clipped to their window (the whole
    window for rows not inside it); each item (128 rows of one head) walks
    the union of its 2 warpgroups' spans in 64-key tiles, and a warpgroup
    computes the tiles that meet its own span, 64 x 64 pairs each."""
    S = gid.size
    bounds = np.concatenate([[0], np.flatnonzero(gid[1:] != gid[:-1]) + 1, [S]])
    run_start, run_end = np.repeat(bounds[:-1], np.diff(bounds)), np.repeat(bounds[1:], np.diff(bounds))
    r0 = np.arange(0, S, 64)
    kv0 = np.clip(starts[r0 // flash.PLAN_CHUNK].astype(np.int64), 0, S - kv_range)
    kv1 = kv0 + kv_range
    inside = (r0 >= kv0) & (r0 + 64 <= kv1)
    lo = np.where(inside, np.maximum(run_start[r0], kv0), kv0).reshape(-1, 2)
    hi = np.where(inside, np.minimum(run_end[r0 + 63], kv1), kv1).reshape(-1, 2)
    pairs = 0
    for w_lo, w_hi in zip(lo, hi):
        kt = w_lo.min() + 64 * np.arange(-(-(w_hi.max() - w_lo.min()) // 64))
        pairs += 64 * 64 * int(((kt[None] < w_hi[:, None]) & (kt[None] + 64 > w_lo[:, None])).sum())
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
        n_groups = len(np.unique(gid[gid >= 0]))
        print(f"  K1 [{tag}, {label}] S={S} H={H} D={D} kv_range={rng_len} "
              f"(kv_starts max {int(starts.max())}, {n_groups} groups)")
        pairs = print_segmented_launch(S, H, gid, starts, rng_len)
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
    print_segmented_launch(S, H, gid, starts, kv_range)
    q, k, v = segmented_inputs(gen, S, H, D)
    gid_t, starts_t = to_cuda(gid), to_cuda(starts)
    compare(
        "segmented_block_attention[edges]",
        lambda: flash.segmented_block_attention(q, k, v, gid_t, starts_t, kv_range),
        lambda: flash.segmented_block_attention_reference(q, k, v, gid_t, starts_t, kv_range),
        {},
        work=(4 * pairs * H * D, 4 * nbytes(q)),
    )


def causal_config(B, L, kvh) -> Optional[dict]:
    """K2's launch configuration as its host code picks it (None for a tree
    whose kernel library does not report it)."""
    lib = _build.library().lib
    if not hasattr(lib, "surya_causal_config"):
        return None
    cfg = (ctypes.c_int * 5)()
    lib.surya_causal_config(B, L, kvh, cfg)
    return dict(zip(("ctas", "row_blocks_per_item", "kv_stages", "smem_bytes_per_cta", "threads_per_cta"), cfg))


def segmented_config(S, H) -> Optional[dict]:
    """K1's launch configuration as its host code picks it, with the
    registers and spills ptxas gave the kernel (None for a tree whose kernel
    library does not report it)."""
    lib = _build.library()
    if not hasattr(lib.lib, "surya_segmented_config"):
        return None
    cfg = (ctypes.c_int * 5)()
    lib.lib.surya_segmented_config(S, H, cfg)
    out = dict(zip(("ctas", "threads_per_cta", "kv_stages", "smem_bytes_per_cta", "ctas_per_sm"), cfg))
    entry = False
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line:
            entry = "segmented_attention_kernel" in line
        elif entry and "registers" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif entry and "spill" in line:
            out["spill_store_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
    return out


def print_segmented_launch(S, H, gid, starts, kv_range):
    """K1's launch at these shapes, and the query-key pairs it computes for
    each head (modelled from its span rule) against the pairs the plan
    needs and the whole windows hold."""
    _, sizes = np.unique(gid[gid >= 0], return_counts=True)
    pairs = int((sizes.astype(np.int64) ** 2).sum())
    done = computed_pairs(gid, starts, kv_range)
    print(f"    K1 launch: {segmented_config(S, H)}; pairs per head, modelled from the span rule at 64-row "
          f"warpgroups and 64-key tiles: the kernel computes {done} ({done / pairs:.2f} x the plan's), the whole "
          f"windows hold {S * kv_range} ({S * kv_range / pairs:.2f} x)")
    return pairs


def decode_config(B, kvh, S, K) -> Optional[dict]:
    """K3's and K3q's launch configuration, as causal_config."""
    lib = _build.library().lib
    if not hasattr(lib, "surya_decode_config"):
        return None
    cfg = (ctypes.c_int * 6)()
    lib.surya_decode_config(B, kvh, S, K, cfg)
    return dict(zip(("ctas", "cluster_size", "sub_tile_slots", "smem_bytes_per_cta", "threads_per_cta",
                     "ctas_per_sm"), cfg))


# K3's cluster rule on the H100, written out here to hold the kernel's host
# code to it: a CTA's shared memory is 6 slots of 8192 bytes, the mbarriers
# and, in a cluster, each rank's 1560-byte partial; an SM holds the CTAs
# that fit its 228 KB with 1 KB reserved for each, at most 4.
DECODE_SUB_ROWS, DECODE_SUBS_PER_CTA, DECODE_MAX_CLUSTER = 16, 12, 8


def decode_ctas_per_sm(c: int) -> int:
    smem = 6 * 8192 + 7 * 8 + (c * 1560 if c > 1 else 0)
    return min(4, 228 * 1024 // (smem + 1024))


def expected_cluster(B, kvh, S, K, sms) -> int:
    """CTAs of a (slot, kv head): enough that none walks more than
    DECODE_SUBS_PER_CTA sub-tiles, at most DECODE_MAX_CLUSTER, fewer while
    the launch's CTAs would not all fit the card at once."""
    subs = -(-S // DECODE_SUB_ROWS) + -(-K // DECODE_SUB_ROWS)
    c = min(DECODE_MAX_CLUSTER, -(-subs // DECODE_SUBS_PER_CTA))
    while c > 1 and c * B * kvh > decode_ctas_per_sm(c) * sms:
        c -= 1
    return c


def check_decode_launch(B, kvh, S, K) -> Optional[dict]:
    """K3's launch configuration at this shape, held to expected_cluster
    and decode_ctas_per_sm (not for another tree's kernels, --tree)."""
    cfg = decode_config(B, kvh, S, K)
    if cfg is None or "--tree" in sys.argv:
        return cfg
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = expected_cluster(B, kvh, S, K, sms)
    if cfg["cluster_size"] != want or cfg["ctas_per_sm"] != decode_ctas_per_sm(want):
        raise AssertionError(f"K3 at B={B} kvh={kvh} S={S} K={K}: launch {cfg}, the rule gives {want} CTAs a (slot, "
                             f"kv head) and {decode_ctas_per_sm(want)} CTAs an SM")
    return cfg


def check_causal(results, B, L, gen, report=False, heads=(12, 4), name="causal_flash_attention", D=128):
    """K2 over B right-padded prompts of bucket L (heads: query and kv heads;
    6/2 is a 2x2 mesh's shard; 32/8 at D = 64 LFM2-MoE's attention layers)."""
    H, kvh = heads
    qc, kc, vc = randn(gen, B, L, H, D, scale=1.0), randn(gen, B, L, kvh, D), randn(gen, B, L, kvh, D)
    print(f"  K2 B={B} L={L} H={H} kvh={kvh} D={D}; launch {causal_config(B, L, kvh)}")
    qt, kt, vt = (x.transpose(1, 2) for x in (qc, kc, vc))
    return compare(
        f"{name}[{B}x{L}]",
        lambda: flash.causal_flash_attention(qc, kc, vc),
        lambda: flash.causal_flash_attention_reference(qc, kc, vc),
        results,
        work=(4 * B * H * D * (L * (L + 1) // 2), 2 * nbytes(qc) + nbytes(kc, vc)),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        report=report,
        entry=name,
    )


def decode_inputs(gen, B, S, K, layers=10, kvh=4, group=3, D=128):
    """q, bf16 cache and chunk, and the same cache quantized to int8, at the
    decoder's widths (12/4 heads, D = 128; kvh=2: a 2x2 mesh's shard; group
    4 at D = 64, LFM2-MoE's attention layers, whose cache K3q does not
    read: None in its place)."""
    qd = randn(gen, B, group * kvh, D, scale=1.0)
    kcache, vcache = randn(gen, layers, B, kvh, S, D), randn(gen, layers, B, kvh, S, D)
    ck, cv = randn(gen, layers, B, kvh, K, D), randn(gen, layers, B, kvh, K, D)
    if (D, group) not in decode_attn.QUANT_SHAPES:
        return qd, (kcache, vcache), None, (ck, cv)
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


def check_decode_case(results, label, inputs, lens_np, step, layer, library=False, names=("gqa_decode",
                                                                                          "gqa_decode_int8")):
    """K3 and K3q on one (lengths, step, layer) case, each within tolerance
    of its plain version, timed with a cold L2 as a decode step finds the
    cache, and their launch held to the cluster rule; names: their entries
    in results. Returns {kernel: its times}."""
    qd, (kcache, vcache), int8, (ck, cv) = inputs
    B, S, K, kvh = qd.shape[0], kcache.shape[3], ck.shape[3], kcache.shape[2]
    H, D = qd.shape[1], qd.shape[2]
    lens = to_cuda(lens_np)
    rows = int(lens_np.sum())  # valid cache rows of each kv head, over all slots
    ops = 4 * H * D * (rows + B * (step + 1))
    chunk_bytes = 2 * B * kvh * (step + 1) * D * 2
    other = 2 * nbytes(qd) + nbytes(lens)
    print(f"  K3 B={B} H={H} kvh={kvh} D={D} S={S} K={K} step={step} layer={layer}, {label} lengths "
          f"(longest {int(lens_np.max())}; {rows} valid cache rows per kv head); launch "
          f"{check_decode_launch(B, kvh, S, K)}")
    lib_call = None
    if library:
        lib_call, backend = decode_library(qd, kcache, vcache, lens, ck, cv, step, layer)
        ref = decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer)
        print(f"    library call: SDPA, {backend} backend, max_abs_err {(lib_call().float() - ref.float()).abs().max().item():.3e} "
              f"against the plain version")
    timed = {"gqa_decode": compare(
        f"{names[0]}[{step}, {label}]",
        lambda: decode_attn.gqa_decode(qd, kcache, vcache, lens, ck, cv, step, layer),
        lambda: decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer),
        results,
        work=(ops, 2 * rows * kvh * D * 2 + chunk_bytes + other),
        library=lib_call,
        cold=True,  # a decode step reads each layer's cache once
        entry=names[0],
    )}
    if int8 is None:
        return timed
    kq, vq, ks, vs = int8
    print("  K3q, the same with an int8 cache and bf16 row scales" +
          ("; no PyTorch call reads an int8 cache with row scales, so it has no library time" if library else ""))
    timed["gqa_decode_int8"] = compare(
        f"{names[1]}[{step}, {label}]",
        lambda: decode_attn.gqa_decode(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
        lambda: decode_attn.gqa_decode_reference(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
        results,
        work=(ops, 2 * rows * kvh * (128 + 2) + chunk_bytes + other),
        cold=True,
        entry=names[1],
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
    of 64 rows, and of S) at the first and last step; and the
    floor, every length 0 at step 0: the fixed cost of a call and of the
    timing. Then 300 slots of ragged lengths over 2 layers, a slot count no
    recognition batch here reaches, at the last step. Returns the long-cache
    row's times."""
    B, S3, K = 129, 512, 64
    inputs = decode_inputs(gen, B, S3, K)
    ragged = np.random.default_rng(SEED).integers(0, S3 + 1, B).astype(np.int32)
    ragged[:4] = [0, 1, 117, S3]
    mean = int(round(ragged.mean()))
    sub, T = DECODE_SUB_ROWS, 64  # a sub-tile's rows (a TMA box, a warp's products), and 4 of them
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
    """For one predictor run, FoundationModel.launch_chunk becomes a
    stand-in (in this script only) that keeps, for each decode kernel, the
    shapes of its first call in the run: the first chunk's cache lengths (a
    device copy: no sync), which its first step gives K3 or K3q, and the
    cache and chunk shapes; then it launches the chunk (a graph replay, whose
    kernels Python does not see)."""

    def __init__(self):
        self.first = {}

    def __enter__(self):
        launch = FoundationModel.launch_chunk

        def record(model, cache, last_token, active, num_steps, *args):
            kernel = "gqa_decode_int8" if "k_scale" in cache else "gqa_decode"
            if kernel not in self.first:
                k = cache["k"]
                self.first[kernel] = dict(lengths=cache["len"].clone(), cache=tuple(k.shape),
                                          chunk=(*k.shape[:3], num_steps, k.shape[4]))
            return launch(model, cache, last_token, active, num_steps, *args)

        self.launch, FoundationModel.launch_chunk = launch, record
        return self

    def __exit__(self, *exc):
        FoundationModel.launch_chunk = self.launch


class MainPathShapes(DecodeShapes):
    """DecodeShapes, and the encoder's and the decoder's `flash` become
    stand-ins too (in this script only): the first `depth` K1 calls (one
    prefill wave's blocks, in block order) keep their group ids and window
    starts (device copies) and window lengths, and the first K2 call its
    shapes. A prefill wave replayed from its graph calls no stand-in: the
    caller runs the recorded call with the prefill eager
    (graphs.EagerPrograms)."""

    def __init__(self, encoder_config):
        super().__init__()
        self.depth, self.k1, self.k2 = encoder_config.depth, [], None

    def __enter__(self):
        super().__enter__()

        def k1(q, k, v, seg_id, kv_starts, kv_range):
            if len(self.k1) < self.depth:
                self.k1.append((seg_id.clone(), kv_starts.clone(), kv_range))
            return flash.segmented_block_attention(q, k, v, seg_id, kv_starts, kv_range)

        def k2(q, k, v, mesh=None):
            if self.k2 is None:
                self.k2 = tuple(q.shape)
            return flash.causal_flash_attention(q, k, v, mesh=mesh)

        qwen_encoder.flash = types.SimpleNamespace(**{**vars(flash), "segmented_block_attention": k1})
        qwen_decoder.flash = types.SimpleNamespace(**{**vars(flash), "causal_flash_attention": k2})
        return self

    def __exit__(self, *exc):
        qwen_encoder.flash = qwen_decoder.flash = flash
        super().__exit__(*exc)

    def plan(self, encoder_config):
        """The recorded wave's full-attention and windowed groups, as the
        fields of a layout plan that check_segmented reads."""
        if len(self.k1) < self.depth:
            raise AssertionError(f"{len(self.k1)} K1 calls recorded, want a wave's {self.depth}")
        full = min(encoder_config.fullatt_block_indexes)
        window = next(i for i in range(self.depth) if i not in encoder_config.fullatt_block_indexes)
        (gid, starts, kv_range), (wid, wstarts, win_range) = self.k1[full], self.k1[window]
        return types.SimpleNamespace(
            cap=gid.numel(), seg_id=gid.cpu().numpy(), kv_starts=starts.cpu().numpy(), kv_range=kv_range,
            win_id=wid.cpu().numpy(), win_starts=wstarts.cpu().numpy(), win_range=win_range)


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
                results, "main path", inputs, lens_np, step, layers - 1, library=kernel == "gqa_decode")[kernel]
        keys = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if kernel == "gqa_decode" else ())
        res = results[kernel]
        res.update({k: float(np.mean([t[k] for t in by_step.values()])) for k in keys})
        res.setdefault("library_ms", None)
        res.update(bound_by=by_step[str(K - 1)]["bound_by"], main_path=dict(slots=B, S=S, K=K), by_step=by_step,
                   long_cache=long_cache[kernel])
        print(f"    {kernel}: mean over steps {list(by_step)}: {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({100 * res['bound_ms'] / res['ms']:.1f} %)")


def first_wave(pred, flat, n_shards: int = 1):
    """The prefill batch of the predictor's first wave over flat's lines, as
    its scheduler builds it: widest line first, the row bucket that fits
    (n_shards: the data-sharded build of a mesh). Returns (batch, number of
    lines)."""
    order = sorted(range(len(flat["slices"])), key=lambda j: -flat["slices"][j].shape[1])
    if len(order) > pred.prefill_row_buckets[-1]:
        raise ValueError(f"{len(order)} lines do not fit one wave")
    imgs = [pred._prepare_image(flat["slices"][j], flat["task_names"][j]) for j in order]
    batch = pred.processor.build_prefill_batch(
        imgs, [flat["task_names"][j] for j in order], [flat["input_text"][j] for j in order], [True] * len(imgs),
        pred.config.encoder, batch_rows=next(b for b in pred.prefill_row_buckets if b >= len(imgs)),
        seq_buckets=pred.seq_buckets, patch_caps=pred.patch_caps, n_shards=n_shards,
    )
    return batch, len(imgs)


def check_lines(results, pages, lines_per_page):
    """lines_per_page: one count for every page, or a list of each page's."""
    n_lines = sum(len(r.text_lines) for r in results)
    want = lines_per_page if isinstance(lines_per_page, list) else [lines_per_page] * len(pages)
    if len(results) != len(pages) or [len(r.text_lines) for r in results] != want:
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


def check_streaming_pages(pred, det, pages, power):
    """Whole-page OCR of 16 synthetic pages (int8 cache, 40 pinned tokens a
    line) through the streaming path (detection of the second group
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


def rel(a, b) -> float:
    """The relative error of a against b: the norm of the difference over b's."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def model_path_outputs(pred, batch, model, use_kernels: bool, dtype, quantize: bool) -> dict:
    """One prefill wave (batch) through `model`, then one decode step over
    the cache it filled (bf16, or int8 with quantize), every row a slot and
    its first input id the step's token: the image tokens, the prefill's
    last hidden states and the step's hidden states."""
    proc = pred.processor
    rows, L = batch.input_ids.shape
    lay = batch.layout

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(pred.device)

    dec = pred.config.decoder
    patches = proc.normalize_patch_rows(t(batch.patches), dtype)
    img = model.encode_images(patches, tuple(t(a) for a in lay.device_args), t(lay.llm_h_idx), t(lay.llm_w_idx),
                              lay.kv_range, lay.win_range, use_kernels=use_kernels)
    embeds = model.embed_prompt_tokens(t(batch.input_ids), t(batch.img_gather), img)
    nk, nv, last = model.decoder.prefill(embeds, t(batch.seq_lens), use_kernels=use_kernels)
    cache = qwen_decoder.init_cache(dec, rows, -(-L // 256) * 256, dtype, pred.device, quantize=quantize)
    qwen_decoder.merge_prefill(cache, nk, nv, t(batch.seq_lens), torch.arange(rows, device=pred.device))
    ck = torch.zeros((dec.num_hidden_layers, rows, dec.num_key_value_heads, 8, dec.head_dim),
                     dtype=dtype, device=pred.device)
    emb = model.token_embed(t(batch.input_ids[:, 0].astype(np.int64)))
    hid = model.decoder.decode_step_chunked(cache, ck, torch.zeros_like(ck), emb, 0,
                                            cache["len"].clone(), use_kernels=use_kernels)
    return {"image tokens": img[: lay.n_llm_tokens], "prefill hidden": last, "decode hidden": hid}


def check_model_paths(pred, flat, quantize: bool):
    """One prefill wave over flat's lines (the first_wave batch), then one
    decode step over the cache it filled (bf16, or int8 with quantize), run
    three ways on the same weights and inputs: bf16 through the kernels,
    bf16 through the plain versions, and float32 through the plain versions.
    The kernel path must be no further from the float32 run than MODEL_RATIO
    times the plain bf16 path is."""
    batch, _ = first_wave(pred, flat)
    with torch.inference_mode():
        before = read_counts()
        kern = model_path_outputs(pred, batch, pred.model, True, pred.dtype, quantize)
        used = {n: c - before[n] for n, c in read_counts().items() if n in COUNTERS}
        plain = model_path_outputs(pred, batch, pred.model, False, pred.dtype, quantize)
        model32 = copy.deepcopy(pred.model).float()
        ref = model_path_outputs(pred, batch, model32, False, torch.float32, quantize)
        del model32
    rows = batch.input_ids.shape[0]
    dec = pred.config.decoder
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


def build_page(width=1240, height=1754):
    """bench.py's page (its build_page, line for line): 40 lines of text at
    font_size=22. Drawing at a size needs Pillow >= 10.1 with FreeType;
    without them this raises, and never falls back to PIL's default font."""
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    for i in range(BENCH_LINES):
        draw.text((60, 40 + i * 42), f"Line {i}: the quick brown fox jumps over the lazy dog.", fill="black",
                  font_size=22)
    return img


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
          f"tiles; AR steps run {run['steps']} (per dispatch); "
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
    lay(pages)  # warm-up (cuBLAS, cuDNN, allocator, the box loop's graphs)
    run_layout(lay, pages, "as called", power)
    lay.model.config = capped
    try:
        lay(pages)  # the cap-bound loop's graphs
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
    tab(crops)  # warm-up (the box loops' graphs)
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
    print(f"    passes: {[(p['rows'], p['steps']) for p in passes]} (rows, AR steps); "
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
    token ids of the same two calls one after the other."""
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
    same = [a == b for a, b in zip(out, seq)]
    print(f"    two predictors in two threads: {sum(map(len, out))} lines, wall {wall:.4f} s (one after the other "
          f"{seq_wall:.4f} s); token ids equal to the sequential calls' for each: {same}; K3 launches "
          f"{launches['gqa_decode']} [{power}]")
    if not all(same) or len(out[0]) != len(pages) * LINES_PER_PAGE:
        raise AssertionError("two predictors decoding at once gave other token ids than one after the other")
    if launches["gqa_decode"] <= 0:
        raise AssertionError("the threaded run launched no K3")


def check_decode_on_two_streams(gen, power, reps=20):
    """K3 launched in turn on two streams with the same slot count, 4
    slots at a cache long enough (2048 rows) that each (slot, kv head) is a
    cluster of CTAs, and the CTAs of both streams' calls fit the card at
    once, so that the calls run at once: every output must equal its plain
    version within the kernel tolerance. The kernel keeps nothing between
    calls (the merge is inside each cluster); the two predictors of
    check_two_predictors launch their short calls too far apart to show
    that calls overlapping on the card stay apart."""
    B, S, K, step = 4, 2048, 64, 63
    launch = check_decode_launch(B, 4, S, K)
    if launch["cluster_size"] < 2 or 2 * launch["ctas"] > launch["ctas_per_sm"] * torch.cuda.get_device_properties(
            0).multi_processor_count:
        raise AssertionError(f"K3 on two streams: launch {launch}, not clusters whose two calls fit the card")
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
    print(f"    K3 on two streams in turn, {reps} calls each (B={B}, S={S}, launch {launch}): {2 * reps} calls in "
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
                steps, steps_ck = (p._generate(tile_pixels)[0] for p in (lay, llay))
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


# -- the mesh (phases 20 to 23) --------------------------------------------------
# A logical mesh repeats cuda:0; its shards run one after another on one card,
# so it measures the sharded code path (per-shard launches, the row-parallel
# sums, the data-sharded encoder, the slot interleave), not multi-card scaling.

MESH_SHAPES = [(2, 2), (1, 2), (2, 1)]  # (data, model): data + TP, pure TP (K1-mesh), data
PLAIN_VERSIONS = [(flash, "segmented_block_attention_reference"), (flash, "causal_flash_attention_reference"),
                  (decode_attn, "gqa_decode_reference")]


class PlainCalls:
    """In the block, the plain versions of K1, K2 and K3 (the module
    attributes through which the wrappers and the models call them) count
    their calls on CUDA tensors in `calls`."""

    def __enter__(self):
        self.calls, self.saved = {name: 0 for _, name in PLAIN_VERSIONS}, []
        for module, name in PLAIN_VERSIONS:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += args[0].device.type == "cuda"
                return _fn(*args, **kwargs)

            setattr(module, name, counted)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


class MeshShapes:
    """For one meshed predictor run, what its first prefill and first decode
    chunk give the kernel wrappers (stand-ins, in this script only, for its
    MeshedFoundation's launch_prefill and launch_chunk): the prefill's rows
    and bucket by shard; the chunk's base lengths by shard (a device copy),
    cache and chunk shapes; the replicated encoder's plan (a mesh of one
    data row). Each is recorded where its program is launched, since a
    replay of its graph runs no Python of its body."""

    def __init__(self, mp):
        self.meshed, self.first = mp.meshed, {}

    def __enter__(self):
        first = self.first
        prefill, chunk = self.meshed.launch_prefill, self.meshed.launch_chunk

        # each records at its first call only, so that later calls do no
        # more work than the unwrapped methods
        def rec_prefill(cache, inputs, kv_range, win_range, sharded, *args):
            if "prefill" not in first:
                first["prefill"] = {dm: tuple(v["input_ids"].shape) for dm, v in inputs.items()}
                if not sharded:
                    # device_args: patch_gather, pos_hw, seg_id, win_id, unscatter, kv_starts, win_starts
                    a = {name: t.cuda() for name, t in inputs[0, 0].items()}
                    first["encoder"] = dict(full=(a["enc_2"], a["enc_5"], kv_range),
                                            window=(a["enc_3"], a["enc_6"], win_range))
            return prefill(cache, inputs, kv_range, win_range, sharded, *args)

        def rec_chunk(cache, last_token, active, num_steps, *args):
            if "decode" not in first:
                first["decode"] = dict(lengths={dm: t.clone() for dm, t in cache["len"].shards.items()},
                                       cache={dm: tuple(t.shape) for dm, t in cache["k"].shards.items()},
                                       K=num_steps)
            return chunk(cache, last_token, active, num_steps, *args)

        self.meshed.launch_prefill, self.meshed.launch_chunk = rec_prefill, rec_chunk
        return self

    def __exit__(self, *exc):
        del self.meshed.launch_prefill, self.meshed.launch_chunk


def same_weights(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(bitwise_equal(sa[k], sb[k]) for k in sa)


def mesh_path_outputs(mp, batch, n: int, quantize: bool) -> dict:
    """model_path_outputs on mp's mesh, through the wrappers: the wave's
    prefill (batch: its data-sharded build), then one decode step with
    prompt i in slot i and its first input id as the token. Returns the
    prefill's last hidden and the step's hidden states of the n prompts, in
    prompt order, gathered on the mesh's first device."""
    mesh, meshed, dec = mp.mesh, mp.meshed, mp.config.decoder
    rows, L = batch.input_ids.shape
    lay = batch.layout
    n_slots = mp.round_batch(n)
    slot_idx, row_valid = np.zeros(rows, np.int32), np.zeros(rows, bool)
    slot_idx[batch.valid_rows], row_valid[batch.valid_rows] = np.arange(n), True
    state = mp._init_state_on_mesh(n_slots)
    program = mp._mesh_inputs(batch, slot_idx, row_valid, state, np.zeros(n_slots, bool))
    x = {dm: {name: t.to(mesh.device(*dm)) for name, t in v.items()} for dm, v in program.items()}
    inputs = {dm: (mp.processor.normalize_patch_rows(v["patches"], mp.dtype), tuple(v[f"enc_{i}"] for i in range(7)),
                   v["llm_h_idx"], v["llm_w_idx"], v["input_ids"], v["img_gather"]) for dm, v in x.items()}
    seq_lens = {dm: v["seq_lens"] for dm, v in x.items()}
    embeds = meshed.encode_embed(inputs, lay.kv_range, lay.win_range, batch.patches.ndim == 3)
    nk, nv, last = meshed.decoder.prefill(embeds, seq_lens)
    valid = torch.from_numpy(batch.valid_rows.astype(np.int64)).to(mesh.first)
    prefill_hidden = torch.cat([last[d, 0].to(mesh.first) for d in range(mesh.n_data)])[valid]
    cache = qwen_decoder.init_cache(dec, n_slots, -(-L // 256) * 256, mp.dtype, None, quantize, mesh=mesh)
    meshed.merge_prefill(cache, nk, nv, seq_lens, {dm: v["source"] for dm, v in x.items()})
    first_ids = np.full(n_slots, mp.config.pad_token_id, np.int64)
    first_ids[:n] = batch.input_ids[batch.valid_rows, 0]
    emb, chunk = {}, {}
    for d, m in mesh.coords():
        lo, hi = split_range(n_slots, mesh.n_data, d)
        dev = mesh.device(d, m)
        emb[d, m] = meshed.model((d, m)).token_embed(mp._upload(first_ids[lo:hi], dev))
        chunk[d, m] = torch.zeros((dec.num_hidden_layers, hi - lo, meshed.decoder.shards[d, m].n_kv_heads, 8,
                                   dec.head_dim), dtype=mp.dtype, device=dev)
    chunks = [Sharded(mesh, qwen_decoder.CHUNK_SPEC, {dm: c.clone() for dm, c in chunk.items()}) for _ in range(2)]
    base_len = Sharded(mesh, qwen_decoder.ROWS_SPEC, {dm: t.clone() for dm, t in cache["len"].shards.items()})
    hid = meshed.decoder.decode_step_chunked(cache, *chunks, emb, 0, base_len)
    decode_hidden = torch.cat([hid[d, 0].to(mesh.first) for d in range(mesh.n_data)])[:n]
    return {"prefill hidden": prefill_hidden, "decode hidden": decode_hidden}


def check_mesh_model_paths(pred, mp, flat, quantize: bool, unsharded: dict):
    """The first wave's prefill and one decode step on mp's mesh (the
    wrappers, bf16) against the same unsharded (the kernels, the plain
    versions in bf16 and in float32; kept in `unsharded` by cache type), by
    relative error: the meshed path no further from the float32 run than
    MODEL_RATIO times the plain bf16 path (check_model_paths' rule)."""
    batch, n = first_wave(pred, flat)
    mbatch, _ = first_wave(mp, flat, mp.n_data)
    with torch.inference_mode():
        meshed = mesh_path_outputs(mp, mbatch, n, quantize)
        if quantize not in unsharded:
            model32 = copy.deepcopy(pred.model).float()
            unsharded[quantize] = (
                model_path_outputs(pred, batch, pred.model, True, pred.dtype, quantize),
                model_path_outputs(pred, batch, pred.model, False, pred.dtype, quantize),
                model_path_outputs(pred, batch, model32, False, torch.float32, quantize),
            )
            del model32
    kern, plain, ref = unsharded[quantize]
    for key in meshed:
        e_m, e_k, e_p = (rel(x[key][:n], ref[key][:n]) for x in (meshed, kern, plain))
        print(f"    {n} prompts, {'int8' if quantize else 'bf16'} cache, {key}: rel err vs float32 plain: meshed "
              f"{e_m:.3e}, unsharded kernels {e_k:.3e}, plain bf16 {e_p:.3e}; meshed vs unsharded kernels "
              f"{rel(meshed[key], kern[key][:n]):.3e}")
        if not (np.isfinite(e_m) and e_m <= MODEL_RATIO * e_p):
            raise AssertionError(f"{key}: the meshed path is further from float32 than {MODEL_RATIO}x the plain path")


def assert_mesh_launches(label, counts, plain_calls, mesh, quantize: bool):
    """The wrappers of the meshed path launched on every shard, nothing
    through the gathered path, no single-device K2, K3 or K3q, and no plain
    version on the card; K1 single-device on a data-sharded mesh (each data
    shard's own encoder), K1-mesh on every shard of a one-data-row mesh."""
    decode = "gqa_decode_shard_map_int8" if quantize else "gqa_decode_shard_map"
    other = "gqa_decode_shard_map" if quantize else "gqa_decode_shard_map_int8"
    k1 = "segmented_block_attention" if mesh.n_data > 1 else "segmented_block_attention_shard_map"
    k1_not = "segmented_block_attention_shard_map" if mesh.n_data > 1 else "segmented_block_attention"
    assert_launched(label, {k: v for k, v in counts.items() if k != K1_BY_RANGE},
                    [k1, "causal_flash_attention_shard_map", decode],
                    [k1_not, other, "causal_flash_attention", "gqa_decode", "gqa_decode_int8", "gathered"])
    shards = set(mesh.coords())
    wrappers = ["causal_flash_attention_shard_map", "gqa_decode_shard_map"]
    if mesh.n_data == 1:
        wrappers.append("segmented_block_attention_shard_map")
    for name in wrappers:
        by_shard = counts[f"{name} by shard"]
        if set(by_shard) != shards or min(by_shard.values()) <= 0:
            raise AssertionError(f"{label}: {name} launched on shards {by_shard}, want every shard of {sorted(shards)}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: plain versions ran on the card: {plain_calls}")


def check_mesh_recognition(pred, pages, bboxes, devices, shapes, caches, power, tag):
    """Given-lines recognition, pinned to PIN_TOKENS a line, on each mesh
    shape over `devices`, bf16 and int8 KV cache, on pred's weights: the
    launches of assert_mesh_launches, the wall and launches per decode step
    against the unsharded predictor's, the token agreement with it (printed,
    not gated: random weights' near-ties flip under other GEMM shapes), and
    check_mesh_model_paths. Returns {(shape, quantize): (counts, MeshShapes
    record)}."""
    flat = pred.slice_bboxes(pages[:1], ["ocr_with_boxes"], bboxes=bboxes[:1])
    dec = pred.config.decoder
    base, paths = {}, {}
    for quantize in caches:
        settings.RECOGNITION_MODEL_QUANTIZE = quantize
        set_pin(True)
        recognized_tokens(pred, pages[:1], bboxes[:1])  # warm-up
        reset_counts()
        tokens, wall = synchronised(recognized_tokens, pred, pages, bboxes)
        base[quantize] = (tokens, wall, read_counts())
    out = {}
    for shape in shapes:
        mesh = make_mesh(*shape, devices)
        t0 = time.perf_counter()
        mp = RecognitionPredictor(mesh=mesh)
        built = time.perf_counter() - t0
        if not same_weights(mp.model, pred.model):
            raise AssertionError("the meshed predictor's random weights differ from the unsharded one's")
        print(f"    {tag} {shape[0]}x{shape[1]} mesh {[[str(x) for x in row] for row in mesh.devices]}: built in "
              f"{built:.1f} s; {mp.n_slots} slots + trash, prefill rows {mp.prefill_row_buckets}; decoder shard "
              f"{mp.meshed.decoder.shards[0, 0].n_heads}/{mp.meshed.decoder.shards[0, 0].n_kv_heads} heads")
        for quantize in caches:
            settings.RECOGNITION_MODEL_QUANTIZE = quantize
            set_pin(True)
            recognized_tokens(mp, pages, bboxes)  # warm-up at the measured shapes (each graph's capture)
            reset_counts()
            with PlainCalls() as plain, MeshShapes(mp) as rec:
                tokens, wall = synchronised(recognized_tokens, mp, pages, bboxes)
            counts = read_counts()
            label = f"{tag} {shape[0]}x{shape[1]}, {'int8' if quantize else 'bf16'} cache"
            base_tokens, base_wall, base_counts = base[quantize]
            n_t = sum(map(len, tokens))
            if len(tokens) != len(base_tokens) or n_t != PIN_TOKENS * len(tokens):
                raise AssertionError(f"{label}: {len(tokens)} lines, {n_t} tokens; want {len(base_tokens)} lines of "
                                     f"{PIN_TOKENS}")
            decode = "gqa_decode_shard_map_int8" if quantize else "gqa_decode_shard_map"
            steps = counts[decode] // (dec.num_hidden_layers * len(mesh.coords()))
            base_k3 = base_counts["gqa_decode_int8" if quantize else "gqa_decode"]
            same, same0, first_diff = agreement(tokens, base_tokens)
            print(f"    {label}: {len(tokens)} lines, {n_t} tokens; wall {wall:.4f} s against {base_wall:.4f} s "
                  f"unsharded ({wall / base_wall:.2f} x); {steps} decode steps, K3-mesh launches {counts[decode]} "
                  f"({counts[decode] // max(steps, 1)} a step, unsharded K3 {base_k3 // max(steps, 1)} a step); "
                  f"token ids equal to the unsharded run's on {same:.4f} of the lines ({same0:.4f} the same token "
                  f"0, median first difference at {first_diff}) [{power}]")
            assert_mesh_launches(label, counts, plain.calls, mesh, quantize)
            if isinstance(mp.programs, graphs.ProgramGraphs):
                print(f"      keys captured over the runs' waves and chunks: {len(mp.programs.captures)} prefill "
                      f"({store_report(mp.programs)}), {len(mp.loops.captures)} decode chunk")
            check_mesh_model_paths(pred, mp, flat, quantize, paths)
            out[shape, quantize] = (counts, rec.first)
        del mp
        release()
    set_pin(False)
    settings.RECOGNITION_MODEL_QUANTIZE = False
    return out


def check_mesh_wrappers(results, gen, records, mesh):
    """K1-mesh, K2-mesh and K3-mesh (bf16 and int8 cache) on `mesh` at the
    shapes the meshed runs gave them (K2-mesh and K3-mesh: the 2x2 run's
    first prefill and decode step, K3q-mesh the int8 one's; K1-mesh the 1x2
    run's plan, replicated), each held against its plain version on the
    gathered inputs; timed a shard (the wrapper's time over its launches,
    one after another on the card) beside one shard's bound, plain version
    and library call."""
    coords = mesh.coords()
    n = len(coords)
    spec = qwen_decoder.PREFILL_SPEC

    # K2-mesh: rows over data, heads over model
    prefill = records[(2, 2), False][1]["prefill"]
    R = sum(prefill[d, 0][0] for d in range(mesh.n_data))
    L = prefill[0, 0][1]
    qg, kg, vg = randn(gen, R, L, 12, 128, scale=1.0), randn(gen, R, L, 4, 128), randn(gen, R, L, 4, 128)
    q, k, v = (Sharded.split(x, mesh, spec) for x in (qg, kg, vg))
    q0, k0, v0 = q[0, 0], k[0, 0], v[0, 0]
    B0, _, H0, _ = q0.shape
    print(f"  K2-mesh {mesh.n_data}x{mesh.n_model}: {R} rows of bucket {L}; a shard {tuple(q0.shape)} q, "
          f"{tuple(k0.shape)} k/v")
    name = "causal_flash_attention_shard_map"
    err = hold(name, flash.causal_flash_attention_shard_map(q, k, v, mesh).gather(),
               flash.causal_flash_attention_reference(qg, kg, vg))
    qt, kt, vt = (x.transpose(1, 2) for x in (q0, k0, v0))
    timed_case(name, err, lambda: flash.causal_flash_attention_shard_map(q, k, v, mesh),
               lambda: flash.causal_flash_attention_reference(q0, k0, v0), results,
               work=(4 * B0 * H0 * 128 * (L * (L + 1) // 2), 2 * nbytes(q0) + nbytes(k0, v0)),
               library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
               report=True, calls=n)
    results[name]["per_shard"] = dict(q=list(q0.shape), kv=list(k0.shape))

    # K3-mesh and K3q-mesh: slots over data, kv heads over model
    for quantize, name in ((False, "gqa_decode_shard_map"), (True, "gqa_decode_shard_map_int8")):
        rec = records[(2, 2), quantize][1]["decode"]
        lens_np = torch.cat([rec["lengths"][d, 0] for d in range(mesh.n_data)]).cpu().numpy().astype(np.int32)
        layers, _, _, S, _ = rec["cache"][0, 0]
        K = rec["K"]
        B = lens_np.size
        qd, (kc, vc), (kq, vq, ks, vs), (ck, cv) = decode_inputs(gen, B, S, K, layers)
        cs = qwen_decoder.CACHE_SPECS
        args = dict(q=Sharded.split(qd, mesh, qwen_decoder.DECODE_Q_SPEC),
                    lengths=Sharded.split(to_cuda(lens_np), mesh, cs["len"]),
                    chunk=[Sharded.split(x, mesh, qwen_decoder.CHUNK_SPEC) for x in (ck, cv)])
        if quantize:
            cache = [Sharded.split(x, mesh, cs["k"]) for x in (kq, vq)]
            scales = [Sharded.split(x, mesh, cs["k_scale"]) for x in (ks, vs)]
            gathered = (kq, vq, ks, vs)
        else:
            cache = [Sharded.split(x, mesh, cs["k"]) for x in (kc, vc)]
            scales = [None, None]
            gathered = (kc, vc, None, None)
        q0, l0 = args["q"][0, 0], args["lengths"][0, 0]
        c0 = [x[0, 0] for x in cache]
        s0 = [x[0, 0] if x is not None else None for x in scales]
        ck0, cv0 = (x[0, 0] for x in args["chunk"])
        B0, H0, D = q0.shape
        kvh0 = c0[0].shape[2]
        rows0 = int(l0.sum())
        print(f"  {'K3q' if quantize else 'K3'}-mesh {mesh.n_data}x{mesh.n_model}: {B} slots, S={S}, K={K}; a shard "
              f"{B0} slots, {H0}/{kvh0} heads, {rows0} valid cache rows a kv head (lengths "
              f"{int(lens_np.min())} to {int(lens_np.max())})")
        by_step = {}
        for step in (0, K // 2 - 1, K - 1):
            layer = layers - 1
            err = hold(f"{name}[{step}]",
                       decode_attn.gqa_decode_shard_map(args["q"], *cache, args["lengths"], *args["chunk"], step,
                                                        layer, *scales, mesh=mesh).gather(),
                       decode_attn.gqa_decode_reference(qd, gathered[0], gathered[1], to_cuda(lens_np), ck, cv, step,
                                                        layer, gathered[2], gathered[3]))
            row_bytes = 128 * 2 if not quantize else 128 + 2
            work = (4 * H0 * D * (rows0 + B0 * (step + 1)),
                    2 * rows0 * kvh0 * row_bytes + 2 * B0 * kvh0 * (step + 1) * D * 2 + 2 * nbytes(q0) + nbytes(l0))
            lib = None if quantize else decode_library(q0, c0[0], c0[1], l0, ck0, cv0, step, layer)[0]
            by_step[str(step)] = timed_case(
                f"{name}[{step}]", err,
                lambda: decode_attn.gqa_decode_shard_map(args["q"], *cache, args["lengths"], *args["chunk"], step,
                                                         layer, *scales, mesh=mesh),
                lambda: decode_attn.gqa_decode_reference(q0, c0[0], c0[1], l0, ck0, cv0, step, layer, *s0),
                results, work=work, library=lib, cold=True, calls=n)
        res = results[name]
        res.update({key: float(np.mean([t[key] for t in by_step.values()])) for key in ("ms", "plain_ms", "bound_ms")})
        res["library_ms"] = None if quantize else float(np.mean([t["library_ms"] for t in by_step.values()]))
        res.update(bound_by=by_step[str(K - 1)]["bound_by"], by_step=by_step,
                   per_shard=dict(slots=B0, heads=H0, kv_heads=kvh0, S=S, K=K))

    # K1-mesh: every shard the whole packed sequence (the encoder is not partitioned)
    cfg = EncoderConfig(**DEFAULT_ENCODER)
    plan = records[(1, 2), False][1]["encoder"]
    for label, (gid_t, starts_t, rng_len) in (("full", plan["full"]), ("window", plan["window"])):
        S = gid_t.numel()
        qg, kg, vg = segmented_inputs(gen, S, cfg.num_heads, cfg.head_dim)
        rep = [Sharded.split(x.contiguous(), mesh, (None,) * x.ndim) for x in (qg, kg, vg, gid_t, starts_t)]
        gid = gid_t.cpu().numpy()
        name = f"segmented_block_attention_shard_map[{label}]"
        print(f"  K1-mesh {mesh.n_data}x{mesh.n_model} [{label}]: S={S}, kv_range {rng_len}, "
              f"{len(np.unique(gid[gid >= 0]))} groups, on every shard")
        pairs = print_segmented_launch(S, cfg.num_heads, gid, starts_t.cpu().numpy(), rng_len)
        out = flash.segmented_block_attention_shard_map(*rep, rng_len, mesh)
        ref = flash.segmented_block_attention_reference(qg, kg, vg, gid_t, starts_t, rng_len)
        err = hold(name, torch.stack([out[dm] for dm in coords]), ref.expand(n, *ref.shape))
        q0, k0, v0, g0, st0 = (x[0, 0] for x in rep)
        qh, kh, vh = (x.transpose(0, 1)[None] for x in (q0, k0, v0))
        mask = (g0[:, None] == g0[None, :])[None, None]

        def library():
            with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        timed_case(name, err, lambda: flash.segmented_block_attention_shard_map(*rep, rng_len, mesh),
                   lambda: flash.segmented_block_attention_reference(q0, k0, v0, g0, st0, rng_len),
                   results, work=(4 * pairs * cfg.num_heads * cfg.head_dim, 4 * nbytes(q0)), library=library,
                   report=label == "full", entry="segmented_block_attention_shard_map", calls=n)
    results["segmented_block_attention_shard_map"]["per_shard"] = dict(S=int(plan["full"][0].numel()),
                                                                        kv_range=plan["full"][2])


def check_mesh_batch_predictors(det, pages, power, devices=None):
    """Detection, layout, table recognition and OCR error on a 2x1 mesh of
    `devices` (default a logical one of cuda:0; rows over the data axis)
    give the unsharded predictors' results on
    the same weights: detection (bf16, the blob detector, det's weights
    copied in) boxes by the IoU rule of hold_boxes; layout labels, table
    rows, columns and cells (row boxes within 1 px) and OCR error labels
    equal, in float32 with TF32 off, so that the row split's other GEMM
    shapes cannot flip a random-weight near-tie (layout cap-bound at
    F32_MAX_BOXES boxes a tile, and its box loop's raw steps held too: the
    same recorded steps and classes, box values within 1). None launches a
    hand-written kernel."""
    mesh = make_mesh(2, 1, devices or [torch.device("cuda", 0)] * 2)
    mdet = DetectionPredictor(mesh=mesh)
    install_blob_detector(mdet)
    mdet.model.load_state_dict(det.model.state_dict())  # phase 19 folded other batch-norm statistics into det's
    reset_counts()
    got, wall = synchronised(mdet, [p.copy() for p in pages])
    base, base_wall = synchronised(det, [p.copy() for p in pages])
    for b, g in zip(base, got):
        hold_boxes(b, g)
    print(f"    detection: {len(pages)} pages, {sum(len(r.bboxes) for r in got)} boxes (unsharded "
          f"{sum(len(r.bboxes) for r in base)}), every page within the IoU rule; wall {wall:.4f} s against "
          f"{base_wall:.4f} s unsharded [{power}]")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lay_pages = bench_pages(2)
        # cap-bound (no class taken for EOS or PAD): every tile records its F32_MAX_BOXES boxes
        capped = dataclasses.replace(layout_config(), eos_token_id=-1, pad_token_id=-1, max_boxes=F32_MAX_BOXES)
        lays = [LayoutPredictor(device="cuda", dtype=torch.float32, config=capped),
                LayoutPredictor(mesh=mesh, dtype=torch.float32, config=capped)]
        tabs = [TableRecPredictor(device="cuda", dtype=torch.float32),
                TableRecPredictor(mesh=mesh, dtype=torch.float32)]
        oes = [OCRErrorPredictor(device="cuda"), OCRErrorPredictor(mesh=mesh)]
        for p in oes:
            p.model.float()
        for a, b in (lays, tabs, oes):
            if not same_weights(a.model, b.model):
                raise AssertionError(f"the meshed {type(b).__name__}'s weights differ")
        labels = [[[b.label for b in r.bboxes] for r in p([pg.copy() for pg in lay_pages])] for p in lays]
        # and the box loop's raw outputs (random weights' labels are mostly
        # special classes, which the clean-up drops)
        tiles, _ = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE).slice(
            [pg.convert("RGB") for pg in lay_pages])
        px = np.stack([lays[0].prepare_image(t) for t in tiles])
        with torch.inference_mode():
            raw = [lays[0]._generate(lays[0]._upload(px))[0].cpu(),
                   lays[1].data_parallel(lambda model, x: lays[1]._generate(x, model)[0], lays[1]._upload(px)).cpu()]
        crops = [pg.crop((100, 100, 868, 868)) for pg in lay_pages]
        tables = []
        for p in tabs:
            install_synthetic_tables(p, TABLE_ROWS, TABLE_COLS, TABLE_CELLS)
            tables.append(p([c.copy() for c in crops]))
        texts = ocr_error_texts(np.random.default_rng(SEED + 3))[0][::4]
        err_labels = [p(texts).labels for p in oes]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = read_counts()
    if labels[0] != labels[1]:
        raise AssertionError(f"layout labels differ on the mesh: {labels[1]} against {labels[0]}")
    valid = raw[0][..., -1] > 0.5
    box_diff = float((raw[0][..., :6] - raw[1][..., :6]).abs()[valid].max()) if valid.any() else 0.0
    if not (torch.equal(valid, raw[1][..., -1] > 0.5) and torch.equal(raw[0][..., 6][valid], raw[1][..., 6][valid])
            and box_diff < 1.0):
        raise AssertionError(f"layout's box loop differs on the mesh (box values up to {box_diff} apart)")
    for t0, t1 in zip(*tables):
        if (len(t0.rows), len(t0.cols), len(t0.cells)) != (len(t1.rows), len(t1.cols), len(t1.cells)):
            raise AssertionError("a table's rows, columns or cells differ on the mesh")
        worst = max(np.abs(np.asarray(a.polygon) - np.asarray(b.polygon)).max() for a, b in zip(t0.rows, t1.rows))
        if worst >= 1.0:
            raise AssertionError(f"a table row box moved {worst} px on the mesh")
    if err_labels[0] != err_labels[1]:
        raise AssertionError("OCR error labels differ on the mesh")
    if any(launches[k] for k in COUNTERS):
        raise AssertionError(f"the batch predictors launched {launches}")
    print(f"    float32: layout {sum(map(len, labels[1]))} boxes on {len(lay_pages)} pages, labels equal, the box "
          f"loop's {int(valid.sum())} recorded steps of {len(tiles)} tiles with equal classes, box values within "
          f"{box_diff:.3e}; tables "
          f"{[(len(t.rows), len(t.cols), len(t.cells)) for t in tables[1]]} (rows, columns, cells) equal, row boxes "
          f"within 1 px; {len(texts)} OCR error labels equal [{power}]")


# -- the web server (phase 24) and the streamlit apps (phase 25) -----------------
# The web server's actions on pages of bench.py's shape, served in this
# process by a make_server() whose registry holds the predictors above: label
# -> (action, extra request keys, the kernels its request must launch). Each
# is posted WEB_POSTS times on each of WEB_PAGES pages.
WEB_PAGES, WEB_POSTS = 2, 2
WEB_ACTIONS = {
    "detect": ("detect", {}, []),
    "ocr": ("ocr", {}, RECOGNITION_KERNELS),
    "ocr skip_text_detection": ("ocr", {"skip_text_detection": True}, RECOGNITION_KERNELS),
    "layout": ("layout", {}, []),
    "table skip_table_detection": ("table", {"skip_table_detection": True}, []),
    "table by layout": ("table", {}, []),
}
# client threads posting ocr at once, and the warm ocr requests of the memory check
WEB_CONCURRENT, WEB_WARM = 4, 10
# `python -m surya_tpu_torch.scripts.web_app`'s arguments, and the seconds
# it may take to print its URL line and to answer its first request
WEB_PROCESS_ARGS, WEB_PROCESS_START_S, WEB_PROCESS_REQUEST_S = ["--port", "0"], 120, 600
# one page drawn by hand, for the PDF upload (where pypdfium2 imports)
ONE_PAGE_PDF = (b"%PDF-1.1\n1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n"
                b"2 0 obj<</Type/Pages/Kids[3 0 R]/Count 1>>endobj\n"
                b"3 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 200 200]>>endobj\n"
                b"trailer<</Root 1 0 R>>\n%%EOF\n")


LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy for the loopback server


def png_body(image, **extra) -> bytes:
    """A web request's JSON body uploading `image` as a PNG."""
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return json.dumps({"file_b64": base64.b64encode(buf.getvalue()).decode(), "filename": "page.png",
                       **extra}).encode()


def http(url: str, body: Optional[bytes] = None, timeout: float = 600):
    """GET (no body) or POST `url`; returns (status, parsed JSON or the raw
    bytes of a page, wall in seconds)."""
    t0 = time.perf_counter()
    request = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with LOCAL.open(request, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:  # an answer with an error status: returned to be checked
        status, raw = e.code, e.read()
    wall = time.perf_counter() - t0
    return status, (json.loads(raw) if raw[:1] in (b"{", b"[") else raw), wall


def direct_result(preds, action, extra, image):
    """The predictor calls that web_app.run_action makes for `action` on an
    image upload (lowres and highres the same image), made here directly;
    the payload's `result`."""
    if action == "detect":
        return preds["detection"]([image])[0].model_dump(exclude={"heatmap", "affinity_map"})
    if action == "layout":
        return preds["layout"]([image])[0].model_dump()
    if action == "ocr":
        kw = ({"bboxes": [[[0, 0, image.width, image.height]]]} if extra.get("skip_text_detection")
              else {"det_predictor": preds["detection"]})
        return preds["recognition"]([image], task_names=["ocr_with_boxes"], highres_images=[image], math_mode=True,
                                    return_words=True, **kw)[0].model_dump()
    if action == "table":
        if extra.get("skip_table_detection"):
            crops = [image]
        else:
            crops = [image.crop(expand_bbox(rescale_bbox(b.bbox, image.size, image.size)))
                     for b in preds["layout"]([image])[0].bboxes if b.label in ("Table", "TableOfContents")]
        return [r.model_dump() for r in preds["table_rec"](crops)]
    raise ValueError(action)


def check_launches(label, counts, launched):
    """The kernels a request (or an app run) launched: each of `launched`,
    and no other; returns the launched ones' counts."""
    counts = {k: v for k, v in counts.items() if k in COUNTERS}
    for n in COUNTERS:
        if (counts[n] > 0) != (n in launched):
            raise AssertionError(f"{label}: launches {counts}, want exactly {launched}")
    return {k: v for k, v in counts.items() if v}


class ReplayStreams:
    """Inside the block, each run of a store of captured loops records the
    store, its thread and the current stream (a stand-in for
    graphs.LoopGraphs.run, in this script only)."""

    def __enter__(self):
        self.calls, original = [], graphs.LoopGraphs.run

        def record(store, key, build, inputs):
            self.calls.append((store, threading.get_ident(), torch.cuda.current_stream().cuda_stream))
            return original(store, key, build, inputs)

        self.original, graphs.LoopGraphs.run = original, record
        return self

    def __exit__(self, *exc):
        graphs.LoopGraphs.run = self.original

    def check(self, pred) -> str:
        """Every replay of pred's decode graphs made on another thread than
        this one (a request handler's) was on pred's stream; returns a
        summary."""
        here = threading.get_ident()
        calls = [(t, s) for store, t, s in self.calls if store is pred.loops and t != here]
        handlers, streams = {t for t, _ in calls}, {s for _, s in calls}
        if not handlers or streams != {pred._stream.cuda_stream}:
            raise AssertionError(f"the handler threads' decode chunks ran on streams {streams}, not only on "
                                 f"recognition's {pred._stream.cuda_stream}")
        return (f"{len(calls)} decode-chunk replays from {len(handlers)} handler threads, all on recognition's "
                f"stream {pred._stream.cuda_stream}")


class GradOutputs:
    """Inside the block, every forward output of the given models' modules
    that carries a grad_fn is counted (by module class)."""

    def __init__(self, models):
        self.models, self.found, self.calls = models, [], 0

    def hook(self, module, args, out):
        self.calls += 1
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.found += [type(module).__name__ for t in outs if isinstance(t, torch.Tensor) and t.grad_fn is not None]

    def __enter__(self):
        self.handles = [m.register_forward_hook(self.hook) for model in self.models for m in model.modules()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def ocr_host_work(preds, page, power):
    """The host work around the predictor call in an ocr request (with
    detection), each part of web_app.run_action's once on `page`: the
    upload's decode, the text render, the word boxes, the two PNG encodes
    and the payload's JSON."""
    req = json.loads(png_body(page))
    t0 = time.perf_counter()
    image, highres, _, _ = web_app._load_input(req)
    t1 = time.perf_counter()
    result = direct_result(preds, "ocr", {}, image)
    lines = result["text_lines"]
    t2 = time.perf_counter()
    rendered = draw_text_on_image([l["bbox"] for l in lines], [l["text"] for l in lines], image.size)
    t3 = time.perf_counter()
    boxed = image.copy()
    draw = ImageDraw.Draw(boxed)
    for line in lines:
        for w in line["words"] or []:
            draw.rectangle(w["bbox"], outline="red", width=2)
    t4 = time.perf_counter()
    images = [web_app._img_b64(rendered), web_app._img_b64(boxed)]
    t5 = time.perf_counter()
    json.dumps({"image_b64": images[0], "word_boxes_b64": images[1], "result": result})
    t6 = time.perf_counter()
    print(f"    an ocr request's host work around the call ({len(lines)} lines): upload decode {t1 - t0:.4f} s, "
          f"text render at {rendered.size[0]}x{rendered.size[1]} {t3 - t2:.4f} s, word boxes {t4 - t3:.4f} s, two "
          f"PNG encodes {t5 - t4:.4f} s ({sum(map(len, images))} base64 bytes), the payload's JSON {t6 - t5:.4f} s; "
          f"in all {t1 - t0 + t6 - t2:.4f} s [{power}]")


def check_web_in_process(preds, pages, power):
    """(a) to (c): a make_server(port=0) of the port with its registry seeded
    with `preds`, served from a thread. Returns the ocr answer on page 0."""
    server = web_app.make_server(port=0)
    for name, p in preds.items():
        server.predictors[name] = p
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stack = contextlib.ExitStack()
    try:
        status, page, _ = http(base + "/")
        status2, health, _ = http(base + "/healthz")
        if status != 200 or b"surya-tpu" not in page or status2 != 200 or health != {"ok": True}:
            raise AssertionError(f"GET / answered {status}, /healthz {status2} {health}")
        status, out, _ = http(base + "/api/nonsense", png_body(pages[0]))
        if status != 404:
            raise AssertionError(f"an unknown action answered {status}: {out}")
        status, out, _ = http(base + "/api/ocr_error", png_body(pages[0]))
        if status != 400 or out != {"error": "This feature only works with PDFs."}:
            raise AssertionError(f"ocr_error on an image answered {status}: {out}")
        print("    GET / 200, /healthz {\"ok\": true}, an unknown action 404, ocr_error on an image 400 "
              "(\"This feature only works with PDFs.\")")

        # every module output from here to (c) is watched for a grad_fn: the
        # first requests of a key run each model's modules in Python (a
        # graph's warm-up and capture), and layout's and table rec's encoders
        # run eagerly in every request; a warm ocr request replays graphs only
        grads = GradOutputs([p.model for p in preds.values()])
        stack.enter_context(grads)

        # (a) every action on every page: the answer against the direct call
        answers = {}
        with ReplayStreams() as replays:
            for label, (action, extra, launched) in WEB_ACTIONS.items():
                walls, direct_walls, first_launches = [], [], None
                for i, image in enumerate(pages):
                    body = png_body(image, **extra)
                    for _ in range(WEB_POSTS):
                        reset_counts()
                        status, out, wall = http(f"{base}/api/{action}", body)
                        if status != 200:
                            raise AssertionError(f"{label} on page {i} answered {status}: {out}")
                        counts = check_launches(f"{label} request", read_counts(), launched)
                        first_launches = first_launches or counts
                        walls.append(wall)
                        answers.setdefault((label, i), out)
                        if out["result"] != answers[(label, i)]["result"]:
                            raise AssertionError(f"{label} on page {i}: two requests answered differently")
                    ref, direct_wall = synchronised(direct_result, preds, action, extra, image.copy())
                    direct_walls.append(direct_wall)
                    if json.loads(json.dumps(ref)) != answers[(label, i)]["result"]:
                        raise AssertionError(f"{label} on page {i}: the answer differs from the direct call")
                warm, direct = float(np.median(walls[1:])), float(np.median(direct_walls))
                what = {"detect": lambda r: f"{len(r['bboxes'])} boxes",
                        "ocr": lambda r: f"{len(r['text_lines'])} lines",
                        "layout": lambda r: f"{len(r['bboxes'])} boxes",
                        "table": lambda r: f"{len(r)} tables, {sum(len(t['cells']) for t in r)} cells"}[action]
                print(f"    {label}: {[what(answers[(label, i)]['result']) for i in range(len(pages))]}, equal to "
                      f"the direct call; first request {walls[0]:.4f} s, warm median {warm:.4f} s over "
                      f"{len(walls) - 1}, the direct call {direct:.4f} s, difference (HTTP, decode, drawing, PNG) "
                      f"{warm - direct:.4f} s; launches {first_launches} [{power}]")
        print(f"    the decode graphs in the requests: {replays.check(preds['recognition'])}")
        ocr_host_work(preds, pages[0], power)

        # (b) concurrent requests: the sequential answer each
        body, ref = png_body(pages[0]), answers[("ocr", 0)]["result"]
        got, errors = [None] * WEB_CONCURRENT, []

        def client(k):
            try:
                got[k] = http(f"{base}/api/ocr", body)
            except BaseException as e:  # re-raised below, in the main thread
                errors.append(e)

        clients = [threading.Thread(target=client, args=(k,)) for k in range(WEB_CONCURRENT)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(c.is_alive() for c in clients) or [g[0] for g in got] != [200] * WEB_CONCURRENT:
            raise AssertionError(f"concurrent ocr requests: statuses {[g and g[0] for g in got]}")
        same = [g[1]["result"] == ref for g in got]
        print(f"    {WEB_CONCURRENT} ocr requests at once: all 200, the sequential answer each: {same}; wall "
              f"{wall:.4f} s, each {[round(g[2], 4) for g in got]} s [{power}]")
        if not all(same):
            raise AssertionError("a concurrent ocr request answered other than the sequential request")

        # (c) memory over warm requests, and no autograd graph in a handler
        needs_grad = {name: sum(q.requires_grad for q in p.model.parameters()) for name, p in preds.items()}
        allocated, calls_before = [], grads.calls
        for _ in range(WEB_WARM):
            status, out, _ = http(f"{base}/api/ocr", body)
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated())
            if status != 200 or out["result"] != ref:
                raise AssertionError(f"a warm ocr request answered {status} or another result")
        stack.close()
        print(f"    {WEB_WARM} warm ocr requests: memory_allocated after each {allocated}; module outputs with a "
              f"grad_fn {len(grads.found)} of {grads.calls} since (a), {grads.calls - calls_before} of them in the "
              f"warm ocr requests; parameters that require grad {needs_grad}")
        if allocated[1] != allocated[-1]:
            raise AssertionError(f"device memory grew over warm requests: {allocated[1]} -> {allocated[-1]}")
        if grads.found or not grads.calls:
            raise AssertionError(f"a request built an autograd graph: {sorted(set(grads.found))}")

        try:
            import pypdfium2  # noqa: F401
        except ImportError:
            print("    PDF upload: not run: no pypdfium2")
        else:
            req = json.dumps({"file_b64": base64.b64encode(ONE_PAGE_PDF).decode(), "filename": "page.pdf"}).encode()
            status, out, wall = http(f"{base}/api/detect", req)
            if status != 200 or len(out["result"]["image_bbox"]) != 4:
                raise AssertionError(f"detect on a PDF answered {status}: {out}")
            print(f"    PDF upload: detect on a one-page PDF 200, image_bbox {out['result']['image_bbox']}, wall "
                  f"{wall:.4f} s [{power}]")
    finally:
        stack.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the web server's thread did not end")


def read_line(stream, deadline: float) -> str:
    """The next line of a child's stdout, or "" if none came before
    `deadline` (perf_counter) or the stream ended."""
    left = deadline - time.perf_counter()
    return stream.readline() if left > 0 and select.select([stream], [], [], left)[0] else ""


def check_web_process(page, power):
    """(d) `python -m surya_tpu_torch.scripts.web_app --port 0` as a process
    of its own at full width with random weights (the checkpoint settings
    pinned to a path that does not exist), with kernel and native build
    directories of its own: the URL line, /healthz, one ocr page with
    detection (both predictors built inside the request; random weights
    find no line on it), then the same page with skip_text_detection, whose
    recognition builds the kernels (nvcc) inside its handler; no traceback
    on its stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, RECOGNITION_MAX_TOKENS=str(PIN_TOKENS), RECOGNITION_PIN_DECODE="true",
                   SURYA_TORCH_BUILD_DIR=str(Path(tmp) / "kernels"),
                   SURYA_TORCH_NATIVE_DIR=str(Path(tmp) / "native"))
        with open(Path(tmp) / "stderr", "w+") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", "surya_tpu_torch.scripts.web_app", *WEB_PROCESS_ARGS],
                                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
            try:
                line = read_line(proc.stdout, t0 + WEB_PROCESS_START_S)
                url_s = time.perf_counter() - t0
                match = re.search(r"http://127\.0\.0\.1:\d+", line)
                if match:
                    status, health, _ = http(match.group(0) + "/healthz", timeout=60)
                    status2, out, wall = http(match.group(0) + "/api/ocr", png_body(page),
                                              timeout=WEB_PROCESS_REQUEST_S)
                    status3, out3, wall3 = http(match.group(0) + "/api/ocr", png_body(page, skip_text_detection=True),
                                                timeout=WEB_PROCESS_REQUEST_S)
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                proc.stdout.close()
            err.seek(0)
            stderr = err.read()
        built = sorted(p.name for p in Path(tmp).glob("*/*.so"))
    if not match:
        raise AssertionError(f"the web server process printed {line!r} after {url_s:.1f} s; stderr:\n"
                             f"{stderr[-3000:]}")
    if status != 200 or health != {"ok": True} or status2 != 200 or status3 != 200 or "Traceback" in stderr:
        raise AssertionError(f"the web server process: /healthz {status} {health}, ocr {status2}, ocr "
                             f"skip_text_detection {status3}; stderr:\n{stderr[-3000:]}")
    if len(out3["result"]["text_lines"]) != 1 or not any(b.startswith("libsurya_kernels_") for b in built):
        raise AssertionError(f"the web server process: {len(out3['result']['text_lines'])} lines without "
                             f"detection, built {built}")
    print(f"    python -m surya_tpu_torch.scripts.web_app {' '.join(WEB_PROCESS_ARGS)} (random weights): URL line "
          f"after {url_s:.4f} s; /healthz 200; the first ocr request {wall:.4f} s (both predictors' builds "
          f"included), {len(out['result']['text_lines'])} lines; then skip_text_detection {wall3:.4f} s (the "
          f"kernels' build in the handler included: {built}), 1 line; no traceback; terminated [{power}]")


def check_web(preds, power):
    """Phase 24: the port's web server on the card, in process and as a process."""
    t0 = time.perf_counter()
    set_pin(True)
    settings.RECOGNITION_MODEL_QUANTIZE = settings.RECOGNITION_WEIGHT_QUANTIZE = False
    pages = bench_pages(WEB_PAGES)
    check_web_in_process(preds, pages, power)
    check_web_process(pages[0], power)
    set_pin(False)
    print(f"    phase 24 took {time.perf_counter() - t0:.1f} s")


class Widget:
    """Any streamlit object the apps use as a context (a column, a tab):
    every attribute is a call that returns another."""

    def __getattr__(self, name):
        return lambda *a, **k: Widget()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Upload(io.BytesIO):
    """What streamlit's file_uploader returns: the bytes and their type."""

    type = "image/png"


def streamlit_stub(upload, shown: list):
    """A stand-in for the streamlit module: the sidebar's file uploader
    returns `upload`, every button is pressed, every checkbox and number
    input keeps its default, and each element the app shows is appended to
    `shown` as (kind, its first argument)."""
    st = types.ModuleType("streamlit")

    def show(kind):
        return lambda *a, **k: shown.append((kind, a[0] if a else None))

    for kind in ("set_page_config", "markdown", "image", "json", "text", "code", "write", "error"):
        setattr(st, kind, show(kind))
    st.cache_resource = st.cache_data = lambda *a, **k: (lambda fn: fn)
    st.columns = lambda spec: tuple(Widget() for _ in spec)
    st.tabs = lambda names: tuple(Widget() for _ in names)

    def stop():
        raise AssertionError("the app stopped: it found no upload")

    st.stop = stop
    st.sidebar = types.SimpleNamespace(file_uploader=lambda *a, **k: upload, button=lambda *a, **k: True,
                                       checkbox=lambda *a, value=False, **k: value,
                                       number_input=lambda *a, value=1, **k: value)
    st.file_uploader = st.sidebar.file_uploader
    return st


def run_app(fn, page, patches):
    """fn() under the streamlit stub with one page uploaded, with each
    (module, attribute, value) of `patches` set for the run; returns what
    the app showed, its wall and the launches."""
    upload = Upload()
    page.save(upload, format="PNG")
    upload.seek(0)
    shown = []
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    previous = sys.modules.get("streamlit")
    sys.modules["streamlit"] = streamlit_stub(upload, shown)
    for m, a, v in patches:
        setattr(m, a, v)
    reset_counts()
    try:
        _, wall = synchronised(fn)
    finally:
        for m, a, v in saved:
            setattr(m, a, v)
        if previous is None:
            del sys.modules["streamlit"]
        else:
            sys.modules["streamlit"] = previous
    return shown, wall, read_counts()


def check_streamlit_apps(preds, power):
    """Phase 25: streamlit_app.main() and texify_app.run() under the stub,
    with every button pressed and one page of bench.py's shape uploaded, on
    the predictors above (load_predictors and RecognitionPredictor patched
    to return them): both run to completion and launch K1, K2 and K3."""
    t0 = time.perf_counter()
    set_pin(True)
    settings.RECOGNITION_MODEL_QUANTIZE = False
    page = bench_pages(1)[0]
    import surya_tpu_torch.models_registry as registry
    import surya_tpu_torch.recognition as recognition

    shown, wall, launches = run_app(streamlit_app.main, page, [(registry, "load_predictors", lambda: preds)])
    counts = check_launches("streamlit_app.main()", launches, RECOGNITION_KERNELS)
    kinds = [k for k, _ in shown]
    images = [v.size for k, v in shown if k == "image"]
    errors = [v for k, v in shown if k == "error"]
    # detection, layout, OCR render and word boxes, table, the upload
    if len(images) != 6 or errors != ["This feature only works with PDFs."] or kinds.count("json") != 4:
        raise AssertionError(f"streamlit_app showed {kinds}: images {images}, errors {errors}")
    print(f"    streamlit_app.main(), every button: {len(images)} images {images}, {kinds.count('json')} JSON "
          f"panels, the bad-text panel's error {errors[0]!r}; wall {wall:.4f} s; launches {counts} [{power}]")
    shown, wall, launches = run_app(texify_app.run, page, [(recognition, "RecognitionPredictor",
                                                            lambda *a, **k: preds["recognition"])])
    counts = check_launches("texify_app.run()", launches, RECOGNITION_KERNELS)
    latex = [v for k, v in shown if k == "code"]
    if len(latex) != 1 or not isinstance(latex[0], str):
        raise AssertionError(f"texify_app showed {[k for k, _ in shown]}")
    print(f"    texify_app.run(): {len(latex[0])} characters of LaTeX; wall {wall:.4f} s; launches {counts} "
          f"[{power}]")
    set_pin(False)
    print(f"    phase 25 took {time.perf_counter() - t0:.1f} s")


def check_bench_workload(gen, power):
    """Phase 26: bench.py's workload through the port, as bench.py drives
    the JAX package (bench.py:50-57, 137-144, 193-256): the port's settings
    read anew from the environment with bench.py's values over it (40
    pinned tokens a line, a 40-step decode chunk, the bf16 KV cache), then
    DetectionPredictor() and RecognitionPredictor() at full width with
    random weights, the detector's blob hook, 16 pages of build_page(); the
    warm-ups det(pages), rec(pages, polygons=...) and rec(pages,
    det_predictor=det), the last with the kernels' first shapes recorded;
    then the best of 3 timed rec(pages, det_predictor=det) calls, each with
    the counts at 0 just before and read just after, and one more under
    torch.profiler for the device's busy share; then the same with the
    decode chunk's eager loop put in place of its graphs (graphs.EagerLoops).
    Every trial must launch K1, K2 and K3 and never K3q, give every page the
    warm-up detection's line count and decode exactly 40 tokens a line. K1,
    K2 and K3 are then held against their plain versions at the recorded
    shapes. Returns (the best graphed trial's launch counts, the held cases'
    results).

    The trials run in three configurations in turn (BENCH_CONFIGS): every
    program graphed (detection's stats program and recognition's prefill
    waves through their ProgramGraphs, the decode chunk through its
    LoopGraphs), the programs eager with the loops graphed (graphs.
    EagerPrograms), and all plain (EagerLoops too): each with its stage
    split and a traced trial's busy share. The kernels' shapes are recorded
    in a warm-up whose prefill runs eagerly."""
    saved = dict(vars(settings))
    vars(settings).update(vars(Settings({**load_dotenv(), **os.environ, **BENCH_ENV})))
    try:
        try:
            pages = [build_page() for _ in range(BENCH_PAGES)]
        except (TypeError, ImportError, OSError) as e:
            raise RuntimeError(f"bench.py's pages are drawn at font_size=22, which needs Pillow >= 10.1 with "
                               f"FreeType; this Pillow cannot: {type(e).__name__}: {e}") from e
        t0 = time.perf_counter()
        det = DetectionPredictor()
        rec = RecognitionPredictor()
        install_blob_detector(det)
        if rec.device.type != "cuda" or det.device.type != "cuda":
            raise AssertionError(f"the predictors run on {det.device} and {rec.device}, not the card")
        if rec.decode_chunk != PIN_TOKENS or settings.RECOGNITION_MODEL_QUANTIZE:
            raise AssertionError(f"decode chunk {rec.decode_chunk}, int8 cache {settings.RECOGNITION_MODEL_QUANTIZE}")
        print(f"    both predictors built in {time.perf_counter() - t0:.1f} s; {BENCH_PAGES} pages of "
              f"{pages[0].size[0]}x{pages[0].size[1]}, decode chunk {rec.decode_chunk}, pinned "
              f"{settings.RECOGNITION_MAX_TOKENS} tokens, bf16 cache")

        t0 = time.perf_counter()
        det_results = det(pages)
        boxes = [len(r.bboxes) for r in det_results]
        polys = [[b.polygon for b in r.bboxes] for r in det_results]
        rec(pages, polygons=polys)
        # the kernels' first shapes, recorded in a call whose prefill waves
        # run eagerly: a replay calls no stand-in, and under a capture the
        # stand-ins' copies would be graph memory
        shapes = MainPathShapes(rec.config.encoder)
        stores = {"rec.programs": rec.programs, "det.programs": det.programs, "rec.loops": rec.loops}
        rec.programs = graphs.EagerPrograms()
        try:
            with shapes:
                rec(pages, det_predictor=det)
        finally:
            rec.programs = stores["rec.programs"]
        rec(pages, det_predictor=det)  # the programs' graphs captured before the first profiler session
        print(f"    warm-ups (det, rec with polygons, rec with det_predictor twice: eager prefill, then graphed) "
              f"{time.perf_counter() - t0:.1f} s; {sum(boxes) / len(boxes):.1f} boxes a page {boxes}")

        def trials(label):
            out = []
            for i in range(BENCH_TRIALS):
                reset_counts()
                profiling.report(reset=True)
                t0 = time.perf_counter()
                results = rec(pages, det_predictor=det)
                wall = time.perf_counter() - t0
                prof, counts, tokens = profiling.report(reset=True), read_counts(), rec.last_decoded_tokens
                n_l = check_lines(results, pages, boxes)  # the warm-up detection's count on every page
                print(f"    {label} trial {i}: {wall:.4f} s, {BENCH_PAGES / wall:.4f} pages/s, {n_l} lines, {tokens} "
                      f"tokens, K1/K2/K3 launches {counts['segmented_block_attention']}/"
                      f"{counts['causal_flash_attention']}/{counts['gqa_decode']} [{power}]")
                if tokens != PIN_TOKENS * n_l:
                    raise AssertionError(f"trial {i}: {tokens} tokens for {n_l} lines, want {PIN_TOKENS} a line")
                assert_launched(f"bench.py's workload, {label} trial {i}", counts,
                                ["segmented_block_attention", "causal_flash_attention", "gqa_decode"],
                                ["gqa_decode_int8"])
                out.append((wall, prof, counts, tokens))
            return out

        def summarise(runs, traced) -> dict:
            wall, prof, counts, tokens = min(runs, key=lambda t: t[0])
            return {"pages_per_s": BENCH_PAGES / wall, "trial_walls_s": [t[0] for t in runs],
                    "decoded_tokens_per_page": tokens / BENCH_PAGES,
                    "stages": {k: {"total_s": v["total_s"], "calls": v["calls"]} for k, v in sorted(prof.items())
                               if "total_s" in v},  # the stages, not the counters beside them
                    "launches": {n: counts[n] for n in ("segmented_block_attention", "causal_flash_attention",
                                                        "gqa_decode", "gqa_decode_int8")},
                    "k1_launches_by_kv_range": counts[K1_BY_RANGE],
                    "traced_trial": {"wall_s": traced[0], "device_busy_share": traced[1]}}

        # the three configurations, in one run: each trial's launches must be
        # the graphed trials' (a replay credits what the eager program counts)
        runs = {}
        for label, (programs_graphed, loops_graphed) in BENCH_CONFIGS.items():
            rec.programs = stores["rec.programs"] if programs_graphed else graphs.EagerPrograms()
            det.programs = stores["det.programs"] if programs_graphed else graphs.EagerPrograms()
            rec.loops = stores["rec.loops"] if loops_graphed else graphs.EagerLoops()
            try:
                out = trials(label)
                runs[label] = summarise(out, busy_share(lambda: rec(pages, det_predictor=det)))
            finally:
                rec.programs, det.programs, rec.loops = stores.values()
            split = {k: round(runs[label]["stages"].get(k, {}).get("total_s", 0.0), 4) for k in BENCH_STAGES}
            print(f"    {label}: best {runs[label]['pages_per_s']:.4f} pages/s, busy "
                  f"{runs[label]['traced_trial']['device_busy_share']:.1%} of a traced trial; stages {split}")
            want = runs[next(iter(BENCH_CONFIGS))]
            for t in out:
                if {n: t[2][n] for n in want["launches"]} != want["launches"] or \
                        t[2][K1_BY_RANGE] != want["k1_launches_by_kv_range"]:
                    raise AssertionError(f"{label}: launches {t[2]} differ from the graphed trials' {want}")
        graphed = runs[next(iter(BENCH_CONFIGS))]
        summary = {
            **graphed, "boxes_per_page": sum(boxes) / len(boxes), "pinned_tokens_per_line": PIN_TOKENS,
            "decode_chunk": rec.decode_chunk,
            **{BENCH_CONFIG_KEYS[label]: r for label, r in list(runs.items())[1:]},
            "decode_graphs": {str(k[2:5]): v for k, v in rec.loops.captures.items()},
            "program_graphs": {program_key_label(k): v for store in (rec.programs, det.programs)
                               for k, v in store.captures.items()},
            "card": power,
        }
        counts = {**graphed["launches"], K1_BY_RANGE: graphed["k1_launches_by_kv_range"]}
        print("BENCH_WORKLOAD " + json.dumps(summary))
        print(f"    program keys captured: {len(rec.programs.captures)} prefill, {len(det.programs.captures)} "
              f"detection; {len(rec.loops.captures)} decode chunk keys")

        print("    K1, K2 and K3 against their plain versions at the shapes of the last warm-up's first wave and "
              "first decode call")
        held = {}
        check_segmented(held, shapes.plan(rec.config.encoder), gen, "bench.py's first wave", report=True)
        check_causal(held, shapes.k2[0], shapes.k2[1], gen, report=True)
        check_decode_main_path(held, gen, {"gqa_decode": shapes.first["gqa_decode"]}, {"gqa_decode": None})
    finally:
        vars(settings).clear()
        vars(settings).update(saved)
    return counts, held


# -- graphed loops against eager loops (phase 28) --------------------------------
# Each AR loop once as the predictors run it on the card (a CUDA graph replay,
# its steps in IF nodes) and once through graphs.EagerLoops, the plain version
# (the same step function, the cond read on the host after each step), on the
# same inputs. The recognition chunk at full width from a random cache of
# GRAPH_SLOTS slots (the production 128 and the trash slot) of GRAPH_CACHE_LEN
# rows, GRAPH_ACTIVE of them decoding, each case: (pinned, repeat window, int8
# cache, int8 weights, slots, cache rows). A repeat window of 1 stops every
# slot at its first step, so the graph's IF nodes skip the chunk's other
# steps. GRAPH_FEW slots of a block's 1536-row cache take K3's cluster
# launches (more than one CTA a (slot, kv head)) inside the IF nodes.
GRAPH_SLOTS, GRAPH_CACHE_LEN, GRAPH_ACTIVE, GRAPH_FEW = 129, 512, 100, 9
GRAPH_CASES = {
    "bf16 cache, pinned": (True, 0, False, False, GRAPH_SLOTS, GRAPH_CACHE_LEN),
    "bf16 cache, free-running": (False, REPEAT_WINDOW, False, False, GRAPH_SLOTS, GRAPH_CACHE_LEN),
    "bf16 cache, free-running, every slot stops at step 0 (repeat window 1)": (False, 1, False, False, GRAPH_SLOTS,
                                                                                 GRAPH_CACHE_LEN),
    "int8 cache (K3q), pinned": (True, 0, True, False, GRAPH_SLOTS, GRAPH_CACHE_LEN),
    "int8 weights, bf16 cache, pinned": (True, 0, False, True, GRAPH_SLOTS, GRAPH_CACHE_LEN),
    "bf16 cache, pinned, few slots of a long cache (K3 clusters)": (True, 0, False, False, GRAPH_FEW, 1536),
    "int8 cache (K3q), pinned, few slots of a long cache (K3q clusters)": (True, 0, True, False, GRAPH_FEW, 1536),
}


def random_slot_cache(model, gen, quantize: bool, slots: int = GRAPH_SLOTS, rows: int = GRAPH_CACHE_LEN) -> dict:
    dec = model.config.decoder
    cache = qwen_decoder.init_cache(dec, slots, rows, torch.bfloat16, "cuda", quantize=quantize)
    for key in ("k", "v"):
        x = torch.randn(cache[key].shape, generator=gen, device="cuda") * 0.5
        if quantize:
            cache[key], cache[f"{key}_scale"] = qwen_decoder.quantize_kv(x)
        else:
            cache[key].copy_(x)
    cache["len"].copy_(torch.randint(64, rows - 2 * PIN_TOKENS, (slots,), generator=gen,
                                     device="cuda", dtype=torch.int32))
    return cache


def pool_mib(store) -> str:
    return ", ".join(f"capture {c['capture_s']:.3f} s, pool {c['pool_bytes'] / 2**20:.1f} MiB"
                     for c in store.captures.values())


def check_graphed_chunks(pred, gen, power):
    """Phase 28, recognition: FoundationModel.launch_chunk on a new
    graphs.LoopGraphs and on graphs.EagerLoops, from two copies of one
    random cache and slot state, twice each (the second replays the graph,
    from the first call's slot state):
    token ids, boxes, the slot state and the cache's bytes and lengths must
    be equal, and the graph must run the eager loop's steps (fewer than K
    where every slot stops early). The few-slot cases must take K3's
    cluster launches."""
    side = torch.cuda.Stream()
    for label, (pin, window, quantize, int8_weights, slots, cache_rows) in GRAPH_CASES.items():
        model = pred.model
        if int8_weights:
            model = copy.deepcopy(pred.model)
            qwen_decoder.quantize_weights(model.decoder)
        dec = model.config.decoder
        launch = check_decode_launch(slots, dec.num_key_value_heads, cache_rows, PIN_TOKENS)
        if slots == GRAPH_FEW and launch["cluster_size"] < 2:
            raise AssertionError(f"{label}: K3 launches {launch}, no cluster")
        cache_g = random_slot_cache(model, gen, quantize, slots, cache_rows)
        cache_e = {k: v.clone() for k, v in cache_g.items()}
        active = torch.zeros(slots, dtype=torch.bool, device="cuda")
        active[torch.randperm(slots - 1, generator=gen, device="cuda")[:min(GRAPH_ACTIVE, slots - 1)]] = True
        state = (torch.randint(4, model.config.vocab_size, (slots,), generator=gen, device="cuda",
                               dtype=torch.int32), active, torch.zeros(slots, dtype=torch.int32, device="cuda"))
        store = graphs.LoopGraphs()
        rows = []
        with torch.cuda.stream(side), torch.inference_mode():
            for call in range(2):
                reset_counts()
                (out_g, ran_g), wall_g = synchronised(model.launch_chunk, cache_g, *state[:2], PIN_TOKENS, state[2],
                                                      window, pin, store)
                steps_g, k3 = ran_g.credit(), read_counts()
                out_g = tuple(t.clone() for t in out_g)
                (out_e, ran_e), wall_e = synchronised(model.launch_chunk, cache_e, *state[:2], PIN_TOKENS, state[2],
                                                      window, pin, graphs.EagerLoops())
                steps_e = ran_e.credit()
                same = [torch.equal(a, b) for a, b in zip(out_g, out_e)]
                kv_same = all(torch.equal(cache_g[k], cache_e[k]) for k in cache_g if k != "len")
                len_same = torch.equal(cache_g["len"], cache_e["len"])
                score_diff = (out_g[1] - out_e[1]).abs().max().item()
                box_diff = (out_g[2] - out_e[2]).abs().max().item()
                rows.append(f"call {call}: steps {steps_g} (eager {steps_e}), K3/K3q credited "
                            f"{k3['gqa_decode']}/{k3['gqa_decode_int8']}, wall {wall_g:.4f} s (eager {wall_e:.4f} s), "
                            f"token ids/state equal {same[0]}/{all(same[3:])}, scores and boxes max |diff| "
                            f"{score_diff:.3e}/{box_diff}, cache bytes equal {kv_same}, len equal {len_same}")
                if not (same[0] and all(same[3:]) and len_same and steps_g == steps_e):
                    raise AssertionError(f"{label}: the graph's chunk differs from the eager loop's: {rows[-1]}")
                if window == 1 and steps_g != (0 if call else 1):  # the second call starts with no slot active
                    raise AssertionError(f"{label}: every slot stops at step 0, yet call {call} ran {steps_g} steps")
                state = tuple(t.clone() for t in out_g[3:])
        print(f"    {label}: {int(active.sum())} of {slots} slots, cache {cache_rows} rows, chunk {PIN_TOKENS}, K3 launch "
              f"{launch}; {pool_mib(store)} [{power}]")
        for row in rows:
            print(f"      {row}")
        del store, cache_g, cache_e, model
        torch.cuda.empty_cache()


# whole calls whose cache lengths alternate, as a server's requests do: a
# line, a square region and a wide line (three prompt buckets of lines), then
# a page-sized block (a longer cache than the kept store), each a name:
# (task, box on ALTERNATE_PAGE); ALTERNATE_ORDER is the calls in turn
ALTERNATE_CALLS = {"line": ("ocr_with_boxes", [4, 4, 200, 40]), "square": ("ocr_with_boxes", [4, 4, 400, 400]),
                   "wide line": ("ocr_with_boxes", [4, 4, 1000, 200]),
                   "page block": ("block_without_boxes", [4, 4, 1100, 1100])}
ALTERNATE_PAGE = (1200, 1200)
ALTERNATE_ORDER = ("wide line", "line", "square") * 3 + ("page block",) + ("line", "page block", "square",
                                                                             "wide line") * 2


def check_alternating_cache_lengths(pred, power):
    """Phase 28, recognition: whole calls (one region each, pinned,
    PIN_TOKENS tokens) whose cache lengths alternate through the predictor's
    own graphs and kept slot-cache store, from an empty store. Each length
    must be captured once while the store is long enough, and a longer one
    replace the store and its graphs once: the calls of three lengths in
    turn capture 3 graphs, the longer call 1, and the four in turn twice 3
    more, no other."""
    saved = (settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_MAX_TOKENS)
    set_pin(True)
    if pred._kept_cache is not None:  # start from no store: its graphs go with it
        pred._forget_cache(pred._kept_cache)
        pred._kept_cache = None
    store, take = pred.loops, pred._take_cache
    captured, lengths = [], {}
    capture = store._capture
    store._capture = lambda *a: captured.append(1) or capture(*a)
    pred._take_cache = lambda *a: lengths.__setitem__(name, a[1]) or take(*a)
    page = Image.new("RGB", ALTERNATE_PAGE, "white")
    reserved = torch.cuda.memory_reserved()
    rows = []
    try:
        for i, name in enumerate(ALTERNATE_ORDER):
            task, box = ALTERNATE_CALLS[name]
            before = len(captured)
            (res,), wall = synchronised(lambda: pred([page], bboxes=[[box]], task_names=[task]))
            rows.append(f"{name} ({lengths[name]} rows): wall {wall:.4f} s, captures {len(captured) - before}")
            if len(res.text_lines) != 1:
                raise AssertionError(f"{name}: {len(res.text_lines)} lines for one region")
            if i in (8, 9, len(ALTERNATE_ORDER) - 1):
                rows[-1] += (f"; after {i + 1} calls {len(captured)} captures, {len(store.loops)} graphs, store "
                             f"{pred._kept_cache['k'].shape[3]} rows, reserved +"
                             f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB")
            if i == 8 and len(captured) != 3:
                raise AssertionError(f"three cache lengths in turn: {len(captured)} captures, not 3")
            if i == 9 and len(captured) != 4:
                raise AssertionError(f"a longer cache: {len(captured)} captures after it, not 4")
    finally:
        store._capture, pred._take_cache = capture, take
        settings.RECOGNITION_PIN_DECODE, settings.RECOGNITION_MAX_TOKENS = saved
    short = sorted({lengths[n] for n in ALTERNATE_ORDER[:3]})
    print(f"    recognition, whole calls alternating cache lengths {short} then {lengths['page block']} rows "
          f"(one region each, pinned, {PIN_TOKENS} tokens, {pred.n_slots + 1}-slot store) [{power}]")
    for row in rows:
        print(f"      {row}")
    if len(short) != 3 or lengths["page block"] <= short[-1]:
        raise AssertionError(f"the calls' cache lengths {lengths} are not three in turn and one longer")
    if len(captured) != 7:
        raise AssertionError(f"{len(captured)} captures over the alternating calls, not 7")


def graphed_against_eager(p, call, label, power):
    """call() through predictor p's graphs, then through graphs.EagerLoops
    put in their place; returns both results."""
    store = p.loops
    out_g, wall_g = synchronised(call)
    run_g = copy.deepcopy(p.last_run)
    p.loops = graphs.EagerLoops()
    try:
        out_e, wall_e = synchronised(call)
    finally:
        p.loops = store
    print(f"    {label}: wall {wall_g:.4f} s (eager {wall_e:.4f} s) [{power}]")
    return (out_g, run_g), (out_e, p.last_run)


def check_graphed_box_loops(lay, tab, pages, power):
    """Phase 28, layout and table rec: the predictors as called, with their
    graphs and with the eager loop, on LAYOUT_PAGES pages of bench.py's
    shape (as called and cap-bound) and on the synthetic tables' crops: the
    results, the box loop's raw outputs and the steps run must be equal."""
    c = lay.config
    tiles, _ = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE).slice([pages[0]])
    tile_pixels = torch.from_numpy(np.stack([lay.prepare_image(t) for t in tiles])).cuda()
    for label, config in (("as called", c), ("cap-bound", dataclasses.replace(c, eos_token_id=-1, pad_token_id=-1))):
        lay.model.config = config
        try:
            (res_g, run_g), (res_e, run_e) = graphed_against_eager(
                lay, lambda: lay([p.copy() for p in pages]), f"layout {len(pages)} pages, {label}", power)
            store = lay.loops
            with torch.inference_mode():
                raw_g, ran_g = lay._generate(tile_pixels)  # a new tensor: the next replay leaves it
                lay.loops = graphs.EagerLoops()
                try:
                    raw_e, ran_e = lay._generate(tile_pixels)
                finally:
                    lay.loops = store
        finally:
            lay.model.config = c
        n = c.label_count
        valid_same = torch.equal(raw_g[..., -1], raw_e[..., -1])
        class_same = torch.equal(raw_g[..., 6], raw_e[..., 6])
        box_diff = (raw_g[..., :6] - raw_e[..., :6]).abs().max().item()
        logit_diff = (raw_g[..., 7:7 + n] - raw_e[..., 7:7 + n]).abs().max().item()
        labels_same = [[b.label for b in r.bboxes] for r in res_g] == [[b.label for b in r.bboxes] for r in res_e]
        bitwise = [r.model_dump() for r in res_g] == [r.model_dump() for r in res_e]
        steps = (run_g["steps"], run_e["steps"], ran_g.credit(), ran_e.credit())
        print(f"      steps by dispatch {steps[0]} (eager {steps[1]}); labels equal {labels_same}, results equal "
              f"bit for bit {bitwise}; one page's tiles: steps {steps[2]} (eager {steps[3]}), valid equal "
              f"{valid_same}, classes equal {class_same}, boxes max |diff| {box_diff:.3e}, logits max |diff| "
              f"{logit_diff:.3e}")
        if not (labels_same and valid_same and class_same and steps[0] == steps[1] and steps[2] == steps[3]):
            raise AssertionError(f"layout {label}: the graphed box loop differs from the eager loop")
    print(f"      layout graphs: {pool_mib(lay.loops)}")
    crops = [p.crop((100, 100, 868, 868)) for p in pages[:TABLE_CROPS]]
    (res_g, run_g), (res_e, run_e) = graphed_against_eager(
        tab, lambda: tab([c.copy() for c in crops]), f"table rec {len(crops)} synthetic tables", power)
    passes = [[(p["rows"], p["steps"], p["recorded"]) for p in r["passes"]] for r in (run_g, run_e)]
    shape = [[(len(r.rows), len(r.cols), len(r.cells)) for r in res] for res in (res_g, res_e)]
    bitwise = [r.model_dump() for r in res_g] == [r.model_dump() for r in res_e]
    print(f"      passes (rows, steps, recorded) {passes[0]} (eager {passes[1]}); rows, columns and cells "
          f"{shape[0]} (eager {shape[1]}); results equal bit for bit {bitwise}")
    print(f"      table rec graphs: {pool_mib(tab.loops)}")
    if shape[0] != shape[1] or passes[0] != passes[1]:
        raise AssertionError("table rec: the graphed box loops differ from the eager loops")


def busy_share(fn) -> tuple:
    """fn() under torch.profiler: (its wall, the device's busy time over it:
    the union of its kernel, copy and memset intervals), as profile_smoke.py
    measures it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = synchronised(fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device events")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s_, e_
        else:
            cur_e = max(cur_e, e_)
    return wall, (busy + cur_e - cur_s) / 1e6 / wall


# -- one-shot programs as CUDA graphs against their plain version (phase 29) -----
# Detection's stats and maps programs and recognition's prefill wave, each
# through a new graphs.ProgramGraphs (captured at its first call, replayed at
# the second) and through graphs.EagerPrograms, the plain version (the same
# body run eagerly, the flood's loop read on the host), on the same inputs;
# every output must be equal, bit for bit. The spiral: a rectangular spiral
# of SPIRAL_PITCH px, whose label creeps one arm a round.
PROGRAM_PAGES, SPIRAL_PITCH = 4, 48


def program_key_label(key) -> str:
    """A program store's key, short: the program, its flags and shapes."""
    if isinstance(key, str):
        return key
    if key[0] == "table_encode":
        return f"table rec encode pixels={list(key[2])}"
    if key[0] == "ocr_error":
        return f"OCR error forward input_ids={list(key[2][0])}"
    if key[0] == "prefill":
        shapes = {name: shape for name, shape, _ in key[7:]}
        return (f"prefill rows={shapes['input_ids'][0]} L={shapes['input_ids'][1]} patches={shapes['patches'][0]} "
                f"kv_range={key[2]} win_range={key[3]} pin={key[4]}")
    if key[0] == "meshed_prefill":
        shapes = {name: shape for name, shape, _ in key[9:]}
        return (f"meshed prefill {key[2][0]}x{key[2][1]} rows a shard={shapes['input_ids/0,0'][0]} "
                f"L={shapes['input_ids/0,0'][1]} patches a shard={list(shapes['patches/0,0'])} kv_range={key[3]} "
                f"win_range={key[4]} sharded={key[5]} pin={key[6]}")
    shapes = {name: shape for name, shape, _ in key[2:]}
    return (f"detection {key[0][0]}{list(key[0][1:])} pixels={list(shapes['pixels'])}"
            + (f" pages={list(shapes['page_gather'])}" if "page_gather" in shapes else ""))


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|, equal elements (infinities too) counting 0."""
    if not a.numel():
        return 0.0
    a, b = a.float(), b.float()
    return torch.where(a == b, 0.0, (a - b).abs()).max().item()


def store_report(store) -> str:
    """Each key of a program store: its capture's seconds (build, warm-up
    and capture), the memory its warm-up reserved outside the graphs and
    the growth of the store's shared pools; then the pools' size."""
    keys = "; ".join(f"{program_key_label(k)}: capture {c['capture_s']:.3f} s, warm-up +{c['warm_up_bytes'] / 2**20:.1f} "
                     f"MiB, pools +{c['pool_bytes'] / 2**20:.1f} MiB" for k, c in store.captures.items())
    return f"{keys}; the store's pools {store.pool_bytes() / 2**20:.1f} MiB" if store.captures else "no key"


def spiral_page(width=1240, height=1754) -> Image.Image:
    """A page whose one dark line winds inward as a rectangular spiral."""
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    x0, y0, x1, y1 = 60, 60, width - 60, height - 60
    while x1 - x0 > 2 * SPIRAL_PITCH and y1 - y0 > 2 * SPIRAL_PITCH:
        for box in ((x0, y0, x1, y0 + 6), (x1 - 6, y0, x1, y1), (x0, y1 - 6, x1, y1),
                    (x0, y0 + SPIRAL_PITCH, x0 + 6, y1)):
            draw.rectangle(box, fill="black")
        draw.rectangle((x0, y0 + SPIRAL_PITCH, x0 + SPIRAL_PITCH, y0 + SPIRAL_PITCH + 6), fill="black")
        x0, y0, x1, y1 = x0 + SPIRAL_PITCH, y0 + SPIRAL_PITCH, x1 - SPIRAL_PITCH, y1 - SPIRAL_PITCH
    return img


def detection_inputs(det, images, resize: bool):
    """One detection batch's program inputs on the card, as batch_detection
    builds them: (pixels, (Vs, Hs, gid) or None, page_gather, valid_rows,
    rows with a chunk)."""
    proc_h = det.processor_size[0]
    splits = [get_total_splits(im.size, proc_h) for im in images]
    parts, index, heights = [], [], []
    for i, im in enumerate(images):
        chunks, h = split_image(im.convert("RGB"), proc_h)
        parts += chunks
        index += [i] * len(chunks)
        heights += h
    rows = 1 << (len(parts) - 1).bit_length()
    if resize:
        pixels, (uniq, gid) = det._canvas(parts, rows)
        mats = (*det._resize_mats(uniq, 1 << (len(uniq) - 1).bit_length(), pixels.shape[1:3]), det._upload(gid))
    else:
        pixels, mats = det._prepared(parts, rows), None
    page_gather, valid_rows = det._page_plan(index, heights, splits, list(range(len(images))))
    return det._upload(pixels), mats, det._upload(page_gather), det._upload(valid_rows), len(parts)


def graph_and_plain(owner, attr, call, label, power, calls=2):
    """call() with owner.attr a new ProgramGraphs (capture, then replays),
    then with an EagerPrograms in its place, `calls` times each, the
    outputs copied after each call: every output must be equal. Returns the
    graphed store and its last outputs."""
    saved, store = getattr(owner, attr), graphs.ProgramGraphs()
    outs = {}
    try:
        for name, programs in (("graph", store), ("plain", graphs.EagerPrograms())):
            setattr(owner, attr, programs)
            outs[name] = []
            for _ in range(calls):
                out, wall = synchronised(call)
                outs[name].append(([t.clone() for t in out], wall))
    finally:
        setattr(owner, attr, saved)
    rows = []
    for i, ((g, wg), (e, we)) in enumerate(zip(outs["graph"], outs["plain"])):
        diff = max(max_diff(a, b) for a, b in zip(g, e))
        equal = all(torch.equal(a, b) for a, b in zip(g, e))
        rows.append(f"call {i}: outputs equal {equal} (max |diff| {diff}), wall {wg:.4f} s (plain {we:.4f} s)")
        if not equal:
            raise AssertionError(f"{label}: the graph's outputs differ from the plain program's: {rows[-1]}")
    print(f"    {label}: {'; '.join(rows)}; {store_report(store)} [{power}]")
    return store, outs["graph"][-1][0]


def check_detection_programs(det, power):
    """Phase 29, detection: the stats program with and without the device
    resize on PROGRAM_PAGES pages of build_page() and on a spiral page (its
    flood's blocks counted on the card and on the host), and the maps
    program; then the flood alone on the spiral page's mask."""
    pages = [build_page() for _ in range(PROGRAM_PAGES)]
    for label, images in (("build_page() pages", pages), ("a spiral page", [spiral_page()])):
        for resize in (False, True):
            with det._on_stream(), torch.inference_mode():
                pixels, mats, page_gather, valid_rows, n_real = detection_inputs(det, images, resize)

                def stats():
                    return (det._stats_program(pixels, mats, page_gather, valid_rows, settings.DETECTOR_MAX_COMPONENTS),)

                _, (result,) = graph_and_plain(det, "programs", stats, f"stats program, {label}, "
                                               f"{'device' if resize else 'host'} resize", power)
                result = result.cpu()
                print(f"      components a page {result[:len(images), -3].int().tolist()} (raw "
                      f"{result[:len(images), -2].int().tolist()}), thresholds "
                      f"{[round(v, 4) for v in result[:len(images), -1].tolist()]}")
                if (result[:len(images), -3] < 1).any():
                    raise AssertionError(f"stats program, {label}: a page without components")
    with det._on_stream(), torch.inference_mode():
        pixels, mats, _, _, n_real = detection_inputs(det, pages, True)
        graph_and_plain(det, "programs", lambda: (det._maps_program(pixels, mats, n_real, 2),),
                        f"maps program, {PROGRAM_PAGES} pages, 2 maps", power)

        # the flood alone, on the spiral page's head-resolution mask
        heat = det._heat(*detection_inputs(det, [spiral_page(896, 896)], True)[:2])[:1, 0]
        mask = heat > 0.5

        def flood_program():
            x = graphs.static_inputs({"mask": mask}, mask.device)
            out = (torch.empty(mask.shape, dtype=torch.int64, device=mask.device),
                   torch.empty((), dtype=torch.int32, device=mask.device))

            def body():
                labels, blocks = cc.flood(x["mask"])
                out[0].copy_(labels)
                out[1].copy_(blocks)

            return graphs.Program(x, out, body)

        store, outs = graphs.ProgramGraphs(), {}
        for name, programs in (("graph", store), ("plain", graphs.EagerPrograms())):
            for _ in range(2):
                res, wall = synchronised(lambda: programs.run("flood", flood_program, {"mask": mask}))
                outs[name] = (res[0].clone(), int(res[1]), wall)
        (lg, bg, wg), (le, be, we) = outs["graph"], outs["plain"]
        n_comp = int(((lg.reshape(-1) > 0) & (lg.reshape(-1) == torch.arange(1, lg.numel() + 1, device=lg.device))).sum())
        print(f"    the flood alone on the spiral's mask {list(mask.shape)}: {bg} blocks of {cc.ROUNDS_PER_CHECK} rounds "
              f"on the card's WHILE node, {be} on the host's loop; labels equal {torch.equal(lg, le)}, "
              f"{n_comp} components; wall {wg:.4f} s (host loop {we:.4f} s); {store_report(store)} [{power}]")
        if not torch.equal(lg, le) or bg != be or bg < 2:
            raise AssertionError(f"the flood's WHILE node: {bg} blocks (host {be}), labels equal {torch.equal(lg, le)}")


def check_prefill_programs(pred, det, power):
    """Phase 29, recognition: one prefill wave of the lines of 2 pages of
    build_page() into a slot cache whose other slots hold random rows and
    decode, alone and fused with its decode chunk, pinned and
    free-running: the packed outputs, the slot state and the cache's bytes
    and lengths through the graphs (ProgramGraphs and the decode chunk's
    LoopGraphs) against the eager program and loop, twice each."""
    pages = [build_page() for _ in range(2)]
    flat = pred.detect_and_slice_bboxes([p.copy() for p in pages], ["ocr_with_boxes"] * 2, det)
    batch, n = first_wave(pred, flat)
    rows = batch.input_ids.shape[0]
    n_slots = pred.n_slots + 1
    cache_len = -(-(batch.input_ids.shape[1] + PIN_TOKENS) // 256) * 256
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    rng = np.random.default_rng(SEED + 29)
    slot_idx = np.full(rows, n_slots - 1, np.int32)
    slot_idx[batch.valid_rows] = rng.permutation(n_slots - 1)[:n]
    row_valid = np.zeros(rows, bool)
    row_valid[batch.valid_rows] = True
    dec = pred.config.decoder
    base = qwen_decoder.init_cache(dec, n_slots, cache_len, pred.dtype, "cuda")
    others = torch.from_numpy(~np.isin(np.arange(n_slots), slot_idx)).cuda()
    for key in ("k", "v"):
        base[key].copy_(torch.randn(base[key].shape, generator=gen, device="cuda") * 0.5)
    base["len"].copy_(torch.where(others, torch.randint(8, 64, (n_slots,), generator=gen, device="cuda",
                                                        dtype=torch.int32), 0))
    state0 = (torch.randint(4, pred.config.vocab_size, (n_slots,), generator=gen, device="cuda", dtype=torch.int32),
              others.clone(), torch.ones(n_slots, dtype=torch.int32, device="cuda"))
    kill = rng.random(n_slots) < 0.05
    print(f"    a wave of {n} lines ({rows} rows, L={batch.input_ids.shape[1]}, {batch.patches.shape[0]} patches, "
          f"kv_range {batch.layout.kv_range}) into {n_slots} slots of {cache_len} rows, "
          f"{int(others.sum())} other slots decoding, {int(kill.sum())} killed")
    for pin in (True, False):
        for fuse in (False, True):
            label = f"prefill{' + decode chunk' if fuse else ''}, {'pinned' if pin else 'free-running'}"
            results = {}
            for name, programs, loops in (("graph", graphs.ProgramGraphs(), graphs.LoopGraphs()),
                                          ("plain", graphs.EagerPrograms(), graphs.EagerLoops())):
                cache = {k: v.clone() for k, v in base.items()}
                saved = (pred.programs, pred.loops)
                pred.programs, pred.loops = programs, loops
                try:
                    runs, state = [], state0
                    with pred._on_stream(), torch.inference_mode():
                        for call in range(2):
                            (handle, state, ran), wall = synchronised(
                                pred._dispatch_prefill, cache, batch, slot_idx, row_valid, state, kill, pin, fuse)
                            state = tuple(t.clone() for t in state)
                            runs.append(([torch.from_numpy(a.copy()) for a in pred._wait(handle)],
                                         [t.cpu() for t in state], wall, ran.credit() if ran else 0))
                finally:
                    pred.programs, pred.loops = saved
                results[name] = (runs, {k: v.clone() for k, v in cache.items()}, programs)
            (g_runs, g_cache, g_store), (e_runs, e_cache, _) = results["graph"], results["plain"]
            rows_out = []
            for i, (g, e) in enumerate(zip(g_runs, e_runs)):
                same = [torch.equal(a, b) for a, b in zip(g[0] + g[1], e[0] + e[1])]
                diff = max(max_diff(a, b) for a, b in zip(g[0], e[0]))
                rows_out.append(f"call {i}: packed and state equal {all(same)} (max |diff| {diff}), steps "
                                f"{g[3]}/{e[3]}, wall {g[2]:.4f} s (plain {e[2]:.4f} s)")
                if not all(same) or g[3] != e[3]:
                    raise AssertionError(f"{label}: the graphs differ from the plain programs: {rows_out[-1]}")
            kv_diff = max(max_diff(g_cache[k], e_cache[k]) for k in ("k", "v"))
            cache_same = all(torch.equal(g_cache[k], e_cache[k]) for k in g_cache)
            print(f"    {label}: {'; '.join(rows_out)}; cache bytes and lengths equal {cache_same} (max |diff| "
                  f"{kv_diff}); {store_report(g_store)} [{power}]")
            if not cache_same:
                raise AssertionError(f"{label}: the graphs' slot cache differs from the plain programs'")


def check_streaming_capture(pred, det, power):
    """Phase 29: whole-page OCR through the streaming path, its second page
    group of another page size than the first, so that the detection
    worker thread captures the new group's detection program while the main
    thread replays recognition's graphs; the lines equal the same call's
    with every program eager."""
    pages = synthetic_full_pages(np.random.default_rng(SEED + 30), PIPELINE_PAGES) + bench_pages(PIPELINE_PAGES)
    saved = (settings.RECOGNITION_DET_PIPELINE_PAGES, pred.programs, det.programs)
    settings.RECOGNITION_DET_PIPELINE_PAGES = PIPELINE_PAGES
    set_pin(True)
    threads, outs = [], {}
    try:
        for name, make in (("graph", graphs.ProgramGraphs), ("plain", graphs.EagerPrograms)):
            pred.programs, det.programs = make(), make()
            if name == "graph":
                capture = det.programs._capture

                def on_thread(*args, _capture=capture):
                    threads.append(threading.current_thread().name)
                    return _capture(*args)

                det.programs._capture = on_thread
            results, wall = synchronised(lambda: pred([p.copy() for p in pages], det_predictor=det))
            outs[name] = ([[(ln.text, ln.confidence, ln.polygon) for ln in r.text_lines] for r in results], wall,
                          det.programs, pred.programs)
    finally:
        settings.RECOGNITION_DET_PIPELINE_PAGES, pred.programs, det.programs = saved
    (g, wg, g_det, g_rec), (e, we, _, _) = outs["graph"], outs["plain"]
    workers = [t for t in threads if t != threading.main_thread().name]
    print(f"    streaming, {len(pages)} pages in groups of {PIPELINE_PAGES} (1024x1024, then 1240x1754): "
          f"{len(threads)} detection captures, {len(workers)} on the worker thread; lines equal {g == e} "
          f"({sum(len(r) for r in g)} lines); wall {wg:.4f} s (eager programs {we:.4f} s) [{power}]")
    print(f"      detection: {store_report(g_det)}")
    print(f"      recognition: {store_report(g_rec)}")
    if g != e or not workers:
        raise AssertionError(f"streaming capture: lines equal {g == e}, worker-thread captures {len(workers)}")


# -- the last jitted programs as CUDA graphs against their plain version (phase 30) --
# Layout's whole generate (the encoder inside its box loop's graph), table
# rec's encode and OCR error's forward, each through a new store (captured at
# its first call, replayed at the second) and through the plain one
# (graphs.EagerLoops / EagerPrograms) on the same inputs, twice each; then the
# meshed decode chunk at production width on a 2x2 logical mesh of cuda:0 from
# a random sharded cache of MESH_GRAPH_SLOTS slots (the meshed predictor's 128
# and the trash slot, aligned to the data axis), GRAPH_ACTIVE of them
# decoding, each case (pinned, repeat window, int8 cache), against the eager
# meshed loop and the unsharded chunk's graph on the same inputs.
MESH_GRAPH_SLOTS = 130
MESH_GRAPH_CASES = {
    "bf16 cache, pinned": (True, 0, False),
    "bf16 cache, free-running": (False, REPEAT_WINDOW, False),
    "int8 cache (K3q), pinned": (True, 0, True),
    "int8 cache (K3q), free-running": (False, REPEAT_WINDOW, True),
    "bf16 cache, every slot stops at step 0 (repeat window 1)": (False, 1, False),
}


def loop_key_label(key) -> str:
    """A loop store's key, short."""
    if key[0] == "layout":
        return f"layout pixels={list(key[2])} {key[3]}"
    if key[0] == "table_rec":
        shapes = {name: shape for name, shape, _ in key[4:]}
        return (f"table rec pass rows={shapes['vectors'][0]} L={shapes['vectors'][1]} tables={shapes['states'][0]} "
                f"steps={shapes['script'][0]}")
    if key[0] == "meshed_decode_chunk":
        return (f"meshed chunk {key[2][0]}x{key[2][1]}, slots a shard {list(key[3])}, K={key[4]}, pin={key[5]}, "
                f"window={key[6]}")
    return str(key[0])


def loops_report(store) -> str:
    """Each key of a loop store: its capture's seconds and the memory
    reserved meanwhile; then the size of the pools its graphs share."""
    keys = "; ".join(f"{loop_key_label(k)}: capture {c['capture_s']:.3f} s, +{c['pool_bytes'] / 2**20:.1f} MiB"
                     for k, c in store.captures.items())
    return f"{keys}; the store's pools {store.pool_bytes() / 2**20:.1f} MiB" if store.captures else "no key"


def check_layout_program(lay, pages, power):
    """Phase 30, layout: the whole generate (uint8 tiles in, the encoder and
    the box loop one graph) through a new LoopGraphs and through the eager
    loop, on two batches of 8 tiles of `pages` (the predictor's dispatches),
    as called and cap-bound: valid flags, classes and steps run must be
    equal; box and logit differences are printed."""
    c = lay.config
    slicer = ImageSlicer(settings.LAYOUT_SLICE_MIN, settings.LAYOUT_SLICE_SIZE)
    tiles, _ = slicer.slice([p.convert("RGB") for p in pages[:8]])
    pixels = lay.gray_ship(np.stack([lay.prepare_image(t) for t in tiles]))
    batches = [torch.from_numpy(np.ascontiguousarray(pixels[i:i + 8])).cuda() for i in (0, 8)]
    n = c.label_count
    saved = lay.loops
    for label, config in (("as called", c), (f"cap-bound ({c.max_boxes} steps)",
                                             dataclasses.replace(c, eos_token_id=-1, pad_token_id=-1))):
        lay.model.config = config
        store, runs = graphs.LoopGraphs(), {}
        try:
            for name, loops in (("graph", store), ("plain", graphs.EagerLoops())):
                lay.loops, runs[name] = loops, []
                with torch.inference_mode():
                    for px in batches:
                        (packed, ran), wall = synchronised(lay._generate, px)
                        runs[name].append((packed, ran.credit(), wall))
        finally:
            lay.model.config, lay.loops = c, saved
        rows = []
        for i, ((g, sg, wg), (e, se, we)) in enumerate(zip(runs["graph"], runs["plain"])):
            same = torch.equal(g[..., -1], e[..., -1]) and torch.equal(g[..., 6], e[..., 6])
            rows.append(f"call {i}: {tuple(batches[i].shape)} uint8, steps {sg} (plain {se}), valid and classes equal "
                        f"{same}, boxes max |diff| {max_diff(g[..., :6], e[..., :6]):.3e}, logits max |diff| "
                        f"{max_diff(g[..., 7:7 + n], e[..., 7:7 + n]):.3e}, wall {wg:.4f} s (plain {we:.4f} s)")
            if not same or sg != se:
                raise AssertionError(f"layout {label}: the graph differs from the eager program: {rows[-1]}")
        print(f"    layout, {label}: {'; '.join(rows)}; {loops_report(store)} [{power}]")
        del store
    print(f"    layout, the predictor's own graphs after phases 13, 22 and 28 ({len(lay.loops.captures)} keys): "
          f"{loops_report(lay.loops)}")


def check_table_encode_program(tab, pages, power):
    """Phase 30, table rec: the encode program (uint8 crops in, the states
    out) through a new ProgramGraphs and eagerly on the 4 synthetic crops,
    twice each: the states must be equal; then whole calls with the
    encoder graphed and eager: the rows, columns and cells of every table
    and the rows and steps of both passes must be equal."""
    crops = [p.crop((100, 100, 868, 868)) for p in pages[:TABLE_CROPS]]
    px = torch.from_numpy(tab.gray_ship(np.stack([tab.prepare_image(cr.convert("RGB")) for cr in crops]))).cuda()
    with torch.inference_mode():
        graph_and_plain(tab, "programs", lambda: (tab._encode(px),),
                        f"table rec encode, {TABLE_CROPS} crops {tuple(px.shape)} uint8", power)
    saved, runs = tab.programs, {}
    try:
        for name, programs in (("graph", graphs.ProgramGraphs()), ("plain", graphs.EagerPrograms())):
            tab.programs = programs
            tab([cr.copy() for cr in crops])
            res, wall = synchronised(tab, [cr.copy() for cr in crops])
            run = tab.last_run
            runs[name] = ([(len(r.rows), len(r.cols), len(r.cells)) for r in res],
                          [(p["rows"], p["steps"], p["recorded"]) for p in run["passes"]], wall,
                          run["encode_enqueue_s"], [r.model_dump() for r in res])
    finally:
        tab.programs = saved
    g, e = runs["graph"], runs["plain"]
    print(f"    table rec, whole calls: tables (rows, columns, cells) {g[0]} (plain {e[0]}); passes (rows, steps, "
          f"recorded) {g[1]} (plain {e[1]}); results equal bit for bit {g[4] == e[4]}; wall {g[2]:.4f} s (plain "
          f"{e[2]:.4f} s); the encoder's enqueue {g[3]:.4f} s (plain {e[3]:.4f} s) [{power}]")
    if g[0] != e[0] or g[1] != e[1]:
        raise AssertionError("table rec: the graphed encoder's tables differ from the eager encoder's")


def check_ocr_error_program(oe, power):
    """Phase 30, OCR error: the forward program of the first 64 texts made
    for each sequence bucket (bucketed by the predictor's tokenizer, since
    phase 19 gave it a checkpoint's vocabulary) through a new ProgramGraphs
    and eagerly, twice each (labels equal, the logits' max |diff|
    printed); then the 256 texts through the predictor with the forward
    graphed and eager, three calls each in turns: labels equal, texts/s and
    the tokenizer's own time printed."""
    texts, buckets = ocr_error_texts(np.random.default_rng(SEED + 3))
    rows = oe.get_batch_size()
    store, worst = graphs.ProgramGraphs(), {}
    for b in OCR_ERROR_WORDS:  # the texts made for a bucket; the predictor's tokenizer decides theirs
        enc = oe.processor([t for t, x in zip(texts, buckets) if x == b][:rows],
                           max_length=oe.config.max_position_embeddings)
        n = len(enc["input_ids"][0])
        L = next(s for s in OCR_ERROR_SEQ_BUCKETS if s >= n)
        ids = torch.from_numpy(np.pad(np.asarray(enc["input_ids"], np.int32), ((0, 0), (0, L - n)))).cuda()
        mask = torch.from_numpy(np.pad(np.asarray(enc["attention_mask"], np.int32), ((0, 0), (0, L - n)))).cuda()
        with torch.inference_mode():
            for call in range(2):
                g = oe.model.launch_forward(ids, mask, store).clone()
                e = oe.model.launch_forward(ids, mask, graphs.EagerPrograms())
                if not torch.equal(g.argmax(1), e.argmax(1)):
                    raise AssertionError(f"OCR error, bucket {L}: the graph's labels differ from the eager forward's")
                worst[L] = max(worst.get(L, 0.0), max_diff(g, e))
    t0 = time.perf_counter()
    for lo in range(0, len(texts), rows):
        oe.processor(texts[lo:lo + rows], max_length=oe.config.max_position_embeddings)
    tokenize = time.perf_counter() - t0
    stores, saved = {"graph": graphs.ProgramGraphs(), "plain": graphs.EagerPrograms()}, oe.programs
    labels, rates = {}, {"graph": [], "plain": []}
    try:
        for name, programs in stores.items():  # warm-ups: the graph's captures
            oe.programs = programs
            labels[name] = oe(texts).labels
        for name in ("graph", "plain", "plain", "graph", "graph", "plain"):  # in turns: the host's pace drifts
            oe.programs = stores[name]
            res, wall = synchronised(oe, texts)
            rates[name].append(round(len(texts) / wall, 1))
            if res.labels != labels["plain"]:
                raise AssertionError(f"OCR error: the {name} forward's labels differ from the eager forward's")
    finally:
        oe.programs = saved
    print(f"    OCR error: forward of {rows} rows a bucket, logits max |diff| by bucket {worst}, labels equal; "
          f"{store_report(store)}; {len(texts)} texts in batches {oe.last_run['batches']}: labels equal "
          f"{labels['graph'] == labels['plain']}, texts/s graphed {rates['graph']}, eager {rates['plain']}, in turns; "
          f"the tokenizer alone {tokenize:.4f} s [{power}]")
    if labels["graph"] != labels["plain"]:
        raise AssertionError("OCR error: the graphed forward's labels differ from the eager forward's")


def check_meshed_chunk(pred, gen, power):
    """Phase 30, the meshed decode chunk: MeshedFoundation.launch_chunk on a
    2x2 logical mesh of cuda:0 through a new LoopGraphs (each step in an IF
    node, the cond reduced over every shard on the card) and through the
    eager meshed loop, from copies of one random sharded cache and slot
    state, twice each (the second from the first call's state): token ids,
    scores, boxes, slot state, the cache's bytes and lengths and the steps
    run must be equal, and the K3 (K3q) launches credited must be the steps
    run times layers times shards. Against the unsharded chunk's graph on
    the same inputs: the steps run and cache lengths where the state
    decides them (pinned, every slot stopping at step 0) must be equal;
    the share of slots whose token ids agree is printed (random weights'
    near-ties flip under other GEMM shapes and sums). The walls are
    printed, meshed against unsharded."""
    mesh = make_mesh(2, 2, [torch.device("cuda", 0)] * 4)
    meshed = MeshedFoundation(pred.model, mesh)
    layers, shards = pred.config.decoder.num_hidden_layers, len(mesh.coords())
    side = torch.cuda.Stream()
    for label, (pin, window, quantize) in MESH_GRAPH_CASES.items():
        base = random_slot_cache(pred.model, gen, quantize, MESH_GRAPH_SLOTS)
        active = torch.zeros(MESH_GRAPH_SLOTS, dtype=torch.bool, device="cuda")
        active[torch.randperm(MESH_GRAPH_SLOTS - 1, generator=gen, device="cuda")[:GRAPH_ACTIVE]] = True
        state0 = (torch.randint(4, pred.config.vocab_size, (MESH_GRAPH_SLOTS,), generator=gen, device="cuda",
                                dtype=torch.int32), active, torch.zeros(MESH_GRAPH_SLOTS, dtype=torch.int32,
                                                                          device="cuda"))
        counter = "gqa_decode_shard_map_int8" if quantize else "gqa_decode_shard_map"
        store, runs, caches = graphs.LoopGraphs(), {}, {}
        with torch.cuda.stream(side), torch.inference_mode():
            for name, loops in (("graph", store), ("eager", graphs.EagerLoops())):
                cache = {k: Sharded.split(v, mesh, qwen_decoder.CACHE_SPECS[k]) for k, v in base.items()}
                state = [Sharded.split(t, mesh, qwen_decoder.ROWS_SPEC).shards for t in state0]
                runs[name] = []
                for call in range(2):
                    reset_counts()
                    (outs, ran), wall = synchronised(meshed.launch_chunk, cache, state[0], state[1], PIN_TOKENS,
                                                     state[2], window, pin, loops)
                    steps, counts = ran.credit(), read_counts()
                    for m in range(mesh.n_model):  # every model shard keeps the same slot state
                        if not all(torch.equal(o[d, m], o[d, 0]) for o in outs[3:] for d in range(mesh.n_data)):
                            raise AssertionError(f"{label}: model shard {m} holds another slot state")
                    gathered = [torch.cat([o[d, 0] for d in range(mesh.n_data)]) for o in outs]
                    runs[name].append((gathered, steps, counts[counter], wall))
                    state = [{dm: t.clone() for dm, t in x.items()} for x in outs[3:]]
                caches[name] = {k: v.gather() for k, v in cache.items()}
            ucache, ustore, ustate, uruns = {k: v.clone() for k, v in base.items()}, graphs.LoopGraphs(), state0, []
            for call in range(2):
                (uout, uran), uwall = synchronised(pred.model.launch_chunk, ucache, *ustate[:2], PIN_TOKENS, ustate[2],
                                                   window, pin, ustore)
                uout = tuple(t.clone() for t in uout)
                uruns.append((uout, uran.credit(), uwall))
                ustate = uout[3:]
        rows = []
        for i, ((g, sg, kg, wg), (e, se, ke, we), (u, su, wu)) in enumerate(zip(runs["graph"], runs["eager"], uruns)):
            same = all(torch.equal(a, b) for a, b in zip(g, e))
            agree = float((g[0] == u[0]).all(1).float().mean())
            rows.append(f"call {i}: steps {sg} (eager meshed {se}, unsharded {su}), K3{'q' if quantize else ''}-mesh "
                        f"credited {kg} (eager {ke}; steps x {layers} layers x {shards} shards = "
                        f"{sg * layers * shards}{', and the capture warm-up step' if i == 0 else ''}), outputs and state equal {same} (scores max |diff| "
                        f"{max_diff(g[1], e[1]):.3e}), token ids equal to the unsharded chunk's on {agree:.4f} of the "
                        f"slots; wall {wg:.4f} s (eager meshed {we:.4f} s, unsharded graph {wu:.4f} s, "
                        f"{wg / wu:.2f} x)")
            # the first call's capture also ran the warm-up's step 0 eagerly, counted as it launched
            warm_up = layers * shards if i == 0 else 0
            if not same or sg != se or ke != se * layers * shards or kg != sg * layers * shards + warm_up:
                raise AssertionError(f"{label}: the meshed graph differs from the eager meshed loop: {rows[-1]}")
            decided = pin or window == 1
            if decided and sg != su:
                raise AssertionError(f"{label}: the meshed chunk ran {sg} steps, the unsharded {su}: {rows[-1]}")
            if window == 1 and sg != (0 if i else 1):  # the second call starts with no slot active
                raise AssertionError(f"{label}: every slot stops at step 0, yet call {i} ran {sg} steps")
            if pin and sg != PIN_TOKENS:
                raise AssertionError(f"{label}: a pinned chunk ran {sg} of {PIN_TOKENS} steps")
        cache_same = all(torch.equal(caches["graph"][k], caches["eager"][k]) for k in caches["graph"])
        len_same = torch.equal(caches["graph"]["len"], ucache["len"])
        print(f"    meshed chunk 2x2, {label}: {GRAPH_ACTIVE} of {MESH_GRAPH_SLOTS} slots, cache {GRAPH_CACHE_LEN} "
              f"rows, chunk {PIN_TOKENS}; cache bytes and lengths equal to the eager meshed loop's {cache_same}, "
              f"lengths equal to the unsharded chunk's {len_same}; {loops_report(store)} [{power}]")
        for row in rows:
            print(f"      {row}")
        if not cache_same or ((pin or window == 1) and not len_same):
            raise AssertionError(f"{label}: the meshed graph's slot cache differs")
        del store, ustore, base, ucache, caches
        torch.cuda.empty_cache()
    del meshed
    torch.cuda.empty_cache()


# -- the meshed programs and table rec's whole generate as CUDA graphs (phase 31) --
# Table rec's passes (each the gather of its rows' encoder states, the cross
# K/V, the prompt's prefill and the box loop in one graph) through a new
# LoopGraphs and through the eager loop, on the synthetic tables' crops and
# at a 128-row cell pass; the meshed prefill wave (one program over every
# shard) through a new ProgramGraphs and eagerly, two waves of one shape
# into other slots, on each logical mesh of phase 20; meshed detection's
# programs on 2x1; then one meshed decode step against one unsharded step
# from one cache and slot state (the token ids' agreement settled).
TABLE_CELL_ROWS = 128
MESH_HIDDEN_REL = 0.05  # a slot's meshed step hidden state from the unsharded one's, relative L2: ~13 bf16 roundings


def check_table_generate(tab, pages, power):
    """Phase 31, table rec: whole calls on the synthetic tables' crops with
    the passes graphed and eager (the results bit for bit, each pass's
    packed buffer, steps and recorded rows equal; the passes' enqueue
    printed), then one cell pass of TABLE_CELL_ROWS rows over the 4 tables
    (enc_idx repeating them) both ways, its key's memory printed."""
    crops = [p.crop((100, 100, 868, 868)) for p in pages[:TABLE_CROPS]]
    saved_loops, saved_wait, runs = tab.loops, tab._wait, {}
    for name, loops in (("graph", graphs.LoopGraphs()), ("plain", graphs.EagerLoops())):
        packed = []

        def keep(handle):
            out = saved_wait(handle)
            packed.append(out[0].copy())
            return out

        tab.loops, tab._wait = loops, keep
        try:
            tab([c.copy() for c in crops])  # the graphs' captures
            packed.clear()
            res, wall = synchronised(tab, [c.copy() for c in crops])
        finally:
            tab.loops, tab._wait = saved_loops, saved_wait
        passes = tab.last_run["passes"]
        runs[name] = (res, list(packed), [(p["rows"], p["steps"], p["recorded"]) for p in passes],
                      sum(p["enqueue_s"] for p in passes), wall, loops)
    (g_res, g_packed, g_passes, g_enq, g_wall, store), (e_res, e_packed, e_passes, e_enq, e_wall, _) = runs.values()
    bitwise = [r.model_dump() for r in g_res] == [r.model_dump() for r in e_res]
    same_packed = len(g_packed) == len(e_packed) and all(np.array_equal(a, b) for a, b in zip(g_packed, e_packed))
    print(f"    table rec, {len(crops)} synthetic tables: passes (rows, steps, recorded) {g_passes} (eager "
          f"{e_passes}); packed buffers equal {same_packed}, results equal bit for bit {bitwise}; the passes' enqueue {g_enq:.4f} "
          f"s in {len(g_passes)} replays (eager {e_enq:.4f} s); wall {g_wall:.4f} s (eager {e_wall:.4f} s); "
          f"{loops_report(store)} [{power}]")
    if not (bitwise and same_packed and g_passes == e_passes):
        raise AssertionError("table rec: the graphed passes differ from the eager passes")
    del store, runs
    # a cell pass at the cell batch's cap: rows over the tables, a prompt of the columns' labels
    rng = np.random.default_rng(SEED + 31)
    px = tab._upload(tab.gray_ship(np.stack([tab.prepare_image(c.convert("RGB")) for c in crops])))
    L = 3 + TABLE_COLS
    vectors = rng.integers(0, BOX_DIM, (TABLE_CELL_ROWS, L, 10)).astype(np.int32)
    vectors[:, :, 6:] = [2 + 5, 5, 1, 5]
    vectors[:, 0], vectors[:, 2] = tab.config.bos_token_id, tab.config.query_end_token_id
    enc_idx = np.arange(TABLE_CELL_ROWS) % len(crops)
    outs = {}
    for name, loops in (("graph", graphs.LoopGraphs()), ("plain", graphs.EagerLoops())):
        tab.loops, tab.last_run = loops, {"passes": []}
        try:
            with torch.inference_mode():
                enc = tab._encode(px)
                tab._run_pass(enc, enc_idx, vectors, tab._script_cells)  # the capture
                preds, wall = synchronised(tab._run_pass, enc, enc_idx, vectors, tab._script_cells)
        finally:
            tab.loops = saved_loops
        outs[name] = (preds, tab.last_run["passes"][-1], wall, loops)
    (g, gp, gw, store), (e, ep, ew, _) = outs.values()
    [cap] = store.captures.values()
    dec = tab.config.decoder
    cross_kv = 2 * dec.num_hidden_layers * TABLE_CELL_ROWS * tab.config.encoder.tokens * dec.num_key_value_heads \
        * dec.head_dim * tab.dtype.itemsize
    print(f"    table rec cell pass of {TABLE_CELL_ROWS} rows over {len(crops)} tables (prompt {L}, bucket "
          f"{next(b for b in PROMPT_BUCKETS if b >= L)}): steps {gp['steps']} (eager {ep['steps']}), recorded "
          f"{gp['recorded']} (eager {ep['recorded']}), predictions equal {g == e}; enqueue {gp['enqueue_s']:.4f} s "
          f"(eager {ep['enqueue_s']:.4f} s), wall {gw:.4f} s (eager {ew:.4f} s); its key's capture "
          f"{cap['capture_s']:.3f} s and {cap['pool_bytes'] / 2**20:.1f} MiB reserved (the loop's cross K/V "
          f"{cross_kv / 2**20:.1f} MiB of it), the store's pools {store.pool_bytes() / 2**20:.1f} MiB [{power}]")
    if g != e or gp["steps"] != ep["steps"] or gp["recorded"] != ep["recorded"]:
        raise AssertionError("table rec: the graphed 128-row cell pass differs from the eager pass")
    del store, outs
    release()


def program_outputs(out) -> list:
    """A meshed prefill's outputs as a flat list of tensors: packed, then each state by shard."""
    packed, state = out
    return [packed] + [x[dm] for x in state for dm in sorted(x)]


def check_meshed_prefill(pred, pages, bboxes, power):
    """Phase 31, the meshed prefill: on each logical mesh of cuda:0, the
    first wave of 4 pages' given lines (data-sharded where the data axis is
    2) twice, into other slots each time (rows into slots of every data
    shard), through a new ProgramGraphs and eagerly, from one random slot
    cache: the packed outputs, every shard's slot state and the cache's
    bytes and lengths must be equal (max |diff| 0), the two waves one key;
    K1-mesh (1x2) or K1 and K2-mesh credited once a replay."""
    flat = pred.slice_bboxes(pages, ["ocr_with_boxes"] * len(pages), bboxes=bboxes)
    for shape in MESH_SHAPES:
        mesh = make_mesh(*shape, [torch.device("cuda", 0)] * 4)
        mp = RecognitionPredictor(mesh=mesh)
        batch, n = first_wave(mp, flat, mp.n_data)
        rows = batch.input_ids.shape[0]
        n_slots = mp.n_slots + 1
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
        base = random_slot_cache(pred.model, gen, False, n_slots)
        waves = []
        for w in range(2):
            targets = np.random.default_rng(SEED + w).permutation(n_slots - 1)[:n]
            slot_idx, row_valid = np.full(rows, n_slots - 1, np.int32), np.zeros(rows, bool)
            slot_idx[batch.valid_rows], row_valid[batch.valid_rows] = targets, True
            waves.append((slot_idx, row_valid))
        results, store = {}, graphs.ProgramGraphs()
        for name, programs in (("graph", store), ("plain", graphs.EagerPrograms())):
            mp.programs = programs
            cache = {k: Sharded.split(v, mesh, qwen_decoder.CACHE_SPECS[k]) for k, v in base.items()}
            state = mp._init_state_on_mesh(n_slots)
            results[name] = []
            for w, (slot_idx, row_valid) in enumerate(waves):
                reset_counts()
                with torch.inference_mode():
                    (packed, state), wall = synchronised(mp._prefill, cache, batch, slot_idx, row_valid, state,
                                                         np.zeros(n_slots, bool), True)
                counts = read_counts()
                results[name].append(([t.clone() for t in program_outputs((packed, state))], wall, counts))
            results[name].append({k: v.gather() for k, v in cache.items()})
        g_cache, e_cache = results["graph"].pop(), results["plain"].pop()
        diff = max(max_diff(g_cache[k], e_cache[k]) for k in g_cache)
        k1 = "segmented_block_attention" if mesh.n_data > 1 else "segmented_block_attention_shard_map"
        rows_out = []
        for w, ((g, gw, gc), (e, ew, ec)) in enumerate(zip(results["graph"], results["plain"])):
            d = max(max_diff(a, b) for a, b in zip(g, e))
            rows_out.append(f"wave {w}: outputs max |diff| {d}, wall {gw:.4f} s (eager {ew:.4f} s), {k1} "
                            f"{gc[k1]} and K2-mesh {gc['causal_flash_attention_shard_map']} credited (eager {ec[k1]} "
                            f"and {ec['causal_flash_attention_shard_map']})")
            if d != 0 or (w and (gc[k1] != ec[k1] or gc["causal_flash_attention_shard_map"] !=
                                 ec["causal_flash_attention_shard_map"])):
                raise AssertionError(f"meshed prefill {shape}: the graph differs from the eager program: "
                                     f"{rows_out[-1]}")
        keys = len(store.programs)
        print(f"    meshed prefill {shape[0]}x{shape[1]}: {n} lines in {rows} rows (L {batch.input_ids.shape[1]}, "
              f"{'data-sharded' if batch.patches.ndim == 3 else 'replicated'} encoder), two waves into other "
              f"slots: {'; '.join(rows_out)}; the cache's bytes and lengths max |diff| {diff}; {keys} key(s): "
              f"{store_report(store)} [{power}]")
        if diff != 0 or keys != 1:
            raise AssertionError(f"meshed prefill {shape}: cache max |diff| {diff}, {keys} keys for one wave shape")
        del mp, store, results, base, g_cache, e_cache
        release()


def check_meshed_detection(det, pages, power):
    """Phase 31, meshed detection on a 2x1 logical mesh: the stats program
    (host and device resize) and the maps program through a new
    ProgramGraphs and eagerly: every output equal."""
    mdet = DetectionPredictor(mesh=make_mesh(2, 1, [torch.device("cuda", 0)] * 2))
    install_blob_detector(mdet)
    mdet.model.load_state_dict(det.model.state_dict())
    if not isinstance(mdet.programs, graphs.ProgramGraphs):
        raise AssertionError(f"a one-card meshed detector runs its programs through {type(mdet.programs).__name__}")
    for resize in (False, True):
        pixels, mats, page_gather, valid_rows, n_real = detection_inputs(mdet, pages, resize)
        with torch.inference_mode():
            graph_and_plain(mdet, "programs", lambda: (mdet._stats_program(pixels, mats, page_gather, valid_rows,
                                                                           settings.DETECTOR_MAX_COMPONENTS),),
                            f"meshed detection 2x1, stats program, {'device' if resize else 'host'} resize, "
                            f"{len(pages)} pages in {pixels.shape[0]} rows", power)
            if resize:
                graph_and_plain(mdet, "programs", lambda: (mdet._maps_program(pixels, mats, n_real, 1),),
                                f"meshed detection 2x1, maps program, {n_real} chunks", power)
    del mdet
    release()


def check_meshed_ids(pred, gen, power):
    """Phase 31, the meshed chunk's token ids: from one random cache and
    slot state, one decode step on a 2x2 logical mesh and one unsharded
    (both bf16, the kernels). Each slot's hidden state must lie within
    MESH_HIDDEN_REL (relative L2) of the unsharded one. The logits then
    move by the hidden states' difference times the tied embedding: by
    `moved` at most, measured in float32 (the a-priori bound, delta =
    MESH_HIDDEN_REL |h| max_v |w_v| by Cauchy-Schwarz, is printed too), and
    the bf16 logits round by at most one ulp of the top logit; so every
    slot whose unsharded float32 top-1 beats its runner-up by more than
    2 (moved + ulp) must sample the same id, or the sampled ids do not
    follow from the hidden states. The rest are near-ties; their share
    and the ids' agreement are printed."""
    mesh = make_mesh(2, 2, [torch.device("cuda", 0)] * 4)
    meshed = MeshedFoundation(pred.model, mesh)
    model, dec = pred.model, pred.config.decoder
    base = random_slot_cache(model, gen, False, MESH_GRAPH_SLOTS)
    last = torch.randint(4, pred.config.vocab_size, (MESH_GRAPH_SLOTS,), generator=gen, device="cuda",
                         dtype=torch.int32)
    with torch.inference_mode():
        bufs = model.chunk_buffers(last, dec.num_key_value_heads, 1)
        h_u = model.decoder.decode_step_chunked(base, bufs[3], bufs[4], model.token_embed(last.long()), 0,
                                                base["len"])
        cache = {k: Sharded.split(v, mesh, qwen_decoder.CACHE_SPECS[k]) for k, v in base.items()}
        lasts = Sharded.split(last, mesh, qwen_decoder.ROWS_SPEC)
        emb = {dm: meshed.model(dm).token_embed(t.long()) for dm, t in lasts.shards.items()}
        chunks = [Sharded(mesh, qwen_decoder.CHUNK_SPEC, {dm: meshed.model(dm).chunk_buffers(
            t, meshed.decoder.shards[dm].n_kv_heads, 1)[3] for dm, t in lasts.shards.items()}) for _ in range(2)]
        lengths = Sharded(mesh, qwen_decoder.ROWS_SPEC, {dm: t.clone() for dm, t in cache["len"].shards.items()})
        hid = meshed.decoder.decode_step_chunked(cache, *chunks, emb, 0, lengths)
        h_m = torch.cat([hid[d, 0] for d in range(mesh.n_data)])
        tok_u, tok_m = model.sample_greedy(h_u)[0], model.sample_greedy(h_m)[0]
        w = model.token_embed.weight.float()
        logits = h_u.float() @ w.T + model.lm_head_bias.float()
    rel = (h_m.float() - h_u.float()).norm(dim=-1) / h_u.float().norm(dim=-1)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    delta = MESH_HIDDEN_REL * h_u.float().norm(dim=-1) * w.norm(dim=-1).max()
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs().clamp(min=1e-30))) - 7)
    with torch.inference_mode():
        moved = ((h_m.float() - h_u.float()) @ w.T).abs().amax(-1)  # each slot's largest logit change
    bound = 2 * (moved + ulp)
    decided, same = margin > bound, tok_m == tok_u
    differ = ~same
    worst_margin = margin[differ].max().item() if differ.any() else 0.0
    print(f"    meshed ids, one decode step on 2x2 against unsharded, {MESH_GRAPH_SLOTS} slots: hidden relative L2 "
          f"max {rel.max().item():.4e}, median {rel.median().item():.4e} (bound {MESH_HIDDEN_REL}); ids equal on "
          f"{same.float().mean().item():.4f} of the slots; float32 top-1 margin median {margin.median().item():.4e}, "
          f"largest logit change median {moved.median().item():.4e}, 2 (change + ulp) median "
          f"{bound.median().item():.4e} (a priori 2 (delta + ulp) median {(2 * (delta + ulp)).median().item():.4e}, "
          f"{int((margin > 2 * (delta + ulp)).sum())} slots beyond it); {int(decided.sum())} slots beyond "
          f"2 (change + ulp), {int((decided & same).sum())} of them with equal ids; {int(differ.sum())} slots with "
          f"other ids, their margins at most {worst_margin:.4e} [{power}]")
    if not rel.max().item() <= MESH_HIDDEN_REL:
        raise AssertionError(f"a meshed hidden state is {rel.max().item():.4e} from the unsharded one's")
    if not bool(same[decided].all()):
        raise AssertionError("a meshed step sampled another id where the unsharded top-1 beats the runner-up by more "
                             "than the bound: a fault in the sharded sums")
    del meshed, base, cache
    release()


# -- the checkpoint-validation command (phase 27) -------------------------------
# Its six accuracy stages read Hugging Face datasets, which no run here can
# fetch: each stage module's load_hf_dataset is replaced by one that returns
# an in-memory dataset with the columns that stage reads, made from the port's
# synthetic pages (tests/test_torch_validate_checkpoints.py gives the same rows
# to the JAX stages).

# gate -> the setting that names its dataset
DATASET_SETTINGS = {"detection": "DETECTOR_BENCH_DATASET_NAME", "recognition": "RECOGNITION_BENCH_DATASET_NAME",
                    "layout": "LAYOUT_BENCH_DATASET_NAME", "ordering": "ORDER_BENCH_DATASET_NAME",
                    "table_recognition": "TABLE_REC_BENCH_DATASET_NAME", "texify": "TEXIFY_BENCHMARK_DATASET"}


class InMemoryDataset:
    """What the stages read of a Hugging Face dataset: a column by name (a
    list), the rows as dicts in order, ``column_names`` and the length."""

    def __init__(self, **columns):
        self.columns = columns
        self.column_names = list(columns)

    def __getitem__(self, name):
        return list(self.columns[name])

    def __len__(self):
        return len(next(iter(self.columns.values())))

    def __iter__(self):
        for i in range(len(self)):
            yield {k: v[i] for k, v in self.columns.items()}

    def head(self, n: int) -> "InMemoryDataset":
        return InMemoryDataset(**{k: v[:n] for k, v in self.columns.items()})


def stage_datasets(n: int) -> dict:
    """gate -> an in-memory dataset of n rows: detection's line boxes on the
    1000x1000 scale; recognition's boxes, texts and languages; layout's boxes
    with PubLayNet labels (a title, text lines, a list item); ordering's
    boxes with their positions; table rec's rows and columns; texify's
    three-line blocks and their text. Each dataset holds pages of its own."""
    from surya_tpu_torch.benchmark.utils.data import synthetic_table_pages, synthetic_text_pages

    def pages():
        return synthetic_text_pages(n)

    images, boxes, texts = pages()
    scale = [[rescale_bbox(b, images[0].size, (1000, 1000)) for b in page] for page in boxes]
    tables, rows, cols = synthetic_table_pages(n)
    blocks, _, block_texts = synthetic_text_pages(n, lines=3, size=(800, 260))
    return {
        "detection": InMemoryDataset(image=images, bboxes=scale),
        "recognition": InMemoryDataset(image=pages()[0], bboxes=boxes, text=texts, language=[["en"]] * n),
        "layout": InMemoryDataset(image=pages()[0], bboxes=boxes,
                                  labels=[["Title"] + ["Text"] * (len(b) - 2) + ["List"] for b in boxes]),
        "ordering": InMemoryDataset(image=pages()[0], bboxes=boxes, labels=[list(range(len(b))) for b in boxes]),
        "table_recognition": InMemoryDataset(image=tables, rows=rows, cols=cols),
        "texify": InMemoryDataset(image=blocks, text=[" ".join(t) for t in block_texts]),
    }


def dataset_loader(gate: str, dataset: InMemoryDataset):
    """A stand-in for a stage's load_hf_dataset: the first max_rows rows of
    ``dataset``, once the stage asked for its own dataset by name."""
    def load_hf_dataset(name: str, max_rows: int):
        want = getattr(settings, DATASET_SETTINGS[gate])
        if name != want:
            raise AssertionError(f"the {gate} stage asked for dataset {name!r}, not {want!r}")
        return dataset.head(max_rows)
    return load_hf_dataset


# rows a stage in phase 27, and the keys of each stage's result file (the JAX
# stages'): its top level, and those of the entry below it (None: no check)
VALIDATION_ROWS = 2
RESULT_KEYS = {
    "detection": ({"metrics", "page_metrics"}, ("metrics", "surya"), {"precision", "recall", "time_per_image"}),
    "recognition": ({"surya"}, ("surya",), {"avg_score", "time_per_img", "total_time"}),
    "layout": ({"metrics", "time_per_image"}, None, None),
    "ordering": ({"mean_accuracy", "time_per_image"}, None, None),
    "table_recognition": ({"surya"}, ("surya",), {"mean_row_iou", "mean_col_iou", "time_per_image"}),
    "texify": ({"scores", "total_time", "n"}, None, None),
}
# the stages whose predictor decodes with the recognition model, through K1, K2 and K3
DECODING_GATES = ("recognition", "texify")


def check_result_keys(gate: str, data: dict) -> None:
    top, path, inner = RESULT_KEYS[gate]
    entry = data
    for key in path or ():
        entry = entry[key]
    if set(data) != top or (inner is not None and set(entry) != inner):
        raise AssertionError(f"{gate}: the result file's keys {sorted(data)} (below {path}: "
                             f"{sorted(entry) if path else None}) are not the JAX stage's")
    if gate == "layout" and any(set(m) != {"precision", "recall"} for m in data["metrics"].values()):
        raise AssertionError(f"layout: a label's metrics have other keys: {data['metrics']}")


def check_validation_gated(pred, det, lay, tab, power):
    """Phase 27a: validate_checkpoints.main() over all six gates at full
    width, as on real checkpoints. The detection, recognition, layout and
    table rec models of the earlier phases are written as upstream
    checkpoint directories (``write_checkpoint``); the settings are read anew
    with ALLOW_RANDOM_WEIGHTS off and the four ``*_MODEL_CHECKPOINT`` settings
    naming those directories, so that every stage builds its predictor from
    a checkpoint, with no cap on the tokens a line; each stage module's
    load_hf_dataset returns the in-memory rows of ``stage_datasets``. Random
    weights cannot pass the gates: the command must exit non-zero with
    "gates failed", every gate "below threshold" or "pass" (never "error" or
    a structure error), and the six result files must carry the JAX stages'
    keys. The launches are counted around each stage: K1, K2 and K3 in
    recognition and texify, K3q in neither, no kernel in the other four.
    The settings, the stage modules and the directory are restored after."""
    from surya_tpu_torch.scripts import validate_checkpoints

    t_phase = time.perf_counter()
    settings.RECOGNITION_WEIGHT_QUANTIZE = settings.RECOGNITION_MODEL_QUANTIZE = False
    set_pin(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    root = Path(tempfile.mkdtemp(prefix="surya_validation_"))
    modules = {gate: importlib.import_module(name) for name, _, gate, _ in validate_checkpoints.STAGES}
    saved_modules = {gate: (mod.run, mod.load_hf_dataset) for gate, mod in modules.items()}
    saved_settings = dict(vars(settings))
    stages = {}

    def counted(gate, run):
        def run_counted(**kwargs):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            try:
                return run(**kwargs)
            finally:
                torch.cuda.synchronize()
                stages[gate] = (time.perf_counter() - t0, read_counts())
        return run_counted

    try:
        t0 = time.perf_counter()
        checkpoints = {}
        for kind, src, setting in [("detection", det, "DETECTOR_MODEL_CHECKPOINT"),
                                   ("recognition", pred, "RECOGNITION_MODEL_CHECKPOINT"),
                                   ("layout", lay, "LAYOUT_MODEL_CHECKPOINT"),
                                   ("table_rec", tab, "TABLE_REC_MODEL_CHECKPOINT")]:
            write_checkpoint(root / kind, kind, src.model, src.config, gen)
            checkpoints[setting] = str(root / kind)
        print(f"    {len(checkpoints)} checkpoints written in {time.perf_counter() - t0:.1f} s")
        vars(settings).update(vars(Settings({**load_dotenv(), **os.environ, "ALLOW_RANDOM_WEIGHTS": "false",
                                             **checkpoints})))
        if settings.ALLOW_RANDOM_WEIGHTS or settings.RECOGNITION_MAX_TOKENS:
            raise AssertionError("phase 27a must run without random weights and without a token cap")
        datasets = stage_datasets(VALIDATION_ROWS)
        for gate, mod in modules.items():
            mod.load_hf_dataset = dataset_loader(gate, datasets[gate])
            mod.run = counted(gate, mod.run)
        results = root / "results"
        try:
            validate_checkpoints.main(["--results_dir", str(results), "--max_rows", str(VALIDATION_ROWS)])
            exit_message = None
        except SystemExit as e:
            exit_message = e.code
        summary = json.loads((results / "validation_summary.json").read_text())
        for gate, status in summary.items():
            wall, counts = stages.get(gate, (None, None))
            launched = {k: v for k, v in (counts or {}).items() if k in COUNTERS and v}
            print(f"    {gate}: {status['status']}, stage wall {wall:.2f} s, launches {launched} [{power}]")
        if list(summary) != list(DATASET_SETTINGS) or any(
                s["status"] not in ("below threshold", "pass") for s in summary.values()):
            raise AssertionError(f"the gated run's summary: {json.dumps(summary)}")
        if not (isinstance(exit_message, str) and exit_message.startswith("gates failed")):
            raise AssertionError(f"the gated run on random weights exited with {exit_message!r}, not gates failed")
        print(f"    the command exited: {exit_message}")
        for _, result_file, gate, _ in validate_checkpoints.STAGES:
            check_result_keys(gate, json.loads((results / result_file).read_text()))
        for gate, (_, counts) in stages.items():
            label = f"validation stage {gate}"
            counts = {k: v for k, v in counts.items() if k in COUNTERS}
            if gate in DECODING_GATES:
                assert_launched(label, counts, RECOGNITION_KERNELS, [k for k in COUNTERS if k not in
                                                                     RECOGNITION_KERNELS])
            else:
                assert_launched(label, counts, [], list(COUNTERS))
        print(f"    phase 27a took {time.perf_counter() - t_phase:.1f} s [{power}]")
        return stages
    finally:
        for gate, mod in modules.items():
            mod.run, mod.load_hf_dataset = saved_modules[gate]
        vars(settings).clear()
        vars(settings).update(saved_settings)
        shutil.rmtree(root, ignore_errors=True)


def check_validation_smoke(power):
    """Phase 27b: ``python -m surya_tpu_torch.scripts.validate_checkpoints
    --smoke --max_rows 2`` as a process of its own, with the smoke's
    environment (random weights, the checkpoint settings naming a path that
    does not exist), at full width: exit 0 with "smoke run complete",
    detection, recognition and table recognition "below threshold" or
    "pass", layout, ordering and texify "skipped"."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([sys.executable, "-m", "surya_tpu_torch.scripts.validate_checkpoints", "--smoke",
                               "--max_rows", str(VALIDATION_ROWS), "--results_dir", tmp],
                              cwd=os.path.dirname(os.path.abspath(__file__)), env=dict(os.environ),
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode or "smoke run complete" not in proc.stdout:
            raise AssertionError(f"validate_checkpoints --smoke exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        summary = json.loads((Path(tmp) / "validation_summary.json").read_text())
    statuses = {g: s["status"] for g, s in summary.items()}
    want = {"detection": ("below threshold", "pass"), "recognition": ("below threshold", "pass"),
            "layout": ("skipped",), "ordering": ("skipped",), "table_recognition": ("below threshold", "pass"),
            "texify": ("skipped",)}
    if list(statuses) != list(want) or any(statuses[g] not in ok for g, ok in want.items()):
        raise AssertionError(f"validate_checkpoints --smoke: {statuses}")
    for gate, s in summary.items():
        print(f"    {gate}: {s['status']}" + (f", {s['seconds']} s" if "seconds" in s else ""))
    print(f"    python -m surya_tpu_torch.scripts.validate_checkpoints --smoke --max_rows {VALIDATION_ROWS} "
          f"(a process of its own, full width, random weights): exit 0, smoke run complete; wall {wall:.1f} s "
          f"with the start and the models' builds [{power}]")


def assert_launched(label, run_counts, launched, not_launched=()):
    print(f"    {label}: {run_counts}")
    for n in launched:
        if run_counts[n] <= 0:
            raise AssertionError(f"{n} was never launched in the {label} run")
    for n in not_launched:
        if run_counts[n]:
            raise AssertionError(f"{n} was launched {run_counts[n]} times in the {label} run")


def kernels_ab():
    """--kernels: the kernels alone at fixed main-path shapes, through the
    wrappers' public calls (see the module docstring); prints their device
    times as one KERNELS_AB JSON line."""
    power = card()
    lib = _build.library()
    print(f"[1] card: {power}; the port of {Path(flash.__file__).resolve().parents[2]}; kernels built in "
          f"{lib.build_seconds:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results, times = {}, {}
    # K1 over the given-lines boxes of 16 pages
    grids = [(h // 14, w // 14) for h, w in LINE_SHAPES] * 16
    cap = 4096
    while cap < sum(a * b for a, b in grids):
        cap *= 2
    check_segmented(results, plan_layout(grids, EncoderConfig(**DEFAULT_ENCODER), cap), gen, "A/B", report=True)
    for label in ("full", "window"):
        times[f"K1 {label}"] = results[f"segmented_block_attention[{label}]"]["ms"]
    times["K2 128x128"] = check_causal(results, 128, 128, gen)["ms"]
    times["K2-mesh shard 16x128, 6/2 heads"] = check_causal(results, 16, 128, gen, heads=(6, 2),
                                                            name="causal_flash_attention_shard")["ms"]
    # LFM2-MoE's attention layers: D = 64, 32/8 heads, a 128-row wave of bucket 128
    times["K2 128x128, 32/8 heads, D=64"] = check_causal(results, 128, 128, gen, heads=(32, 8), D=64,
                                                         name="causal_flash_attention_d64")["ms"]
    # K3 and K3q at main-path-like lengths: 129 slots, S = 256, K = 64 (K3:
    # 32 slots of 1 to 108 rows; K3q: every slot 0 to 78), steps 0, 31, 63
    lens3 = np.zeros(129, np.int32)
    lens3[:32] = rng.integers(1, 109, 32)
    lens3q = rng.integers(0, 79, 129).astype(np.int32)
    ragged = rng.integers(0, 513, 129).astype(np.int32)
    ragged[:4] = [0, 1, 117, 512]
    for kvh, slots, tag in ((4, 129, ""), (2, 65, "-mesh shard, 65 slots, 6/2 heads")):
        inputs = decode_inputs(gen, slots, 256, 64, 10, kvh=kvh)
        for kernel, lens in (("gqa_decode", lens3), ("gqa_decode_int8", lens3q)):
            steps = [check_decode_case({}, "main-path-like", inputs, lens[:slots], step, 9)[kernel]["ms"]
                     for step in (0, 31, 63)]
            times[f"{'K3q' if kernel.endswith('int8') else 'K3'}{tag} main path, mean of steps 0/31/63"] = \
                float(np.mean(steps))
    inputs = decode_inputs(gen, 129, 256, 64, 6, kvh=8, group=4, D=64)
    steps = [check_decode_case({}, "main-path-like", inputs, lens3, step, 5, names=("gqa_decode_d64",))["gqa_decode"]["ms"]
             for step in (0, 31, 63)]
    times["K3 D=64, 32/8 heads, main path, mean of steps 0/31/63"] = float(np.mean(steps))
    long = check_decode_case({}, "ragged", decode_inputs(gen, 129, 512, 64, 10), ragged, 37, 7)
    times["K3 long cache S=512 step 37"] = long["gqa_decode"]["ms"]
    times["K3q long cache S=512 step 37"] = long["gqa_decode_int8"]["ms"]
    # the caches recognition sizes for fewer slots: 512 rows (a line's prompt
    # bucket and 224 free-running tokens; its 2x2 mesh shard at 65 slots of 2
    # kv heads), 1536 (a block's, 768 tokens), 256 (pinned), and 2048, all
    # full or ragged, at step 37; where the cluster rule may share a (slot,
    # kv head) among CTAs
    for B, kvh, S, label in ((65, 2, 512, "ragged"), (65, 2, 512, "full"), (40, 4, 512, "ragged"),
                             (40, 4, 512, "full"), (16, 4, 512, "full"), (8, 4, 256, "full"), (8, 4, 1536, "full"),
                             (33, 4, 1536, "ragged"), (8, 4, 2048, "2000 rows")):
        lens = (rng.integers(0, S + 1, B) if label == "ragged" else np.full(B, min(S, 2000))).astype(np.int32)
        few = check_decode_case({}, label, decode_inputs(gen, B, S, 64, 2, kvh=kvh), lens, 37, 1)
        for kernel, tag in (("gqa_decode", "K3"), ("gqa_decode_int8", "K3q")):
            times[f"{tag} {B} slots, {kvh} kv heads, S={S}, {label}"] = few[kernel]["ms"]
    print("KERNELS_AB " + json.dumps({"card": power, "tree": str(Path(flash.__file__).resolve().parents[2]),
                                      "ms": times}))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


MOE_NEAR_TIE = 1e-5  # biased router scores closer than this may be chosen either way


def check_glue_kernels(label, moe, x, gate, bias, valid, chosen, weights, hist, h, y, inter):
    """Each of the sparse layer's glue kernels (csrc/moe.cu) against its
    plain function on the same inputs, raising on a mismatch: the route's
    choices (a choice may differ only at a near tie of the biased scores:
    the kernel sums a logit in another order than cuBLAS) and weights
    within 1e-6; the permute's offsets, row places, sorted rows and
    counters (each side's from zero) exactly; SwiGLU within its one
    rounding against the plain version's two (2^-7 of the value); the
    combine within one bf16 unit in the last place. chosen .. y: the kernel
    path's intermediates."""
    E, k = gate.shape[0], chosen.shape[1]
    chosen_p, weights_p = moe.route(x, gate, bias, k, True, 1.0, valid)
    differ = (chosen.long() != chosen_p).any(1)
    if valid is not None:
        differ &= valid
    keys = torch.sigmoid(x.float() @ gate.float().T) + bias.float()
    gap = (keys.gather(1, chosen.long().clamp(max=E - 1)).sort(-1).values
           - keys.gather(1, chosen_p.clamp(max=E - 1)).sort(-1).values).abs()
    if differ.any() and not bool((gap[differ] < MOE_NEAR_TIE).all()):
        raise AssertionError(f"{label}: the route kernel chooses other experts away from a near tie")
    ok = ~differ if valid is None else ~differ & valid
    w_err = (weights - weights_p)[ok].abs().max().item()
    if not w_err <= 1e-6 or (valid is not None and not bool((chosen[~valid] == E).all())):
        raise AssertionError(f"{label}: the route kernel's weights are {w_err:.3e} from route's, or a token that "
                             "is not valid has an expert")
    counts, counts_p = (torch.zeros(3, dtype=torch.int64, device=x.device) for _ in range(2))
    rows_k, offs, inverse = moe.permute_kernel(x, chosen, hist, counts)
    rows_p, offs_p, inverse_p = moe.permute(x, chosen.long(), E, counts_p)
    total, real = int(offs_p[-1]), chosen.reshape(-1) < E
    if not (torch.equal(offs, offs_p) and torch.equal(counts, counts_p)
            and torch.equal(inverse[real].long(), inverse_p[real]) and bool((inverse[~real] == -1).all())
            and torch.equal(rows_k[:total], rows_p[:total])):
        raise AssertionError(f"{label}: the permute kernel's offsets, places, rows or counters are not permute's "
                             f"(counters {counts.tolist()} against {counts_p.tolist()})")
    a = moe.swiglu_kernel(h, offs, inter)[:total].float()
    a_p = moe.swiglu(h, inter)[:total].float()
    if not bool(((a - a_p).abs() <= 2.0**-7 * a_p.abs()).all()):
        raise AssertionError(f"{label}: the SwiGLU kernel is more than its roundings from swiglu")
    out = moe.combine_kernel(y, inverse, weights, valid).float()
    out_p = moe.combine(y, inverse.long(), weights, valid, torch.bfloat16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(torch.maximum(out.abs(), out_p.abs()))) - 7)
    if not bool(((out - out_p).abs() <= ulp).all()):
        raise AssertionError(f"{label}: the combine kernel is more than a bf16 unit in the last place from combine")
    print(f"    {label}: route {int(differ.sum())} near-tie flips, weights within {w_err:.3e}; permute offsets, "
          f"places, rows and counters {counts.tolist()} equal; SwiGLU and combine within their roundings")


def moe_case(gen, T, valid_rows=None, reps=5) -> dict:
    """The sparse-expert layer (ops/moe.py) at LFM2-8B-A1B's widths (32
    experts of 1792 over 2048, top-4) over T tokens (valid_rows: the first
    of every 128 tokens that are valid, a prefill wave's rows; None: all,
    a decode step's slots): held to its plain version in float32 within 2 %
    of the output's largest magnitude (bf16 weights, activations and the
    grouped GEMMs' bf16 outputs), run with a synchronisation anywhere an
    error, and timed; the bound counts each hit expert's weights once and
    each row's activations (counts/lfm2.py). Where the port has the glue's
    kernels (csrc/moe.cu), the layer is also timed on its plain path
    (use_kernels=False: the glue as PyTorch launches), and each kernel
    alone beside its bound and its plain function on the same inputs."""
    from surya_tpu_torch.ops import moe

    E, H, inter, k = 32, 2048, 1792, 4
    gate, bias = randn(gen, E, H, scale=H**-0.5), randn(gen, E, scale=0.02)
    w13, w2 = randn(gen, E, 2 * inter, H, scale=H**-0.5), randn(gen, E, H, inter, scale=inter**-0.5)
    x = randn(gen, T, H, scale=1.0)
    valid = None if valid_rows is None else (torch.arange(T, device="cuda") % 128) < valid_rows
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.sparse_moe(x, gate, bias, w13, w2, k, valid=valid, counts=counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = moe.sparse_moe_reference(x, gate, bias, w13, w2, k, valid=valid)
    err = (out.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    rows, hits, largest = counts.tolist()
    label = f"sparse_moe[{T} tokens{'' if valid is None else f', {valid_rows} of 128 valid'}]"
    print(f"  {label}: max_abs_err {err:.3e} (|ref| max {mag:.3f}); rows {rows}, experts hit {hits}, "
          f"largest expert {largest} rows")
    if not (err <= 0.02 * mag) or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: the layer disagrees with its plain version")
    ms = cuda_ms(lambda: moe.sparse_moe(x, gate, bias, w13, w2, k, valid=valid), reps, cold=True)
    flops = rows * 2 * 3 * H * inter
    nbytes_ = hits * 3 * H * inter * 2 + rows * (2 * H + 2 * inter) * 2
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes_ / HBM_BYTES_PER_S) * 1e3
    print(f"    {label}: layer {ms:.4f} ms, expert GEMMs' bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f} %)")
    result = {"ms": ms, "bound_ms": bound_ms, "rows": rows, "experts_hit": hits, "max_abs_err": err}
    if not hasattr(moe, "route_kernel"):  # another tree's port (--tree): the glue as PyTorch launches
        return result
    result["plain_ms"] = cuda_ms(lambda: moe.sparse_moe(x, gate, bias, w13, w2, k, valid=valid, use_kernels=False),
                                 reps, cold=True)
    print(f"    {label}: plain path (the glue as PyTorch launches) {result['plain_ms']:.4f} ms")
    chosen, weights, hist = moe.route_kernel(x, gate, bias, True, 1.0, valid)
    sorted_rows, offs, inverse = moe.permute_kernel(x, chosen, hist, None)
    h = torch._grouped_mm(sorted_rows, w13.transpose(1, 2), offs=offs)
    y = torch._grouped_mm(moe.swiglu_kernel(h, offs, inter), w2.transpose(1, 2), offs=offs)
    check_glue_kernels(label, moe, x, gate, bias, valid, chosen, weights, hist, h, y, inter)
    tokens = T if valid is None else int(valid.sum())
    small = T * k * (4 + 4 + 4)  # chosen, weights, places
    cases = {  # kernel: (its call, its plain function's call, bytes, operations)
        "route": (lambda: moe.route_kernel(x, gate, bias, True, 1.0, valid),
                  lambda: moe.route(x, gate, bias, k, True, 1.0, valid),
                  (T * H + E * H) * 2 + small + hist.numel() * 4, 2 * T * E * H),
        "permute": (lambda: moe.permute_kernel(x, chosen, hist, None),
                    lambda: moe.permute(x, chosen.long(), E),
                    (tokens + rows) * H * 2 + small + hist.numel() * 4, 0),
        "swiglu": (lambda: moe.swiglu_kernel(h, offs, inter), lambda: moe.swiglu(h, inter),
                   rows * 3 * inter * 2, 0),
        "combine": (lambda: moe.combine_kernel(y, inverse, weights, valid),
                    lambda: moe.combine(y, inverse.long(), weights, valid, torch.bfloat16),
                    (rows + T) * H * 2 + small, 0),
    }
    result["kernels"] = {}
    for name, (kernel, plain, nbytes_, flops) in cases.items():
        k_ms, p_ms = cuda_ms(kernel, reps, cold=True), cuda_ms(plain, reps, cold=True)
        b_ms = max(flops / BF16_FLOPS_PER_S, nbytes_ / HBM_BYTES_PER_S) * 1e3
        result["kernels"][name] = {"ms": k_ms, "bound_ms": b_ms, "plain_ms": p_ms}
        print(f"    {label}: {name} {k_ms:.4f} ms, bound {b_ms:.4f} ms ({100 * b_ms / k_ms:.1f} %), "
              f"plain {p_ms:.4f} ms")
    return result


def lfm2_graph_launches(rng) -> dict:
    """The sparse layers' launches as the recognition predictor runs
    LFM2-8B-A1B's decoder (random bf16 weights at the benchmark's
    configuration, perfbench/configs/lfm2_8b_a1b_ocr.json): a first call of
    given lines captures the prefill wave's and the decode chunk's CUDA
    graphs; over a second call, replays only, each glue kernel's launches
    (credited once a replay, a decode step's once a step that ran) must
    equal the sparse layer calls, and those the sparse layers times the
    decoder's passes (each prefill wave and each decode step: the attention
    layers' K2 and K3 launches over the attention layers). Returns the
    counts measured."""
    from perfbench.systems import ocr_lfm2
    from surya_tpu_torch.ops import moe

    cfg = json.loads((Path(__file__).resolve().parent / "perfbench/configs/lfm2_8b_a1b_ocr.json").read_text())
    t0 = time.perf_counter()
    pred = RecognitionPredictor(device="cuda", config=ocr_lfm2.program_config(cfg))
    sparse = sum(layer.is_sparse for layer in pred.model.decoder.layers)
    attention = len(pred.config.decoder.attention_layers)
    pages, bboxes = synthetic_pages(rng)
    set_pin(True)
    pred(pages, bboxes=bboxes)  # captures the graphs
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    glue = (moe.route_kernel, moe.permute_kernel, moe.swiglu_kernel, moe.combine_kernel)
    for fn in (moe.sparse_moe, *glue):
        fn.launches = 0
    reset_counts()
    results = pred(pages, bboxes=bboxes)
    torch.cuda.synchronize()
    n_lines = check_lines(results, pages, LINES_PER_PAGE)
    launched = read_counts()
    passes = (launched["causal_flash_attention"] + launched["gqa_decode"]) / attention
    counts = {"sparse_moe": moe.sparse_moe.launches, **{fn.__name__: fn.launches for fn in glue},
              "decoder passes": passes, "sparse layers": sparse, "lines": n_lines}
    print(f"    a second call of {n_lines} given lines (graphs captured by a first, {built:.1f} s with the model's "
          f"build), launches counted: {counts}")
    if any(fn.launches != moe.sparse_moe.launches for fn in glue) or moe.sparse_moe.launches != sparse * passes \
            or not passes:
        raise AssertionError(f"the sparse layers' kernels are not launched once a sparse layer call, "
                             f"{sparse} a decoder pass: {counts}")
    del pred
    torch.cuda.empty_cache()
    return counts


def lfm2_smoke():
    """--lfm2: what LFM2-8B-A1B's decoder adds, alone at its widths: K2 and
    K3 at head dim 64 with 4 query heads a kv head against their plain
    versions (and ptxas's registers and spills for them), the sparse-expert
    layer at a decode step's 129 slots and a prefill wave's 128 rows of
    128 (against its plain version, sync-free, in a CUDA graph, timed, its
    glue kernels alone too: moe_case), the device work of one layer call,
    and the sparse layers' launches through the whole decoder's captured
    graphs (lfm2_graph_launches); prints one LFM2_SMOKE JSON line."""
    power = card()
    lib = _build.library()
    print(f"[1] card: {power}; torch {torch.__version__}, torch._grouped_mm "
          f"{'present' if hasattr(torch, '_grouped_mm') else 'absent'}; kernels built in {lib.build_seconds:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results, times = {}, {}
    print("[2] K2 and K3 at D = 64, 32/8 heads")
    for B, L in ((128, 128), (32, 256), (3, 1536)):
        times[f"K2 {B}x{L}"] = check_causal(results, B, L, gen, heads=(32, 8), D=64,
                                            name="causal_flash_attention_d64")["ms"]
    inputs = decode_inputs(gen, 129, 256, 64, 6, kvh=8, group=4, D=64)
    edges = np.resize(np.array([0, 1, 15, 16, 17, 63, 64, 65, 255, 256], np.int32), 129)
    ragged = rng.integers(0, 257, 129).astype(np.int32)
    for label, lens, step in (("ragged", ragged, 37), ("edge", edges, 0), ("edge", edges, 63),
                              ("floor: all 0", np.zeros(129, np.int32), 0)):
        times[f"K3 {label} step {step}"] = check_decode_case(
            results, label, inputs, lens, step, 5, names=("gqa_decode_d64",))["gqa_decode"]["ms"]
    few = decode_inputs(gen, 8, 1536, 64, 2, kvh=8, group=4, D=64)
    times["K3 8 slots S=1536 full"] = check_decode_case(results, "full", few, np.full(8, 1536, np.int32), 37, 1,
                                                        names=("gqa_decode_d64",))["gqa_decode"]["ms"]
    print("[3] the sparse-expert layer")
    moe_times = {"decode 129 slots": moe_case(gen, 129), "prefill 128 x 128": moe_case(gen, 128 * 128, 90, reps=3)}
    from surya_tpu_torch.ops import moe

    E, H, inter = 32, 2048, 1792
    args = (randn(gen, 129, H, scale=1.0), randn(gen, E, H), randn(gen, E, scale=0.02),
            randn(gen, E, 2 * inter, H, scale=H**-0.5), randn(gen, E, H, inter, scale=inter**-0.5), 4)
    moe.sparse_moe(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        moe.sparse_moe(*args)
        torch.cuda.synchronize()
    launched = [ev.name for ev in sorted(prof.events(), key=lambda ev: ev.time_range.start)
                if ev.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted(set(launched))
    print(f"    the device work of one sparse_moe call ({len(launched)}), in order:")
    for n in launched:
        print(f"      {n}")
    print("LFM2_SMOKE " + json.dumps({"card": power, "ms": times, "moe": moe_times, "moe_kernels": names,
                                      "moe_launches": launched, "results": results}))
    if hasattr(moe, "route_kernel"):  # this tree's port: four kernels around the two grouped GEMMs
        glue = ("moe_route_reduce_kernel", "moe_permute_gather_kernel", "moe_swiglu_elementwise_kernel",
                "moe_combine_gather_kernel")
        # each torch._grouped_mm: PyTorch's prepare_grouped_gemm_data, then CUTLASS's grouped GEMM
        gemm = ("prepare_grouped_gemm_data", "GroupProblemShape")
        order = [next((g for g in glue + gemm if g in n), n) for n in launched]
        if order != [glue[0], glue[1], *gemm, glue[2], *gemm, glue[3]]:
            raise AssertionError(f"a sparse_moe call is not its four kernels around its two grouped GEMMs: {launched}")
        print("[4] the sparse layers' launches in the decoder's captured graphs")
        print("LFM2_GRAPH_LAUNCHES " + json.dumps(lfm2_graph_launches(rng)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def main():
    if "--kernels" in sys.argv:
        kernels_ab()
        return
    if "--lfm2" in sys.argv:
        lfm2_smoke()
        return
    kind = torch.cuda.get_device_name(0)
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
    # warm-up at the measured shapes (cuBLAS, allocator, each graph's capture), the longer
    # free-running cache first: the pinned run's then is a view of the kept store, as measured
    for pin in (False, True):
        run_predictor(pred, pages, bboxes, pin=pin)
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
    for pin in (False, True):  # warm-up at the measured shapes (cuDNN, cuBLAS, allocator, graphs), as above
        run_full_page(pred, det, ocr_pages, pin=pin)
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

    stream_pages = synthetic_full_pages(np.random.default_rng(SEED + 2), STREAM_PAGES)
    print("[9] detection on the card: device resize and component stats (auto) against the host path")
    check_detection(det, stream_pages, power)
    print(f"[10] whole-page OCR of {STREAM_PAGES} synthetic pages, int8 cache, pinned "
          f"{PIN_TOKENS} tokens, streaming against sequential")
    batch_results = check_streaming_pages(pred, det, stream_pages, power)
    print("[11] the recognition dispatch path under torch.cuda.set_sync_debug_mode(\"error\")")
    check_sync_free_dispatch(pred, det, stream_pages, power)
    print(f"[12] stream() over a generator of the {STREAM_PAGES} pages")
    check_stream(pred, det, stream_pages, batch_results, power)
    whole_page_keys = (f"{len(pred.programs.captures)} prefill and {len(det.programs.captures)} detection program "
                       f"keys, {len(pred.loops.captures)} decode chunk keys; reserved "
                       f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    print(f"    captured by the whole-page phases (6 to 12): {whole_page_keys}")
    print(f"      recognition: {store_report(pred.programs)}")
    print(f"      detection: {store_report(det.programs)}")
    settings.RECOGNITION_MODEL_QUANTIZE = False
    set_pin(False)

    layout_pages = bench_pages(LAYOUT_PAGES)
    print(f"[13] layout analysis at full width, random bf16 weights: {LAYOUT_PAGES} pages of 1240x1754")
    lay = check_layout(layout_pages, power)
    print(f"[14] table recognition at full width, random bf16 weights, synthetic {TABLE_ROWS} x {TABLE_COLS} "
          f"tables: {TABLE_CROPS} crops of 768x768")
    tab = check_table_rec(layout_pages, power)
    print(f"    after phases 13 and 14: {memory()}")
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
    print(f"    after phase 17: {memory()}")
    print(f"[18] the five CLIs on {CLI_PAGES} pages of 1240x1754, then ocr_latex as a process of its own")
    check_clis(pred, det, lay, tab, power)
    set_pin(False)
    print("[19] checkpoint round trip at full width: the five models written as upstream checkpoints (bf16), "
          "their predictors built from them twice (conversion, then the cache)")
    check_checkpoints(pred, det, lay, tab, oe, power)
    release()
    print(f"    after phase 19: {memory()}")

    logical = [torch.device("cuda", 0)] * 4
    print(f"[20] the mesh: given-lines recognition at production width ({N_PAGES} pages of {LINES_PER_PAGE} lines, "
          f"pinned {PIN_TOKENS} tokens), bf16 and int8 cache, on logical meshes of cuda:0 "
          f"{['x'.join(map(str, m)) for m in MESH_SHAPES]}, against the unsharded predictor")
    records = check_mesh_recognition(pred, pages, bboxes, logical, MESH_SHAPES, (False, True), power, "logical")
    print("[21] the mesh wrappers on a 2x2 logical mesh at the meshed runs' shapes, against their plain versions")
    check_mesh_wrappers(results, gen, records, make_mesh(2, 2, logical))
    print("[22] detection, layout, table recognition and OCR error on a 2x1 logical mesh, against unsharded")
    check_mesh_batch_predictors(det, stream_pages[:4], power)
    release()
    print(f"    after phases 20 to 22: {memory()}")
    n_cards = torch.cuda.device_count()
    print(f"[23] the mesh over distinct cards ({n_cards} on this machine)")
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4))]
        shapes = ([(2, 2)] if len(cards) == 4 else []) + [(1, 2), (2, 1)]
        check_mesh_recognition(pred, pages, bboxes, cards, shapes, (False,), power, "cards")
        print(f"    the batch predictors on a 2x1 mesh of {cards[0]} and {cards[1]}")
        check_mesh_batch_predictors(det, stream_pages[:4], power, cards[:2])
    else:
        print("    not run: one card (phases 20 to 22 ran on logical meshes of cuda:0)")
    preds = {"detection": det, "recognition": pred, "layout": lay, "table_rec": tab, "ocr_error": oe}
    print(f"[24] the web server (surya_tpu_torch.scripts.web_app) on the predictors above: each action on "
          f"{WEB_PAGES} pages of 1240x1754, {WEB_CONCURRENT} requests at once, {WEB_WARM} warm requests, then a "
          f"process of its own; the OCR render's font fetch goes to {FONT_DL_BASE}, refused")
    check_web(preds, power)
    release()
    print(f"    after phase 24: {memory()}")
    print("[25] the streamlit apps under a stub streamlit module: streamlit_app.main() and texify_app.run()")
    check_streamlit_apps(preds, power)
    print(f"[26] bench.py's workload: {BENCH_PAGES} pages of its build_page() ({BENCH_LINES} lines at "
          f"font_size=22), {PIN_TOKENS} pinned tokens a line, a {PIN_TOKENS}-step decode chunk, bf16 cache, "
          f"new predictors at full width; the best of {BENCH_TRIALS} trials")
    bench_counts, bench_held = check_bench_workload(gen, power)
    release()
    print(f"    after phase 26: {memory()}")
    print(f"[27] the checkpoint-validation command (surya_tpu_torch.scripts.validate_checkpoints): (a) all six "
          f"gates on checkpoints written from the models above, {VALIDATION_ROWS} in-memory rows a stage, random "
          f"weights off; (b) --smoke as a process of its own")
    t27 = time.perf_counter()
    check_validation_gated(pred, det, lay, tab, power)
    check_validation_smoke(power)
    release()
    print(f"    phase 27 took {time.perf_counter() - t27:.1f} s; {memory()} [{power}]")
    print(f"[28] the AR loops as CUDA graph replays (each step in an IF node) against the eager loop on the same "
          f"inputs: recognition's decode chunk at production width ({GRAPH_SLOTS} slots, and {GRAPH_FEW} of a "
          f"1536-row cache in K3 clusters; {PIN_TOKENS} steps), "
          f"layout of {LAYOUT_PAGES} pages as called and cap-bound, table rec of the synthetic tables")
    t28 = time.perf_counter()
    check_graphed_chunks(pred, gen, power)
    check_graphed_box_loops(lay, tab, layout_pages, power)
    print(f"    recognition's own decode graphs: {pool_mib(pred.loops)}")
    check_alternating_cache_lengths(pred, power)
    print(f"    phase 28 took {time.perf_counter() - t28:.1f} s; {memory()} [{power}]")
    print("[29] the one-shot programs as CUDA graph replays against their plain version on the same inputs: "
          "detection's stats program (the flood a WHILE node) and maps program, recognition's prefill wave alone "
          "and fused with its decode chunk, and a capture on the streaming path's detection worker thread")
    t29 = time.perf_counter()
    print(f"    keys the whole-page phases captured: {whole_page_keys}")
    check_detection_programs(det, power)
    check_prefill_programs(pred, det, power)
    release()
    print(f"    before the streaming capture: {memory()}")
    check_streaming_capture(pred, det, power)
    print(f"    phase 29 took {time.perf_counter() - t29:.1f} s; reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB [{power}]")
    print(f"[30] the last jitted programs as CUDA graph replays against their plain version on the same inputs: "
          f"layout's whole generate (the encoder inside the box loop's graph) as called and cap-bound, table rec's "
          f"encode, OCR error's forward, and the meshed decode chunk at production width on a 2x2 logical mesh "
          f"({MESH_GRAPH_SLOTS} slots, {PIN_TOKENS} steps, each step in an IF node)")
    t30 = time.perf_counter()
    check_layout_program(lay, layout_pages, power)
    check_table_encode_program(tab, layout_pages, power)
    check_ocr_error_program(oe, power)
    check_meshed_chunk(pred, gen, power)
    print(f"    phase 30 took {time.perf_counter() - t30:.1f} s; reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB [{power}]")
    print(f"[31] the meshed programs and table rec's whole generate as CUDA graph replays against their plain "
          f"versions on the same inputs: table rec's passes ({TABLE_CROPS} synthetic tables, and a "
          f"{TABLE_CELL_ROWS}-row cell pass), the meshed prefill on logical meshes "
          f"{['x'.join(map(str, m)) for m in MESH_SHAPES]} of cuda:0, meshed detection's programs on 2x1; then "
          f"one meshed decode step against one unsharded step (the token ids' agreement)")
    t31 = time.perf_counter()
    check_table_generate(tab, layout_pages, power)
    check_meshed_prefill(pred, pages, bboxes, power)
    check_meshed_detection(det, stream_pages[:4], power)
    check_meshed_ids(pred, gen, power)
    print(f"    phase 31 took {time.perf_counter() - t31:.1f} s; reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB [{power}]")

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
    # the mesh wrappers: K1-mesh in the 1x2 run, the others in the 2x2 runs (bf16, int8 cache)
    for wrapper, run, counter in [
        ("segmented_block_attention_shard_map", ((1, 2), False), "segmented_block_attention_shard_map"),
        ("causal_flash_attention_shard_map", ((2, 2), False), "causal_flash_attention_shard_map"),
        ("gqa_decode_shard_map", ((2, 2), False), "gqa_decode_shard_map"),
        ("gqa_decode_shard_map_int8", ((2, 2), True), "gqa_decode_shard_map"),
    ]:
        run_counts = records[run][0]
        launches[wrapper] = run_counts[wrapper]
        results[wrapper]["launches_by_shard"] = {f"{d},{m}": c for (d, m), c in
                                                 run_counts[f"{counter} by shard"].items()}
        results[wrapper]["mesh"] = f"{run[0][0]}x{run[0][1]} of cuda:0"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "main_path", "by_step",
            "long_cache", "mesh", "per_shard", "launches_by_shard")
    # phase 26 (bench.py's workload): the best trial's launches (K1's of both
    # block kinds together) and the times at its first wave's and first decode
    # call's shapes
    bench_launches = {"segmented_block_attention[full]": ("k1_launches", "segmented_block_attention"),
                      "segmented_block_attention[window]": ("k1_launches", "segmented_block_attention"),
                      "causal_flash_attention": ("launches", "causal_flash_attention"),
                      "gqa_decode": ("launches", "gqa_decode")}
    for n, (key, counter) in bench_launches.items():
        held = bench_held[n]
        results[n]["bench_workload"] = {key: bench_counts[counter], **{
            k: held[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "main_path")
            if k in held}}
    keys += ("bench_workload",)
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": launches[n],
         **{key: results[n][key] for key in keys if key in results[n]}}
        for n, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
