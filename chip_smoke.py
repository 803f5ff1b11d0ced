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
  through the int8 cache three ways, as above.

Exits non-zero on any failure and when no CUDA device is present. Prints the
card's name and power limit, one JSON line with the kernels' results, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the GPU")

os.environ.setdefault("ALLOW_RANDOM_WEIGHTS", "true")
os.environ.setdefault("DISABLE_TQDM", "true")

from PIL import Image  # noqa: E402

from surya_tpu_torch.detection import DetectionPredictor  # noqa: E402
from surya_tpu_torch.models import qwen_decoder  # noqa: E402
from surya_tpu_torch.models.efficientvit import install_blob_detector  # noqa: E402
from surya_tpu_torch.models.qwen_encoder import EncoderConfig, plan_layout  # noqa: E402
from surya_tpu_torch.ops import _build, decode_attn, flash  # noqa: E402
from surya_tpu_torch.recognition import RecognitionPredictor  # noqa: E402
from surya_tpu_torch.recognition.loader import DEFAULT_ENCODER  # noqa: E402
from surya_tpu_torch.settings import settings  # noqa: E402

SEED = 0
N_PAGES, LINES_PER_PAGE, PIN_TOKENS = 4, 8, 40
# line crops: sides multiples of 28 px, area in [168^2, 1024*256], so the
# processor neither rescales nor resizes them
LINE_SHAPES = [(56, 504), (56, 700), (84, 840), (56, 980), (84, 560), (56, 616), (84, 952), (56, 812)]
# whole-page OCR: 8 pages (the JAX predictor's sequential det->rec limit),
# one detection chunk each, 16 dark bands of 24 px every 62 px
OCR_PAGES, OCR_LINES, OCR_PAGE_SIZE = 8, 16, 1024
# kernel vs plain version, elementwise: both round an fp32 result to bf16, so
# they may differ by one bf16 spacing (2^-7 relative) plus a small floor
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 1e-3
MODEL_RATIO = 2.0  # see check_model_paths: bf16 rounding compounds over 18 layers either way
# the least time of a call: bytes over HBM bandwidth or bf16 operations over
# the dense tensor-core peak (NVIDIA H100 SXM data sheet), whichever is larger
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12
KERNELS = {  # name -> (wrapper, its launch counter, source, the TPU kernel it replaces)
    "segmented_block_attention": (flash.segmented_block_attention, "launches",
                                  "surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:215"),
    "causal_flash_attention": (flash.causal_flash_attention, "launches",
                               "surya_tpu_torch/csrc/flash_attn.cu", "surya_tpu/ops/flash.py:64"),
    "gqa_decode": (decode_attn.gqa_decode, "launches",
                   "surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:187"),
    "gqa_decode_int8": (decode_attn.gqa_decode, "launches_q",
                        "surya_tpu_torch/csrc/decode_attn.cu", "surya_tpu/ops/decode_attn.py:167"),
}


def reset_counts():
    for fn, attr, _, _ in KERNELS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {n: getattr(fn, attr) for n, (fn, attr, _, _) in KERNELS.items()}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device time of one call. `reps` calls are captured in a CUDA
    graph after a warm-up and the graph is replayed between two CUDA events,
    so the host's cost of launching does not enter the time. cold: each call
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
        with torch.cuda.graph(graph):
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


def compare(name, kernel, plain, results, work, library=None, reps=20, cold=False, report=False):
    """Hold a kernel against its plain version on the same inputs. work:
    (operations, bytes) the call needs; cold: time each call with a cold L2
    (see cuda_ms); report: the case is the kernel's main-path shape, whose
    times, bound and library time go in the kernels line."""
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
    res = results.setdefault(name.split("[")[0], {"max_abs_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    if report:
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def synthetic_full_pages(rng):
    """8 noisy 1024x1024 pages of 16 dark line bands each, 24 px tall every
    62 px, of random widths: what the detector's blob hook sees as lines."""
    pages = []
    for _ in range(OCR_PAGES):
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


def check_segmented(results, plan, gen, tag, report=False):
    """K1 over the layout plan of one prefill wave: its full-attention and
    its windowed blocks. Only the full case can be reported."""
    cfg = EncoderConfig(**DEFAULT_ENCODER)
    S, H, D = plan.cap, cfg.num_heads, cfg.head_dim
    qkv = randn(gen, S, 3, H, D)
    q = (qkv[:, 0].float() / 0.3).to(torch.bfloat16)  # peaky attention: unit-scale queries
    k, v = qkv[:, 1], qkv[:, 2]  # strided views, as the encoder passes them
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
            report=report and label == "full",
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


def check_decode(results, gen):
    """K3 and K3q: 128 slots + trash, 10 layers, a 512-row cache, 64-column
    chunks; K3q reads the same cache quantized to int8. Ragged lengths at
    three (step, layer) pairs, the first reported; then every slot at the
    longest length and every slot at the ragged mean: the same longest slot
    with twice the rows, and the same rows with a shorter longest slot."""
    B, S3, K, layers = 129, 512, 64, 10
    qd = randn(gen, B, 12, 128, scale=1.0)
    kcache, vcache = randn(gen, layers, B, 4, S3, 128), randn(gen, layers, B, 4, S3, 128)
    ck, cv = randn(gen, layers, B, 4, K, 128), randn(gen, layers, B, 4, K, 128)
    (kq, ks), (vq, vs) = qwen_decoder.quantize_kv(kcache), qwen_decoder.quantize_kv(vcache)
    ragged = np.random.default_rng(SEED).integers(0, S3 + 1, B).astype(np.int32)
    ragged[:4] = [0, 1, 117, S3]
    mean = int(round(ragged.mean()))
    cases = [("ragged", ragged, 37, 7), ("ragged", ragged, 0, 0), ("ragged", ragged, 63, 9),
             (f"all {S3}", np.full(B, S3, np.int32), 37, 7), (f"all {mean}", np.full(B, mean, np.int32), 37, 7)]
    for i, (label, lens_np, step, layer) in enumerate(cases):
        lens = to_cuda(lens_np)
        rows = int(lens_np.sum())  # valid cache rows of each kv head, over all slots
        ops = 4 * 12 * 128 * (rows + B * (step + 1))
        chunk_bytes = 2 * B * 4 * (step + 1) * 128 * 2
        other = 2 * nbytes(qd) + nbytes(lens)
        print(f"  K3 B={B} S={S3} K={K} step={step} layer={layer}, {label} lengths "
              f"(longest {int(lens_np.max())}; {rows} valid cache rows per kv head)")
        compare(
            f"gqa_decode[{step}, {label}]",
            lambda: decode_attn.gqa_decode(qd, kcache, vcache, lens, ck, cv, step, layer),
            lambda: decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer),
            results,
            work=(ops, 2 * rows * 4 * 128 * 2 + chunk_bytes + other),
            cold=True,  # a decode step reads each layer's cache once
            report=i == 0,
        )
        print("  K3q, the same with an int8 cache and bf16 row scales")
        compare(
            f"gqa_decode_int8[{step}, {label}]",
            lambda: decode_attn.gqa_decode(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
            lambda: decode_attn.gqa_decode_reference(qd, kq, vq, lens, ck, cv, step, layer, ks, vs),
            results,
            work=(ops, 2 * rows * 4 * (128 + 2) + chunk_bytes + other),
            cold=True,
            report=i == 0,
        )


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
    t = pred._tensor
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
        used = {n: c - before[n] for n, c in read_counts().items()}
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
    for B, L in [(32, 128), (2, 1536)]:
        check_causal(results, B, L, gen)
    check_decode(results, gen)

    print("[3] RecognitionPredictor at production width, random bf16 weights, given line boxes")
    t0 = time.perf_counter()
    pred = RecognitionPredictor(device="cuda")
    print(f"    model built in {time.perf_counter() - t0:.1f} s")
    pages, bboxes = synthetic_pages(np.random.default_rng(SEED))
    run_predictor(pred, pages[:1], bboxes[:1], pin=True)  # warm-up (cuBLAS, allocator)
    counts = {}
    for label, pin in [("pinned 40", True), ("free-running", False)]:
        reset_counts()
        wall, n_l, n_t = run_predictor(pred, pages, bboxes, pin=pin)
        counts[label] = read_counts()
        if pin and n_t != PIN_TOKENS * N_PAGES * LINES_PER_PAGE:
            raise AssertionError(f"pinned run decoded {n_t} tokens, want {PIN_TOKENS} per line")
        print(f"    {label}: {wall:.3f} s wall, {n_l / wall:.2f} lines/s, {n_t} tokens, "
              f"{n_t / wall:.1f} decoded tokens/s [{power}]")

    print("[4] kernel launches in each predictor run")
    for label, run_counts in counts.items():
        assert_launched(label, run_counts, ["segmented_block_attention", "causal_flash_attention", "gqa_decode"],
                        ["gqa_decode_int8"])

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
        det_wall, rec_wall, n_l, n_t = run_full_page(pred, det, ocr_pages, pin=pin)
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

    # launches: the pinned run of each kernel's path (K3, bf16 cache: given
    # lines; the others: whole-page OCR, int8 cache)
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts["pinned 40" if n == "gqa_decode" else "whole-page pinned 40"][n],
         **{key: results[n][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for n, (_, _, src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
