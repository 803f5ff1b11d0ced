"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``surya_tpu_torch/csrc``, checks
each against its plain PyTorch version at the shapes the recognition path
gives it, then drives ``RecognitionPredictor`` at the production widths with
random bf16 weights over 4 synthetic pages of 8 line boxes each (pinned to
40 tokens per line, then with free-running stops), and shows through the
kernels' launch counts that the path ran on them. Finally it runs one
prefill and one decode step through the kernels and through the plain
versions and compares them.

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

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the GPU")

os.environ.setdefault("ALLOW_RANDOM_WEIGHTS", "true")
os.environ.setdefault("DISABLE_TQDM", "true")

from PIL import Image  # noqa: E402

from surya_tpu_torch.models import qwen_decoder  # noqa: E402
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
# kernel vs plain version, elementwise: both round an fp32 result to bf16, so
# they may differ by one bf16 spacing (2^-7 relative) plus a small floor
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 1e-3
MODEL_RATIO = 2.0  # see check_model_paths: bf16 rounding compounds over 18 layers either way
KERNELS = {
    "segmented_block_attention": (flash.segmented_block_attention, "surya_tpu_torch/csrc/flash_attn.cu",
                                  "surya_tpu/ops/flash.py:215"),
    "causal_flash_attention": (flash.causal_flash_attention, "surya_tpu_torch/csrc/flash_attn.cu",
                               "surya_tpu/ops/flash.py:64"),
    "gqa_decode": (decode_attn.gqa_decode, "surya_tpu_torch/csrc/decode_attn.cu",
                   "surya_tpu/ops/decode_attn.py:187"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of one call on the device, CUDA events around `reps` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel, plain, results, reps=20):
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
    err = diff.max().item()
    n_bad = int((diff > KERNEL_RTOL * mag + KERNEL_ATOL).sum())
    ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(plain, max(2, reps // 4))
    print(f"  {name}: max_abs_err {err:.3e} (|ref| max {mag.max().item():.3f}; tol {KERNEL_RTOL:.4g}*|ref| "
          f"+ {KERNEL_ATOL}: {n_bad} outside); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} elements of the kernel's output disagree with its plain version")
    res = results.setdefault(name.split("[")[0], {"max_abs_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res.setdefault("ms", ms)  # the first case listed is the kernel's main-path shape
    res.setdefault("plain_ms", plain_ms)


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


def check_kernels(results):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=0.3):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    # K1 at the smoke's own packed wave: 32 lines, the real layout plan
    cfg = EncoderConfig(**DEFAULT_ENCODER)
    grids = [(h // 14, w // 14) for h, w in LINE_SHAPES] * N_PAGES
    n_patches = sum(a * b for a, b in grids)
    cap = 4096
    while cap < n_patches:
        cap *= 2
    plan = plan_layout(grids, cfg, cap)
    S, H, D = cap, cfg.num_heads, cfg.head_dim
    qkv = randn(S, 3, H, D)
    q = (qkv[:, 0].float() / 0.3).to(torch.bfloat16)  # peaky attention: unit-scale queries
    k, v = qkv[:, 1], qkv[:, 2]  # strided views, as the encoder passes them
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for label, gid, starts, rng_len in [
        ("full", plan.seg_id, plan.kv_starts, plan.kv_range),
        ("window", plan.win_id, plan.win_starts, plan.win_range),
    ]:
        gid_t, starts_t = t(gid), t(starts)
        print(f"  K1 [{label}] S={S} H={H} D={D} kv_range={rng_len} "
              f"(kv_starts max {int(starts.max())})")
        compare(
            f"segmented_block_attention[{label}]",
            lambda: flash.segmented_block_attention(q, k, v, gid_t, starts_t, rng_len),
            lambda: flash.segmented_block_attention_reference(q, k, v, gid_t, starts_t, rng_len),
            results,
        )

    # K2 at the smoke's prefill wave (32 rows, 128 bucket) and the largest bucket
    for B, L in [(32, 128), (2, 1536)]:
        qc, kc, vc = randn(B, L, 12, 128, scale=1.0), randn(B, L, 4, 128), randn(B, L, 4, 128)
        print(f"  K2 B={B} L={L} H=12 kvh=4 D=128")
        compare(
            f"causal_flash_attention[{L}]",
            lambda: flash.causal_flash_attention(qc, kc, vc),
            lambda: flash.causal_flash_attention_reference(qc, kc, vc),
            results,
        )

    # K3: 128 slots + trash, 10 layers, a 512-row cache, 64-column chunks, ragged lengths
    B, S3, K, layers = 129, 512, 64, 10
    qd = randn(B, 12, 128, scale=1.0)
    kcache, vcache = randn(layers, B, 4, S3, 128), randn(layers, B, 4, S3, 128)
    ck, cv = randn(layers, B, 4, K, 128), randn(layers, B, 4, K, 128)
    lens_np = np.random.default_rng(SEED).integers(0, S3 + 1, B).astype(np.int32)
    lens_np[:4] = [0, 1, 117, S3]
    lens = t(lens_np)
    for step, layer in [(37, 7), (0, 0), (63, 9)]:
        print(f"  K3 B={B} S={S3} K={K} step={step} layer={layer}")
        compare(
            f"gqa_decode[{step}]",
            lambda: decode_attn.gqa_decode(qd, kcache, vcache, lens, ck, cv, step, layer),
            lambda: decode_attn.gqa_decode_reference(qd, kcache, vcache, lens, ck, cv, step, layer),
            results,
        )


def run_predictor(pred, pages, bboxes, pin: bool):
    settings.RECOGNITION_PIN_DECODE = pin
    settings.RECOGNITION_MAX_TOKENS = PIN_TOKENS if pin else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pred(pages, bboxes=bboxes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_lines = sum(len(r.text_lines) for r in results)
    if len(results) != len(pages) or any(len(r.text_lines) != LINES_PER_PAGE for r in results):
        raise AssertionError(f"expected {len(pages)} pages of {LINES_PER_PAGE} lines")
    for r in results:
        for line in r.text_lines:
            if not (isinstance(line.text, str) and np.isfinite(line.confidence) and 0 <= line.confidence <= 1):
                raise AssertionError(f"bad line {line.text!r} {line.confidence}")
            if any(not np.isfinite(c.confidence) for c in line.chars):
                raise AssertionError("non-finite char confidence")
    return wall, n_lines, pred.last_decoded_tokens


def check_model_paths(pred, pages, bboxes):
    """One prefill wave, then one decode step over the cache it filled, run
    three ways on the same weights and inputs: bf16 through the kernels, bf16
    through the plain versions, and float32 through the plain versions. The
    kernel path must be no further from the float32 run than MODEL_RATIO
    times the plain bf16 path is."""
    proc = pred.processor
    flat = pred.slice_bboxes(pages, ["ocr_with_boxes"] * len(pages), bboxes=bboxes)
    imgs = [pred._prepare_image(s, "ocr_with_boxes") for s in flat["slices"]]
    n = len(imgs)
    batch = proc.build_prefill_batch(
        imgs, flat["task_names"], flat["input_text"], [True] * n, pred.config.encoder,
        batch_rows=n, seq_buckets=pred.seq_buckets, patch_caps=pred.patch_caps,
    )
    lay = batch.layout
    t = pred._tensor
    enc_args = tuple(t(a) for a in lay.device_args)
    dec = pred.config.decoder
    slots = torch.arange(n, device=pred.device)

    def run(model, use_kernels, dtype):
        patches = proc.normalize_patch_rows(t(batch.patches), dtype)
        img = model.encode_images(patches, enc_args, t(lay.llm_h_idx), t(lay.llm_w_idx),
                                  lay.kv_range, lay.win_range, use_kernels=use_kernels)
        embeds = model.embed_prompt_tokens(t(batch.input_ids), t(batch.img_gather), img)
        nk, nv, last = model.decoder.prefill(embeds, t(batch.seq_lens), use_kernels=use_kernels)
        cache = qwen_decoder.init_cache(dec, n, 256, dtype, pred.device)
        qwen_decoder.merge_prefill(cache, nk, nv, t(batch.seq_lens), slots)
        ck = torch.zeros((dec.num_hidden_layers, n, dec.num_key_value_heads, 8, dec.head_dim),
                         dtype=dtype, device=pred.device)
        emb = model.token_embed(t(batch.input_ids[:, 0].astype(np.int64)))
        hid = model.decoder.decode_step_chunked(cache, ck, torch.zeros_like(ck), emb, 0,
                                                cache["len"].clone(), use_kernels=use_kernels)
        return {"image tokens": img[: lay.n_llm_tokens], "prefill hidden": last, "decode hidden": hid}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    with torch.inference_mode():
        kern = run(pred.model, True, pred.dtype)
        plain = run(pred.model, False, pred.dtype)
        model32 = copy.deepcopy(pred.model).float()
        ref = run(model32, False, torch.float32)
        del model32
    for key in kern:
        e_k, e_p = rel(kern[key], ref[key]), rel(plain[key], ref[key])
        print(f"  {key}: rel err vs float32 plain: kernels {e_k:.3e}, plain bf16 {e_p:.3e}; "
              f"kernels vs plain bf16 {rel(kern[key], plain[key]):.3e}")
        if not (np.isfinite(e_k) and e_k <= MODEL_RATIO * e_p):
            raise AssertionError(f"{key}: kernel path is further from float32 than {MODEL_RATIO}x the plain path")


def main():
    name = torch.cuda.get_device_name(0)
    power = card()
    print(f"[1] card: {power}")
    lib = _build.library()
    print(f"    kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())

    print("[2] kernels vs plain versions (bf16, CUDA events)")
    results = {}
    check_kernels(results)

    print("[3] RecognitionPredictor at production width, random bf16 weights")
    t0 = time.perf_counter()
    pred = RecognitionPredictor(device="cuda")
    print(f"    model built in {time.perf_counter() - t0:.1f} s")
    pages, bboxes = synthetic_pages(np.random.default_rng(SEED))
    run_predictor(pred, pages[:1], bboxes[:1], pin=True)  # warm-up (cuBLAS, allocator)
    counts = {}
    for label, pin in [("pinned 40", True), ("free-running", False)]:
        for fn, _, _ in KERNELS.values():
            fn.launches = 0
        wall, n_l, n_t = run_predictor(pred, pages, bboxes, pin=pin)
        counts[label] = {n: fn.launches for n, (fn, _, _) in KERNELS.items()}
        if pin and n_t != PIN_TOKENS * N_PAGES * LINES_PER_PAGE:
            raise AssertionError(f"pinned run decoded {n_t} tokens, want {PIN_TOKENS} per line")
        print(f"    {label}: {wall:.3f} s wall, {n_l / wall:.2f} lines/s, {n_t} tokens, "
              f"{n_t / wall:.1f} decoded tokens/s [{power}]")

    print("[4] kernel launches in each predictor run")
    for label, run_counts in counts.items():
        print(f"    {label}: {run_counts}")
        for n, c in run_counts.items():
            if c <= 0:
                raise AssertionError(f"{n} was never launched in the {label} run")

    print("[5] kernels vs plain versions inside the model")
    check_model_paths(pred, pages[:1], bboxes[:1])

    report = {"kernels": [  # launches: the pinned run's
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": counts["pinned 40"][n],
         "max_abs_err": results[n]["max_abs_err"], "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"]}
        for n, (_, src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
