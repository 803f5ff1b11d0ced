"""A throwaway checkout for the CPU tests: a copy of perfbench/ beside a
link to the program, with a BENCHMARK.json of tiny cells (the program's
tiny configurations, a few small pages) whose configuration, traffic and
limit files are added to the copy, as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

OCR = {
    "name": "tiny_ocr", "system": "ocr", "rate_metric": "ocr_pages_per_s",
    "model": {
        "dtype": "float32", "vocab_size": 65825, "image_embed_encoding_size": 1024,
        "image_embed_encoding_multiplier": 256, "line_image_size": [1024, 256],
        "encoder": {"depth": 2, "hidden_size": 64, "intermediate_size": 128, "num_heads": 4, "patch_size": 14,
                    "spatial_merge_size": 2, "window_size": 56, "out_hidden_size": 96,
                    "fullatt_block_indexes": [1], "rope_theta": 10000.0},
        "decoder": {"hidden_size": 96, "intermediate_size": 192, "num_hidden_layers": 2, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "rope_theta": 10000.0, "rms_norm_eps": 1e-06},
        "tokens": {"eos": 256, "eoi": 257, "image": 258, "pad": 259, "registers": [262, 263, 264, 265],
                   "ocr_with_boxes": 267},
    },
    "serving": {"slots": 8, "decode_chunk": 12},
    "weights": {"seed": 7, "scale": "fan_in"},
}
LAYOUT = {
    "name": "tiny_layout", "system": "layout", "rate_metric": "layout_pages_per_s",
    "model": {
        "dtype": "float32", "vocab_size": 1025, "bbox_size": 1024, "skew_scaler": 512, "label_count": 20,
        "bos_token_id": 1, "layer_norm_eps": 1e-05, "page_footer_class": 12, "page_header_class": 13,
        "slicing": {"min_width": 1500, "min_height": 1500, "width": 1200, "height": 1200, "max_slices": 4},
        "encoder": {"image_size": [128, 128], "patch_size": 4, "embed_dim": 16, "depths": [1, 1],
                    "num_heads": [2, 4], "num_kv_heads": [2, 4], "window_size": 8, "encoder_length": 1024,
                    "use_positional_embeddings": True},
        "decoder": {"num_hidden_layers": 2, "hidden_size": 32, "intermediate_size": 64, "encoder_hidden_size": 32,
                    "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
                    "rms_norm_eps": 1e-06, "double_residual_flow": True},
    },
    "serving": {"batch_tiles": 4, "dispatch_tiles": 2},
    "weights": {"seed": 8, "scale": "fan_in"},
}
PAGE = {"width": 1240, "height": 1754, "lines": 4, "x0": 60, "y0": 40, "pitch": 42, "font_size": 22,
        "text": "Line {i}: the quick brown fox."}
TRAFFIC = {
    "tiny_pages": {"call": "whole_page", "pages_per_call": 2, "page_pool": 2, "page": PAGE, "decode_tokens": 12,
                   "sample_lines": 8, "trace_calls": 1},
    "tiny_lines": {"call": "given_lines", "pages_per_call": 2, "page_pool": 2, "page": PAGE, "line_pad": 4,
                   "decode_tokens": 12, "sample_lines": 8, "trace_calls": 1},
    "tiny_boxes": {"call": "layout", "pages_per_call": 2, "page_pool": 4, "page": PAGE, "max_boxes": 5,
                   "sample_tiles": 3, "trace_calls": 1},
}
CELLS = {"tiny.ocr.pages": ("tiny_ocr", "tiny_pages"), "tiny.ocr.lines": ("tiny_ocr", "tiny_lines"),
         "tiny.layout": ("tiny_layout", "tiny_boxes")}
# the limits of the tiny cells: exact where the comparison is exact; at
# float32 on the CPU the program's logits and log-probabilities read within
# about 1e-5 of the reference's (its tests' tolerance is 1e-4), its boxes
# within 1e-3 of 1024; the bfloat16 control reads 1e-2 and more
TOKEN = {"limits": {"crop_diff": 0, "bad_tokens": 0}, "tolerances": {"token": 1e-4}}
LIMITS = {"tiny.ocr.pages": {"limits": {"det_line_errors": 0, **TOKEN["limits"]}, "tolerances": TOKEN["tolerances"]},
          "tiny.ocr.lines": TOKEN,
          "tiny.layout": {"limits": {"box_diff": 1e-2, "class_gap": 1e-3}}}


def checkout(tmp: Path) -> Path:
    """The throwaway checkout under `tmp`; returns its root."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "surya_tpu_torch", root / "surya_tpu_torch")
    for cfg in (OCR, LAYOUT):
        (root / "perfbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, mix in TRAFFIC.items():
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, limits in LIMITS.items():
        (root / "perfbench" / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": c["name"], "source": "tiny", "file": f"perfbench/configs/{c['name']}.json",
                         "reduced": [], "why": "tiny"} for c in (OCR, LAYOUT)]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                          for n, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "layout" if "layout" in m["name"] else "ocr"
            m["workloads"] = [n for n in CELLS if kind in n]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, cell: str, seed: int, trace: int = 0, control: int = 0, setup: str = "",
             timeout: int = 900) -> dict:
    """One CPU run of `cell` in a process of its own, the program at its tiny
    widths (`setup`: Python run first, e.g. to plant a fault); returns the
    result line, with the process's standard error under "stderr"."""
    # the setup runs once the program's settings are in the environment,
    # before the program is first imported
    indented = "".join(f"    {line}\n" for line in setup.splitlines())
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from perfbench import harness\n"
        "_environment = harness.program_environment\n"
        "def _setup(env):\n"
        "    _environment(env)\n"
        f"{indented}"
        "harness.program_environment = _setup\n"
        f"sys.exit(harness.run(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '1', '--trace', '{trace}',"
        f" '--control', '{control}'], device='cpu', tiny=True, bench_path=harness.ROOT / 'BENCHMARK.json'))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["TORCH_DEVICE"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"the run exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["stderr"] = proc.stderr
    return out
