"""Settings of the PyTorch port: read once from the environment and local.env.

The names are those the JAX package reads, so one environment configures
both: ``os.environ`` over a ``local.env`` file in the working directory
(``KEY=value`` lines), as in the JAX package. Device and dtype are
explicit: a predictor's ``device`` argument, else ``TORCH_DEVICE`` ("cuda",
"cuda:1", "cpu"), else "cuda". The CPU runs only where it is asked for: a
CUDA device that is asked for, or left as the default, and absent raises;
nothing falls back to the CPU. The model runs in bfloat16 on CUDA and in
float32 on the CPU.

Where the JAX package's defaults are "auto: on for TPU" (the detection
device resize and device postprocess), the port's are "auto: on for CUDA":
None in the field, resolved against the predictor's device when it runs
(``on_for_cuda``); the detection pipeline batch is 8 rows on CUDA.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch


def load_dotenv(path: str = "local.env") -> Dict[str, str]:
    """``KEY=value`` lines of a dotenv file (none if it is absent): blank
    lines and ``#`` comments skipped, quotes around a value stripped."""
    out: Dict[str, str] = {}
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip().strip("'\"")
    return out


def _opt_int(env: Mapping[str, str], name: str) -> Optional[int]:
    value = env.get(name, "").strip()
    return int(value) if value else None


def _bool(env: Mapping[str, str], name: str, default: bool = False) -> bool:
    value = env.get(name, "").strip().lower()
    if not value:
        return default
    if value in ("1", "true", "yes", "on"):
        return True
    if value in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name}={value!r} is not a boolean")


def _opt_bool(env: Mapping[str, str], name: str) -> Optional[bool]:
    """None (auto) when unset or "auto", else the boolean."""
    value = env.get(name, "").strip().lower()
    return None if value in ("", "auto", "none") else _bool(env, name)


def _int_tuple(env: Mapping[str, str], name: str, default: tuple) -> tuple:
    value = env.get(name, "").strip().strip("()[]")
    return tuple(int(v) for v in value.split(",") if v.strip()) if value else default


def _float(env: Mapping[str, str], name: str, default: float) -> float:
    value = env.get(name, "").strip()
    return float(value) if value else default


def _json_dict(env: Mapping[str, str], name: str, default: dict) -> dict:
    value = env.get(name, "").strip()
    return json.loads(value) if value else dict(default)


class Settings:
    """The fields are read once, at import, from ``env``, by default the
    environment over the working directory's ``local.env`` (the environment
    wins); code reads them from this object when it runs, so a caller may
    change a field between calls (as the tests do)."""

    def __init__(self, env: Optional[Mapping[str, str]] = None):
        if env is None:
            env = {**load_dotenv(), **os.environ}
        self.TORCH_DEVICE: Optional[str] = env.get("TORCH_DEVICE") or None
        self.ALLOW_RANDOM_WEIGHTS = _bool(env, "ALLOW_RANDOM_WEIGHTS")
        self.WEIGHT_SEED = int(env.get("WEIGHT_SEED", "0") or 0)
        self.DISABLE_TQDM = _bool(env, "DISABLE_TQDM")
        # detection (defaults of surya_tpu/settings.py)
        self.DETECTOR_BATCH_SIZE = _opt_int(env, "DETECTOR_BATCH_SIZE")
        self.DETECTOR_IMAGE_CHUNK_HEIGHT = int(env.get("DETECTOR_IMAGE_CHUNK_HEIGHT", "1400") or 1400)
        self.DETECTOR_TEXT_THRESHOLD = _float(env, "DETECTOR_TEXT_THRESHOLD", 0.6)
        self.DETECTOR_BLANK_THRESHOLD = _float(env, "DETECTOR_BLANK_THRESHOLD", 0.35)
        self.DETECTOR_POSTPROCESSING_CPU_WORKERS = int(
            env.get("DETECTOR_POSTPROCESSING_CPU_WORKERS", "") or min(8, os.cpu_count() or 1)
        )
        self.DETECTOR_MIN_PARALLEL_THRESH = int(env.get("DETECTOR_MIN_PARALLEL_THRESH", "3") or 3)
        self.DETECTOR_BOX_Y_EXPAND_MARGIN = _float(env, "DETECTOR_BOX_Y_EXPAND_MARGIN", 0.05)
        # the C++ CRAFT host op (native/craft_ops.cpp); off: the OpenCV path
        self.USE_NATIVE_POSTPROCESS = _bool(env, "USE_NATIVE_POSTPROCESS", True)
        # None = auto, on for CUDA: the double-LANCZOS chunk resize on the
        # device as two weight products (detection/resize.py) instead of PIL
        self.DETECTOR_DEVICE_RESIZE = _opt_bool(env, "DETECTOR_DEVICE_RESIZE")
        # None = auto, on for CUDA: connected components and their stats on
        # the device (ops/connected_components.py); the host gets the stats
        self.DETECTOR_ON_DEVICE_POSTPROCESS = _opt_bool(env, "DETECTOR_ON_DEVICE_POSTPROCESS")
        self.DETECTOR_MAX_COMPONENTS = int(env.get("DETECTOR_MAX_COMPONENTS", "512") or 512)
        # chunk rows per detection dispatch (None = auto: 8 on CUDA, the whole
        # batch on the CPU), so that a multi-page call keeps one dispatch in
        # flight while the host prepares the next
        self.DETECTOR_PIPELINE_BATCH = _opt_int(env, "DETECTOR_PIPELINE_BATCH")
        # None = auto (ship one channel when every chunk has R == G == B);
        # False: always three channels
        self.DETECTOR_GRAYSCALE_SHIP = _opt_bool(env, "DETECTOR_GRAYSCALE_SHIP")
        # recognition
        self.RECOGNITION_MODEL_QUANTIZE = _bool(env, "RECOGNITION_MODEL_QUANTIZE")  # int8 KV cache
        self.RECOGNITION_PAD_VALUE = int(env.get("RECOGNITION_PAD_VALUE", "255") or 255)
        self.RECOGNITION_MAX_TOKENS = _opt_int(env, "RECOGNITION_MAX_TOKENS")
        self.RECOGNITION_DECODE_CHUNK = int(env.get("RECOGNITION_DECODE_CHUNK", "64") or 64)
        self.RECOGNITION_PIN_DECODE = _bool(env, "RECOGNITION_PIN_DECODE")
        self.RECOGNITION_BATCH_SIZE = _opt_int(env, "RECOGNITION_BATCH_SIZE")
        self.RECOGNITION_SEQ_BUCKETS = _int_tuple(
            env, "RECOGNITION_SEQ_BUCKETS", (128, 256, 512, 1024, 1536)
        )
        # None = auto (ship one channel third of the patch rows when every
        # patch has R == G == B); False: always the three channels
        self.RECOGNITION_GRAYSCALE_SHIP = _opt_bool(env, "RECOGNITION_GRAYSCALE_SHIP")
        # whole-page OCR of more pages than this streams: detection of page
        # group k + 1 runs in a worker thread and feeds the live recognition
        # run; 0 turns it off (detection of every page, then recognition)
        self.RECOGNITION_DET_PIPELINE_PAGES = int(env.get("RECOGNITION_DET_PIPELINE_PAGES", "") or 8)
        # stream(): finished pages held for a slow consumer before the feeder
        # stops taking new pages (None = 4 x the page group)
        self.RECOGNITION_STREAM_BUFFER_PAGES = _opt_int(env, "RECOGNITION_STREAM_BUFFER_PAGES")
        # layout and table recognition (defaults of surya_tpu/settings.py;
        # the checkpoint, image-size and dataset fields wait for checkpoint
        # loading and a benchmark, since nothing in the port reads them yet)
        # pages above these sides are cut into tiles of about these sides
        self.LAYOUT_SLICE_MIN = _json_dict(env, "LAYOUT_SLICE_MIN", {"height": 1500, "width": 1500})
        self.LAYOUT_SLICE_SIZE = _json_dict(env, "LAYOUT_SLICE_SIZE", {"height": 1200, "width": 1200})
        self.LAYOUT_BATCH_SIZE = _opt_int(env, "LAYOUT_BATCH_SIZE")
        self.LAYOUT_MAX_BOXES = int(env.get("LAYOUT_MAX_BOXES", "") or 100)
        # tiles per layout dispatch (None = auto: 8 on CUDA, the whole batch
        # on the CPU), so that a multi-page call keeps one dispatch in flight
        self.LAYOUT_PIPELINE_BATCH = _opt_int(env, "LAYOUT_PIPELINE_BATCH")
        self.TABLE_REC_MAX_BOXES = int(env.get("TABLE_REC_MAX_BOXES", "") or 150)
        self.TABLE_REC_BATCH_SIZE = _opt_int(env, "TABLE_REC_BATCH_SIZE")
        # widest batch of the cell pass (pass 2): its batch doubles up to this
        self.TABLE_REC_CELL_BATCH_MAX = int(env.get("TABLE_REC_CELL_BATCH_MAX", "") or 128)

settings = Settings()


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``device``, else TORCH_DEVICE, else
    cuda. Raises for a CUDA device that is absent, also when it is the
    default: the CPU runs only when it is asked for."""
    dev = torch.device(device or settings.TORCH_DEVICE or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested (or the default) but CUDA is not available; "
                           "pass device='cpu' or set TORCH_DEVICE=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_for_cuda(value: Optional[bool], device: torch.device) -> bool:
    """An auto setting (None) is on for CUDA and off for the CPU."""
    return device.type == "cuda" if value is None else bool(value)


def model_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32
