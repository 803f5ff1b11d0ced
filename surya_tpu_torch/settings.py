"""Settings of the PyTorch port: read once from the environment.

The names are those the JAX package's recognition path reads, so one
environment configures both. Device and dtype are explicit: a predictor's
``device`` argument, else ``TORCH_DEVICE`` ("cuda", "cuda:1", "cpu"), else
"cuda". The CPU runs only where it is asked for: a CUDA device that is asked
for, or left as the default, and absent raises; nothing falls back to the
CPU. The model runs in bfloat16 on CUDA and in float32 on the CPU.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch


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


def _int_tuple(env: Mapping[str, str], name: str, default: tuple) -> tuple:
    value = env.get(name, "").strip().strip("()[]")
    return tuple(int(v) for v in value.split(",") if v.strip()) if value else default


def _float(env: Mapping[str, str], name: str, default: float) -> float:
    value = env.get(name, "").strip()
    return float(value) if value else default


class Settings:
    """The fields are read from the environment once, at import; code reads
    them from this object when it runs, so a caller may change a field
    between calls (as the tests do)."""

    def __init__(self, env: Mapping[str, str] = os.environ):
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


def model_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32
