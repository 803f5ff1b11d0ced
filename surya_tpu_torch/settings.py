"""Settings of the PyTorch port: read once from the environment.

The names are those the JAX package's recognition path reads, so one
environment configures both. Device and dtype are explicit: ``TORCH_DEVICE``
names the device ("cuda", "cuda:1", "cpu"); without it the port takes the
first CUDA device when there is one and the CPU otherwise. A CUDA device that
is asked for and absent raises; nothing falls back to the CPU. The model runs
in bfloat16 on CUDA and in float32 on the CPU.
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


class Settings:
    def __init__(self, env: Mapping[str, str] = os.environ):
        self.TORCH_DEVICE: Optional[str] = env.get("TORCH_DEVICE") or None
        self.ALLOW_RANDOM_WEIGHTS = _bool(env, "ALLOW_RANDOM_WEIGHTS")
        self.WEIGHT_SEED = int(env.get("WEIGHT_SEED", "0") or 0)
        self.DISABLE_TQDM = _bool(env, "DISABLE_TQDM")
        # recognition
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
    cuda when available, else cpu. Raises for a CUDA device that is absent."""
    dev = torch.device(device or settings.TORCH_DEVICE or ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def model_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32
