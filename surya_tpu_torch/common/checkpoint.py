"""A model from a checkpoint directory, with the converted weights cached
(counterpart of surya_tpu/common/checkpoint.py).

The torch safetensors -> port conversion (common/weights.py and the models'
``convert_torch``) runs once per checkpoint and model dtype; its result, the
port model's state dict in that dtype, is stored as one safetensors file
next to the checkpoint, ``.torch_cache_{tag}_{dtype}_v1.safetensors``, so a
later load reads the port's tensors directly. The cache holds the weights
before any quantization, as the JAX package's does. A failed write logs a
warning and goes on; an unreadable cache is converted again.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.s3 import resolve_checkpoint
from surya_tpu_torch.common.weights import load_safetensors_dir
from surya_tpu_torch.logging import get_logger
from surya_tpu_torch.settings import settings

logger = get_logger()

_FORMAT_VERSION = "v1"


def cache_path(ckpt_dir: str, tag: str, dtype: torch.dtype) -> Path:
    return Path(ckpt_dir) / f".torch_cache_{tag}_{str(dtype).removeprefix('torch.')}_{_FORMAT_VERSION}.safetensors"


def save_converted(state_dict: Dict[str, torch.Tensor], ckpt_dir: str, tag: str, dtype: torch.dtype):
    from safetensors.torch import save_file

    path = cache_path(ckpt_dir, tag, dtype)
    tmp = path.with_name(path.name + ".tmp")
    try:
        save_file({k: v.contiguous() for k, v in state_dict.items()}, str(tmp))
        os.replace(tmp, path)
        logger.info("cached converted %s weights at %s", tag, path)
    except Exception as e:
        logger.warning("could not cache converted weights (%s)", e)
        tmp.unlink(missing_ok=True)


def load_converted(ckpt_dir: str, tag: str, dtype: torch.dtype) -> Optional[Dict[str, torch.Tensor]]:
    """The cached state dict, or None when there is none or it is unreadable."""
    from safetensors.torch import load_file

    path = cache_path(ckpt_dir, tag, dtype)
    if not path.exists():
        return None
    try:
        state_dict = load_file(str(path))
        logger.info("loaded converted %s weights from cache %s", tag, path)
        return state_dict
    except Exception as e:
        logger.warning("converted-weight cache unreadable (%s); re-converting", e)
        return None


def load_or_convert(ckpt_dir: str, tag: str, convert: Callable[[], Dict[str, torch.Tensor]],
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    state_dict = load_converted(ckpt_dir, tag, dtype)
    if state_dict is None:
        state_dict = convert()
        save_converted(state_dict, ckpt_dir, tag, dtype)
    return state_dict


def state_dict_from_jax(make: Callable[[], nn.Module], tree, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The state dict (CPU, `dtype`) of the module `make()` builds, holding the
    weights of a JAX-layout pytree with numpy leaves (``load_jax_params``
    checks that every leaf and every parameter meet)."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu").to(dtype)
    pnn.load_jax_params(model, tree)
    return model.state_dict()


def checkpoint_dir(name: str, tag: str) -> Optional[str]:
    """The local directory that checkpoint `name` resolves to (a directory,
    or an ``s3://`` name in the model cache or downloadable). When none
    does: None under ALLOW_RANDOM_WEIGHTS (random weights stand in, with a
    warning), else FileNotFoundError with the JAX loaders' message."""
    ckpt_dir = resolve_checkpoint(name)
    if ckpt_dir is None:
        if not settings.ALLOW_RANDOM_WEIGHTS:
            raise FileNotFoundError(
                f"{tag} checkpoint {name!r} not found locally and not downloadable; "
                "set ALLOW_RANDOM_WEIGHTS=true for random init (tests/benches only)"
            )
        logger.warning("%s: random-init weights (no checkpoint reachable)", tag)
    return ckpt_dir


def load_model(ckpt_dir: str, tag: str, make: Callable[[], nn.Module],
               convert: Callable[[Dict[str, np.ndarray]], dict], device: torch.device,
               dtype: torch.dtype) -> nn.Module:
    """The module `make()` builds, with the weights of the checkpoint in
    `ckpt_dir` (``convert`` maps its tensors to a JAX-layout pytree), in
    `dtype` on `device`, through the converted-weight cache."""
    state_dict = load_or_convert(
        ckpt_dir, tag, lambda: state_dict_from_jax(make, convert(load_safetensors_dir(ckpt_dir)), dtype), dtype,
    )
    with torch.device("meta"):
        model = make()
    model.load_state_dict(state_dict, strict=True, assign=True)
    logger.info("loaded %s checkpoint from %s", tag, ckpt_dir)
    return model.to(device).eval().requires_grad_(False)
