"""Checkpoint reading: upstream torch safetensors -> the JAX package's
parameter pytrees (counterpart of surya_tpu/common/weights.py).

The port's ``convert_torch`` functions are line-for-line counterparts of the
JAX package's and return the same pytree, with numpy float32 leaves in the
JAX layout (linear kernels [in, out], conv kernels HWIO, batch-norm folded);
``nn.load_jax_params`` then carries that tree into the port's modules and
checks that every leaf and every parameter meet.

Upstream checkpoints store bfloat16, which numpy cannot hold: the files are
read with ``framework="pt"`` and every float tensor is taken as float32
(bf16 -> float32 is exact). The JAX package reads with ``framework="np"``,
which fails on a bf16 tensor.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from surya_tpu_torch.logging import get_logger

logger = get_logger()


def load_safetensors_dir(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """Every tensor of every *.safetensors file in a checkpoint directory, as
    one flat {torch key: numpy array} dict, floats as float32."""
    from safetensors import safe_open

    tensors: Dict[str, np.ndarray] = {}
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors") and not f.startswith("."))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {ckpt_dir}")
    for fname in files:
        with safe_open(os.path.join(ckpt_dir, fname), framework="pt") as f:
            for key in f.keys():
                t = f.get_tensor(key)
                tensors[key] = (t.float() if t.is_floating_point() else t).numpy()
    return tensors


def load_config_json(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return json.load(f)


def from_torch_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """An in-memory torch state dict as {key: float32 numpy array}."""
    return {k: v.detach().to("cpu").float().numpy() for k, v in state_dict.items()}


def fold_batchnorm(weight, bias, running_mean, running_var, eps: float = 1e-5) -> dict:
    """torch BatchNorm2d statistics as an affine scale and bias, in float32,
    with the arithmetic of surya_tpu's nn.fold_batchnorm."""
    weight, bias, running_mean, running_var = (np.asarray(a, np.float32)
                                               for a in (weight, bias, running_mean, running_var))
    scale = weight / np.sqrt(running_var + np.float32(eps))
    return {"scale": scale, "bias": bias - running_mean * scale}


class TensorBag:
    """A flat tensor dict with typed accessors that do the torch -> JAX
    layout remaps, recording which keys were consumed so that a converter
    can report the tensors it left unused."""

    def __init__(self, tensors: Dict[str, np.ndarray]):
        self.tensors = tensors
        self.used: set = set()

    def _take(self, key: str) -> np.ndarray:
        if key not in self.tensors:
            raise KeyError(f"checkpoint missing tensor {key!r}")
        self.used.add(key)
        return self.tensors[key]

    def raw(self, key: str) -> np.ndarray:
        return np.asarray(self._take(key), np.float32)

    def conv(self, prefix: str, bias: bool | None = None) -> dict:
        p = {"kernel": self.raw(f"{prefix}.weight").transpose(2, 3, 1, 0)}  # OIHW -> HWIO
        if bias is None:
            bias = f"{prefix}.bias" in self.tensors
        if bias:
            p["bias"] = self.raw(f"{prefix}.bias")
        return p

    def linear(self, prefix: str, bias: bool | None = None) -> dict:
        p = {"kernel": self.raw(f"{prefix}.weight").T}  # [out, in] -> [in, out]
        if bias is None:
            bias = f"{prefix}.bias" in self.tensors
        if bias:
            p["bias"] = self.raw(f"{prefix}.bias")
        return p

    def batchnorm(self, prefix: str, eps: float = 1e-5) -> dict:
        folded = fold_batchnorm(
            self._take(f"{prefix}.weight"), self._take(f"{prefix}.bias"),
            self._take(f"{prefix}.running_mean"), self._take(f"{prefix}.running_var"), eps=eps,
        )
        self.used.add(f"{prefix}.num_batches_tracked")
        return folded

    def layernorm(self, prefix: str) -> dict:
        return {"scale": self.raw(f"{prefix}.weight"), "bias": self.raw(f"{prefix}.bias")}

    def rmsnorm(self, prefix: str) -> dict:
        return {"scale": self.raw(f"{prefix}.weight")}

    def embedding(self, prefix: str) -> dict:
        return {"embedding": self.raw(f"{prefix}.weight")}

    def warn_unused(self, context: str = ""):
        unused = {k for k in set(self.tensors) - self.used if not k.endswith("num_batches_tracked")}
        if unused:
            logger.warning("%s: %d checkpoint tensors unused, e.g. %s", context, len(unused), sorted(unused)[:5])
