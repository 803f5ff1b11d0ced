"""Layers shared by the port's models (counterpart of surya_tpu/nn).

Linear layers are ``torch.nn.Linear``. The port's modules carry the names
of the JAX package's parameter pytrees, so ``load_jax_params`` carries JAX
weights over by path (JAX kernels are [in, out] and are transposed). RMSNorm
keeps the fp32 island of the JAX version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def init_normal_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Random init mirroring the JAX package's initializers: every Linear
    weight and Embedding table ~ N(0, std^2), biases 0, norm scales 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            with torch.no_grad():
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        elif isinstance(m, RMSNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)


# JAX leaf name -> PyTorch parameter name
_JAX_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*prefix, str(i)))
    else:
        yield prefix, tree


def load_jax_params(module: nn.Module, tree) -> None:
    """Copy a JAX parameter pytree (numpy leaves) into `module`, whose
    submodules carry the pytree's names: ``blocks/0/attn/qkv/kernel`` goes
    to ``blocks.0.attn.qkv.weight``, transposed, since JAX kernels are
    [in, out]. Raises unless every leaf lands on a parameter of the same
    shape and every parameter receives a leaf."""
    params = dict(module.named_parameters())
    seen = set()
    for path, leaf in _leaves(tree):
        *mods, leaf_name = path
        key = ".".join([*mods, _JAX_LEAF.get(leaf_name, leaf_name)])
        if key not in params:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {key} in the port's model")
        value = np.asarray(leaf, dtype=np.float32)
        value = torch.from_numpy(np.array(value.T if leaf_name == "kernel" else value))  # a writable copy
        if tuple(params[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: parameter {tuple(params[key].shape)} vs JAX leaf {tuple(value.shape)}")
        with torch.no_grad():
            params[key].copy_(value)
        seen.add(key)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"no JAX leaf for parameters {missing}")
