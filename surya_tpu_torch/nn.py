"""Layers shared by the port's models (counterpart of surya_tpu/nn).

Linear layers are ``torch.nn.Linear`` and convolutions ``torch.nn.Conv2d``
on NCHW tensors. The port's modules carry the names of the JAX package's
parameter pytrees, so ``load_jax_params`` carries JAX weights over by path
(JAX linear kernels are [in, out] and are transposed; JAX conv kernels are
HWIO and become OIHW). RMSNorm keeps the fp32 island of the JAX version;
inference batch-norm is folded into a per-channel scale and bias, as there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
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


class FoldedBatchNorm(nn.Module):
    """Inference batch-norm folded to a per-channel scale (``weight``) and
    bias, over the channels of an NCHW tensor (surya_tpu nn.bn_fold)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return x * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def torch_conv_padding(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """The symmetric padding of torch Conv2d(padding=((s-1)+d*(k-1))//2),
    which surya_tpu's nn.torch_conv_padding spells out for JAX."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def bilinear_resize(x, out_hw: Tuple[int, int]):
    """NCHW bilinear resize with align_corners=False. surya_tpu's
    bilinear_resize is jax.image.resize(..., "bilinear"); the detection head
    only ever upsamples with it, and there it equals F.interpolate without
    antialiasing (half-pixel centres; at the border jax renormalises the
    weights over the in-range pixels, which is torch's clamp to the edge)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False)


def init_normal_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Random init mirroring the JAX package's initializers: every Linear and
    Conv2d weight and Embedding table ~ N(0, std^2), biases 0, norm scales 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, FoldedBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


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
    to ``blocks.0.attn.qkv.weight``, transposed, since JAX linear kernels
    are [in, out]; a 4-D (HWIO) conv kernel becomes OIHW. Raises unless every
    leaf lands on a parameter of the same shape and every parameter receives
    a leaf."""
    params = dict(module.named_parameters())
    seen = set()
    for path, leaf in _leaves(tree):
        *mods, leaf_name = path
        key = ".".join([*mods, _JAX_LEAF.get(leaf_name, leaf_name)])
        if key not in params:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {key} in the port's model")
        value = np.asarray(leaf, dtype=np.float32)
        if leaf_name == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        value = torch.from_numpy(np.array(value))  # a writable copy
        if tuple(params[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: parameter {tuple(params[key].shape)} vs JAX leaf {tuple(value.shape)}")
        with torch.no_grad():
            params[key].copy_(value)
        seen.add(key)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"no JAX leaf for parameters {missing}")
