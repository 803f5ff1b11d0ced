"""Detection model construction for the port.

``load_detection_model`` builds the EfficientViT at the JAX package's default
widths (``tiny=True``: the JAX package's tiny test config, same stages,
strides and processor size) with random weights drawn from ``WEIGHT_SEED``,
or, given the JAX detection pytree, with exactly its weights
(``from_jax_params``). Loading a real checkpoint is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models.efficientvit import EfficientViT, EfficientViTConfig
from surya_tpu_torch.settings import model_dtype, resolve_device, settings

# surya_tpu/detection/loader.py's tiny config
TINY_DETECTOR = dict(
    widths=(8, 8, 16, 16, 32), depths=(1, 1, 1, 1, 1),
    head_dim=8, decoder_layer_hidden_size=16, decoder_hidden_size=32,
)


def detection_config(tiny: bool = False) -> EfficientViTConfig:
    return EfficientViTConfig(**TINY_DETECTOR) if tiny else EfficientViTConfig()


def from_jax_params(params: dict, config: EfficientViTConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> EfficientViT:
    """The port's model with the weights of a JAX detection pytree given as
    numpy leaves (``jax.tree.map(np.asarray, params)``): HWIO conv kernels
    become OIHW, linear kernels are transposed, every leaf is carried over."""
    device = resolve_device(device)
    model = EfficientViT(config)
    pnn.load_jax_params(model, params)
    return model.to(device=device, dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def random_model(config: EfficientViTConfig, device=None, dtype: Optional[torch.dtype] = None,
                 seed: Optional[int] = None) -> EfficientViT:
    """Random weights from `seed` (default WEIGHT_SEED), drawn on the device:
    conv and linear weights ~ N(0, 0.02^2), biases 0, folded norms identity."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = EfficientViT(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(settings.WEIGHT_SEED if seed is None else seed)
    pnn.init_normal_(model, gen)
    return model.to(dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def load_detection_model(tiny: bool = False, device=None,
                         jax_params: Optional[dict] = None) -> Tuple[EfficientViT, EfficientViTConfig]:
    config = detection_config(tiny)
    if jax_params is not None:
        return from_jax_params(jax_params, config, device), config
    if not settings.ALLOW_RANDOM_WEIGHTS:
        raise FileNotFoundError(
            "the PyTorch port has no checkpoint loading yet; set ALLOW_RANDOM_WEIGHTS=true "
            "for random weights (tests and benchmarks only)"
        )
    return random_model(config, device), config
