"""Layout model construction for the port.

``load_layout_model`` builds the layout model at the JAX package's default
widths (``tiny=True``: the JAX package's tiny test config; ``config``: any
other) with random weights drawn from ``WEIGHT_SEED``, or, given the JAX
layout pytree, with exactly its weights (``from_jax_params``). Loading a
real checkpoint is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models import adetr, donut_swin
from surya_tpu_torch.models.layout_model import LayoutConfig, LayoutModel
from surya_tpu_torch.settings import model_dtype, resolve_device, settings

# surya_tpu/layout/loader.py's tiny config (one block a stage: no shifted window)
TINY_ENCODER = dict(image_size=(128, 128), embed_dim=16, depths=(1, 1), num_heads=(2, 4), num_kv_heads=(2, 4),
                    encoder_length=1024)
TINY_DECODER = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64, num_attention_heads=4,
                    num_key_value_heads=2, cross_attn_layers=(0, 1), self_attn_layers=(0, 1))


def layout_config(tiny: bool = False) -> LayoutConfig:
    if not tiny:
        return LayoutConfig(max_boxes=settings.LAYOUT_MAX_BOXES)
    enc = donut_swin.DonutSwinConfig(**TINY_ENCODER)
    dec = adetr.ADETRConfig(encoder_hidden_size=enc.hidden_size, **TINY_DECODER)
    return LayoutConfig(max_boxes=settings.LAYOUT_MAX_BOXES, encoder=enc, decoder=dec)


def from_jax_params(params: dict, config: LayoutConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> LayoutModel:
    """The port's model with the weights of a JAX layout pytree given as
    numpy leaves (``jax.tree.map(np.asarray, params)``)."""
    device = resolve_device(device)
    model = LayoutModel(config)
    pnn.load_jax_params(model, params)
    return model.to(device=device, dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def random_model(config: LayoutConfig, device=None, dtype: Optional[torch.dtype] = None,
                 seed: Optional[int] = None) -> LayoutModel:
    """Random weights from `seed` (default WEIGHT_SEED), drawn on the device
    as the JAX package draws its own: linear and conv weights and embeddings
    ~ N(0, 0.02^2), biases 0, norms identity, the Swin position tables 0."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = LayoutModel(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(settings.WEIGHT_SEED if seed is None else seed)
    pnn.init_normal_(model, gen)
    donut_swin.zero_tables_(model.encoder)
    return model.to(dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def load_layout_model(tiny: bool = False, device=None, jax_params: Optional[dict] = None,
                      config: Optional[LayoutConfig] = None,
                      dtype: Optional[torch.dtype] = None) -> Tuple[LayoutModel, LayoutConfig]:
    config = config or layout_config(tiny)
    if jax_params is not None:
        return from_jax_params(jax_params, config, device, dtype), config
    if not settings.ALLOW_RANDOM_WEIGHTS:
        raise FileNotFoundError(
            "the PyTorch port has no checkpoint loading yet; set ALLOW_RANDOM_WEIGHTS=true "
            "for random weights (tests and benchmarks only)"
        )
    return random_model(config, device, dtype), config
