"""Detection model loading for the port (counterpart of
surya_tpu/detection/loader.py).

``load_detection_model`` reads the checkpoint that ``checkpoint`` (else
``DETECTOR_MODEL_CHECKPOINT``) resolves to: config.json with the JAX
loader's defaults, the upstream torch tensors through ``convert_torch`` and
the converted-weight cache. When none resolves, random weights drawn from
``WEIGHT_SEED`` at the JAX package's default widths (``tiny=True``: its tiny
test config, same stages, strides and processor size), only under
``ALLOW_RANDOM_WEIGHTS``. Given the JAX detection pytree (``jax_params``),
the model takes exactly its weights (``from_jax_params``) and nothing is
resolved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.checkpoint import checkpoint_dir, load_model
from surya_tpu_torch.common.weights import load_config_json
from surya_tpu_torch.models import efficientvit
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


def config_from_json(raw: dict) -> EfficientViTConfig:
    """A checkpoint's config.json with surya_tpu/detection/loader.py's defaults."""
    size_cfg = raw.get("image_size") or {}
    return EfficientViTConfig(
        num_classes=raw.get("num_classes", 2),
        widths=tuple(raw.get("widths", (32, 64, 128, 256, 512))),
        head_dim=raw.get("head_dim", 32),
        depths=tuple(raw.get("depths", (1, 1, 1, 6, 6))),
        strides=tuple(raw.get("strides", (2, 2, 2, 2, 2))),
        layer_norm_eps=raw.get("layer_norm_eps", 1e-6),
        decoder_layer_hidden_size=raw.get("decoder_layer_hidden_size", 128),
        decoder_hidden_size=raw.get("decoder_hidden_size", 512),
        image_size=(size_cfg.get("height", 896), size_cfg.get("width", 896)),
    )


def load_detection_model(checkpoint: Optional[str] = None, tiny: bool = False, device=None,
                         jax_params: Optional[dict] = None) -> Tuple[EfficientViT, EfficientViTConfig]:
    if jax_params is not None:
        config = detection_config(tiny)
        return from_jax_params(jax_params, config, device), config
    device = resolve_device(device)
    ckpt_dir = checkpoint_dir(checkpoint or settings.DETECTOR_MODEL_CHECKPOINT, "detection")
    if ckpt_dir is not None:
        config = config_from_json(load_config_json(ckpt_dir))
        model = load_model(ckpt_dir, "detection", lambda: EfficientViT(config),
                           lambda t: efficientvit.convert_torch(t, config), device, model_dtype(device))
        return model, config
    config = detection_config(tiny)
    return random_model(config, device), config
