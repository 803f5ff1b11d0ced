"""Layout model loading for the port (counterpart of
surya_tpu/layout/loader.py).

``load_layout_model`` reads the checkpoint that ``checkpoint`` (else
``LAYOUT_MODEL_CHECKPOINT``) resolves to: config.json with the JAX loader's
defaults (``config_from_json``), the upstream torch tensors through
``convert_torch`` and the converted-weight cache. When none resolves,
random weights drawn from ``WEIGHT_SEED`` at the JAX package's default
widths (``tiny=True``: its tiny test config; ``config``: any other), only
under ``ALLOW_RANDOM_WEIGHTS``. Given the JAX layout pytree
(``jax_params``), the model takes exactly its weights (``from_jax_params``)
and nothing is resolved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.checkpoint import checkpoint_dir, load_model
from surya_tpu_torch.common.weights import load_config_json
from surya_tpu_torch.models import adetr, donut_swin, layout_model
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


def config_from_json(raw: dict) -> LayoutConfig:
    """A checkpoint's config.json with surya_tpu/layout/loader.py's defaults
    (its ``_configs_from_json``)."""
    enc_raw = raw.get("encoder", {})
    dec_raw = raw.get("decoder", {})
    enc = donut_swin.DonutSwinConfig(
        image_size=tuple(enc_raw.get("image_size", (768, 768))),
        patch_size=enc_raw.get("patch_size", 4),
        embed_dim=enc_raw.get("embed_dim", 128),
        depths=tuple(enc_raw.get("depths", (2, 2, 16, 2))),
        num_heads=tuple(enc_raw.get("num_heads", (4, 8, 16, 32))),
        num_kv_heads=tuple(enc_raw.get("num_kv_heads", (4, 8, 16, 32))),
        window_size=enc_raw.get("window_size", 8),
        encoder_length=enc_raw.get("encoder_length", 768),
        use_positional_embeddings=enc_raw.get("use_positional_embeddings", True),
    )
    n_layers = dec_raw.get("num_hidden_layers", 8)
    dec = adetr.ADETRConfig(
        num_hidden_layers=n_layers,
        hidden_size=dec_raw.get("hidden_size", 1024),
        intermediate_size=dec_raw.get("intermediate_size", 4096),
        encoder_hidden_size=dec_raw.get("encoder_hidden_size", 1024),
        num_attention_heads=dec_raw.get("num_attention_heads", 16),
        num_key_value_heads=dec_raw.get("num_key_value_heads", 4),
        rope_theta=dec_raw.get("rope_theta", 10000.0),
        rms_norm_eps=dec_raw.get("rms_norm_eps", 1e-6),
        cross_attn_layers=tuple(dec_raw.get("cross_attn_layers", range(n_layers))),
        self_attn_layers=tuple(dec_raw.get("self_attn_layers", range(n_layers))),
    )
    return LayoutConfig(
        vocab_size=dec_raw.get("vocab_size", 1025),
        bbox_size=dec_raw.get("bbox_size", 1024),
        skew_scaler=dec_raw.get("skew_scaler", 512),
        label_count=dec_raw.get("label_count", LayoutConfig.label_count),
        max_boxes=settings.LAYOUT_MAX_BOXES,
        encoder=enc,
        decoder=dec,
    )


def load_layout_model(checkpoint: Optional[str] = None, tiny: bool = False, device=None,
                      jax_params: Optional[dict] = None, config: Optional[LayoutConfig] = None,
                      dtype: Optional[torch.dtype] = None) -> Tuple[LayoutModel, LayoutConfig]:
    if jax_params is not None:
        config = config or layout_config(tiny)
        return from_jax_params(jax_params, config, device, dtype), config
    device = resolve_device(device)
    ckpt_dir = checkpoint_dir(checkpoint or settings.LAYOUT_MODEL_CHECKPOINT, "layout")
    if ckpt_dir is not None:
        config = config_from_json(load_config_json(ckpt_dir))
        model = load_model(ckpt_dir, "layout", lambda: LayoutModel(config),
                           lambda t: layout_model.convert_torch(t, config), device, dtype or model_dtype(device))
        return model, config
    config = config or layout_config(tiny)
    return random_model(config, device, dtype), config
