"""Table-rec model loading for the port (counterpart of
surya_tpu/table_rec/loader.py).

``load_table_rec_model`` reads the checkpoint that ``checkpoint`` (else
``TABLE_REC_MODEL_CHECKPOINT``) resolves to: config.json with the JAX
loader's defaults, which differ from layout's (depths (2, 2, 12, 2),
encoder_length 1024, a 6 x 512 decoder, no double residual flow), the
upstream torch tensors through ``convert_torch`` and the converted-weight
cache. When none resolves, random weights drawn from ``WEIGHT_SEED`` at the
JAX package's default widths (``tiny=True``: its tiny test config;
``config``: any other), only under ``ALLOW_RANDOM_WEIGHTS``. Given the JAX
table-rec pytree (``jax_params``), the model takes exactly its weights
(``from_jax_params``) and nothing is resolved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.checkpoint import checkpoint_dir, load_model
from surya_tpu_torch.common.weights import load_config_json
from surya_tpu_torch.models import adetr, donut_swin, table_rec_model
from surya_tpu_torch.models.table_rec_model import TableRecConfig, TableRecModel
from surya_tpu_torch.settings import model_dtype, resolve_device, settings

# surya_tpu/table_rec/loader.py's tiny config (one block a stage: no shifted window)
TINY_ENCODER = dict(image_size=(128, 128), embed_dim=16, depths=(1, 1), num_heads=(2, 4), num_kv_heads=(2, 4),
                    encoder_length=1024)
TINY_DECODER = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64, num_attention_heads=4,
                    num_key_value_heads=2, double_residual_flow=False, cross_attn_layers=(0, 1),
                    self_attn_layers=(0, 1))


def table_rec_config(tiny: bool = False) -> TableRecConfig:
    if not tiny:
        return TableRecConfig(max_boxes=settings.TABLE_REC_MAX_BOXES)
    enc = donut_swin.DonutSwinConfig(**TINY_ENCODER)
    dec = adetr.ADETRConfig(encoder_hidden_size=enc.hidden_size, **TINY_DECODER)
    return TableRecConfig(box_embed_size=24, property_embed_size=8, max_boxes=settings.TABLE_REC_MAX_BOXES,
                          encoder=enc, decoder=dec)


def from_jax_params(params: dict, config: TableRecConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> TableRecModel:
    """The port's model with the weights of a JAX table-rec pytree given as
    numpy leaves (``jax.tree.map(np.asarray, params)``)."""
    device = resolve_device(device)
    model = TableRecModel(config)
    pnn.load_jax_params(model, params)
    return model.to(device=device, dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def random_model(config: TableRecConfig, device=None, dtype: Optional[torch.dtype] = None,
                 seed: Optional[int] = None) -> TableRecModel:
    """Random weights from `seed` (default WEIGHT_SEED), drawn on the device
    as the JAX package draws its own (see layout.loader.random_model)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = TableRecModel(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(settings.WEIGHT_SEED if seed is None else seed)
    pnn.init_normal_(model, gen)
    donut_swin.zero_tables_(model.encoder)
    return model.to(dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def config_from_json(raw: dict) -> TableRecConfig:
    """A checkpoint's config.json with surya_tpu/table_rec/loader.py's defaults."""
    enc_raw = raw.get("encoder", {})
    dec_raw = raw.get("decoder", {})
    enc = donut_swin.DonutSwinConfig(
        image_size=tuple(enc_raw.get("image_size", (768, 768))),
        embed_dim=enc_raw.get("embed_dim", 128),
        depths=tuple(enc_raw.get("depths", (2, 2, 12, 2))),
        num_heads=tuple(enc_raw.get("num_heads", (4, 8, 16, 32))),
        num_kv_heads=tuple(enc_raw.get("num_kv_heads", (4, 8, 16, 32))),
        window_size=enc_raw.get("window_size", 8),
        encoder_length=enc_raw.get("encoder_length", 1024),
        use_positional_embeddings=enc_raw.get("use_positional_embeddings", True),
    )
    n_layers = dec_raw.get("num_hidden_layers", 6)
    dec = adetr.ADETRConfig(
        num_hidden_layers=n_layers,
        hidden_size=dec_raw.get("hidden_size", 512),
        intermediate_size=dec_raw.get("intermediate_size", 2048),
        encoder_hidden_size=dec_raw.get("encoder_hidden_size", 1024),
        num_attention_heads=dec_raw.get("num_attention_heads", 8),
        num_key_value_heads=dec_raw.get("num_key_value_heads", 4),
        rope_theta=dec_raw.get("rope_theta", 10000.0),
        double_residual_flow=False,
        cross_attn_layers=tuple(dec_raw.get("cross_attn_layers", range(n_layers))),
        self_attn_layers=tuple(dec_raw.get("self_attn_layers", range(n_layers))),
    )
    return TableRecConfig(
        property_embed_size=dec_raw.get("property_embed_size", 64),
        box_embed_size=dec_raw.get("box_embed_size", 448),
        max_boxes=settings.TABLE_REC_MAX_BOXES,
        encoder=enc,
        decoder=dec,
    )


def load_table_rec_model(checkpoint: Optional[str] = None, tiny: bool = False, device=None,
                         jax_params: Optional[dict] = None, config: Optional[TableRecConfig] = None,
                         dtype: Optional[torch.dtype] = None) -> Tuple[TableRecModel, TableRecConfig]:
    if jax_params is not None:
        config = config or table_rec_config(tiny)
        return from_jax_params(jax_params, config, device, dtype), config
    device = resolve_device(device)
    ckpt_dir = checkpoint_dir(checkpoint or settings.TABLE_REC_MODEL_CHECKPOINT, "table_rec")
    if ckpt_dir is not None:
        config = config_from_json(load_config_json(ckpt_dir))
        model = load_model(ckpt_dir, "table_rec", lambda: TableRecModel(config),
                           lambda t: table_rec_model.convert_torch(t, config), device, dtype or model_dtype(device))
        return model, config
    config = config or table_rec_config(tiny)
    return random_model(config, device, dtype), config
