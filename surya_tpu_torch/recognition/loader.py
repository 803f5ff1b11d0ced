"""Recognition model construction for the port.

``load_recognition_model`` builds the foundation model at the JAX package's
default production widths (``tiny=True``: the JAX package's tiny test
config) with random weights drawn from ``WEIGHT_SEED``, or, given the JAX
foundation pytree, with exactly its weights (``from_jax_params``). Loading a
real checkpoint is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models import qwen_decoder, qwen_encoder
from surya_tpu_torch.models.foundation import FoundationConfig, FoundationModel
from surya_tpu_torch.recognition.processor import RecognitionProcessor
from surya_tpu_torch.recognition.tokenizer import ByteFallbackMathTokenizer, OCRTokenizer
from surya_tpu_torch.settings import model_dtype, resolve_device, settings

# the JAX package's random-init production widths (surya_tpu/recognition/loader.py)
DEFAULT_DECODER = dict(
    hidden_size=1536, intermediate_size=4096, num_hidden_layers=10,
    num_attention_heads=12, num_key_value_heads=4, rope_theta=10000.0,
)
DEFAULT_ENCODER = dict(
    depth=8, hidden_size=1280, intermediate_size=3420, num_heads=16,
    window_size=112, out_hidden_size=1536, fullatt_block_indexes=(3, 7),
)
TINY_ENCODER = dict(
    depth=2, hidden_size=64, intermediate_size=128, num_heads=4,
    window_size=56, out_hidden_size=96, fullatt_block_indexes=(1,),
)
TINY_DECODER = dict(hidden_size=96, intermediate_size=192, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2)


def recognition_config(tokenizer: OCRTokenizer, tiny: bool = False) -> FoundationConfig:
    enc = qwen_encoder.EncoderConfig(**(TINY_ENCODER if tiny else DEFAULT_ENCODER))
    dec = qwen_decoder.DecoderConfig(
        vocab_size=tokenizer.vocab_size, **(TINY_DECODER if tiny else DEFAULT_DECODER)
    )
    st = tokenizer.system_tokens
    return FoundationConfig(
        vocab_size=tokenizer.vocab_size,
        eos_token_id=st["</S>"],
        pad_token_id=st["<PAD>"],
        encoder=enc,
        decoder=dec,
    )


def from_jax_params(params: dict, config: FoundationConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> FoundationModel:
    """The port's model with the weights of a JAX foundation pytree given as
    numpy leaves (``jax.tree.map(np.asarray, params)``); every leaf of
    surya_tpu.models.foundation.init_params is carried over."""
    device = resolve_device(device)
    model = FoundationModel(config)
    pnn.load_jax_params(model, params)
    return model.to(device=device, dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def random_model(config: FoundationConfig, device=None, dtype: Optional[torch.dtype] = None,
                 seed: Optional[int] = None) -> FoundationModel:
    """Random weights from `seed` (default WEIGHT_SEED), drawn on the device:
    linear weights and embeddings ~ N(0, 0.02^2), biases 0, norm scales 1."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = FoundationModel(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(settings.WEIGHT_SEED if seed is None else seed)
    pnn.init_normal_(model, gen)
    with torch.no_grad():
        model.lm_head_bias.zero_()
    return model.to(dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def load_recognition_model(
    tiny: bool = False, device=None, jax_params: Optional[dict] = None,
) -> Tuple[FoundationModel, FoundationConfig, RecognitionProcessor]:
    tokenizer = OCRTokenizer(math_tokenizer=ByteFallbackMathTokenizer())
    config = recognition_config(tokenizer, tiny=tiny)
    if jax_params is not None:
        model = from_jax_params(jax_params, config, device)
    else:
        if not settings.ALLOW_RANDOM_WEIGHTS:
            raise FileNotFoundError(
                "the PyTorch port has no checkpoint loading yet; set ALLOW_RANDOM_WEIGHTS=true "
                "for random weights (tests and benchmarks only)"
            )
        model = random_model(config, device)
    processor = RecognitionProcessor(
        tokenizer,
        patch_size=config.encoder.patch_size,
        merge_size=config.encoder.spatial_merge_size,
        num_register_tokens=config.num_register_tokens,
    )
    return model, config, processor
