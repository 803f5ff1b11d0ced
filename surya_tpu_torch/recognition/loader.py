"""Recognition model loading for the port (counterpart of
surya_tpu/recognition/loader.py).

``load_recognition_model`` reads the checkpoint that ``checkpoint`` (else
``RECOGNITION_MODEL_CHECKPOINT``) resolves to: the configs from config.json
with the JAX loader's defaults, the OCR tokenizer from its Qwen2 tokenizer
files and ``special_ocr_tokens``, and the upstream torch tensors through
``convert_torch`` and the converted-weight cache. When none resolves,
random weights drawn from ``WEIGHT_SEED`` at the JAX package's default
production widths (``tiny=True``: its tiny test config) with the byte-level
math tokenizer, only under ``ALLOW_RANDOM_WEIGHTS``. Given the JAX
foundation pytree (``jax_params``), the model takes exactly its weights
(``from_jax_params``) and nothing is resolved.

With ``RECOGNITION_WEIGHT_QUANTIZE`` the decoder's projections are int8
(``qwen_decoder.quantize_weights``), quantized after the cast to the model
dtype as the JAX loader quantizes its params at MODEL_DTYPE (a checkpoint's
after the load and the cache); a JAX pytree that holds ``kernel_q`` leaves
(quantized by the JAX loader) is carried over as it is, whatever the
setting.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.checkpoint import checkpoint_dir, load_model
from surya_tpu_torch.common.weights import load_config_json
from surya_tpu_torch.models import foundation, lfm2_decoder, qwen_decoder, qwen_encoder
from surya_tpu_torch.models.foundation import FoundationConfig, FoundationModel
from surya_tpu_torch.recognition.processor import RecognitionProcessor
from surya_tpu_torch.recognition.tokenizer import ByteFallbackMathTokenizer, OCRTokenizer, QwenMathTokenizer
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
        image_token_id=st["<IMAGE>"],
        encoder=enc,
        decoder=dec,
    )


def decoder_config(raw: dict, vocab_size: int):
    """The decoder's config from config.json's "decoder" entry, by its
    ``model_type``: "qwen2" (the default) with surya_tpu/recognition/
    loader.py's defaults, or "lfm2_moe" with LFM2-8B-A1B's
    (lfm2_decoder.Lfm2Config), each of its keys taken as the entry gives
    it; keys that set no width or setting of the decoder (a language
    model's own vocab_size, max_position_embeddings, ...) are not read."""
    model_type = raw.get("model_type", "qwen2")
    if model_type == lfm2_decoder.MODEL_TYPE:
        fields = set(lfm2_decoder.Lfm2Config.__dataclass_fields__) - {"vocab_size"}
        kw = {k: tuple(v) if k == "layer_types" else v for k, v in raw.items() if k in fields}
        return lfm2_decoder.Lfm2Config(vocab_size=vocab_size, **kw)
    if model_type != "qwen2":
        raise ValueError(f"no decoder of model_type {model_type!r}; known: 'qwen2', {lfm2_decoder.MODEL_TYPE!r}")
    return qwen_decoder.DecoderConfig(
        vocab_size=vocab_size,
        hidden_size=raw.get("hidden_size", 1536),
        intermediate_size=raw.get("intermediate_size", 4096),
        num_hidden_layers=raw.get("num_hidden_layers", 10),
        num_attention_heads=raw.get("num_attention_heads", 12),
        num_key_value_heads=raw.get("num_key_value_heads", 4),
        rope_theta=raw.get("rope_theta", 10000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
    )


def config_from_json(raw: dict) -> FoundationConfig:
    """A checkpoint's config.json with surya_tpu/recognition/loader.py's
    defaults; the decoder by ``decoder.model_type`` (decoder_config)."""
    enc_raw = raw.get("vision_encoder", {})
    enc = qwen_encoder.EncoderConfig(
        depth=enc_raw.get("depth", 8),
        hidden_size=enc_raw.get("hidden_size", 1280),
        intermediate_size=enc_raw.get("intermediate_size", 3420),
        num_heads=enc_raw.get("num_heads", 16),
        patch_size=enc_raw.get("patch_size", 14),
        spatial_merge_size=enc_raw.get("spatial_merge_size", 2),
        temporal_patch_size=enc_raw.get("temporal_patch_size", 1),
        window_size=enc_raw.get("window_size", 112),
        out_hidden_size=enc_raw.get("out_hidden_size", 1280),
        fullatt_block_indexes=tuple(enc_raw.get("fullatt_block_indexes", (3, 7))),
    )
    dec = decoder_config(raw.get("decoder", {}), raw["vocab_size"])
    return FoundationConfig(
        vocab_size=raw["vocab_size"],
        bbox_size=raw.get("bbox_size", 1025),
        bos_token_id=raw.get("bos_token_id", 0),
        eos_token_id=raw.get("eos_token_id", 1),
        pad_token_id=raw.get("pad_token_id", 2),
        image_token_id=raw.get("image_token_id", 3),
        max_sequence_length=raw.get("max_sequence_length", 1536),
        num_register_tokens=raw.get("num_register_tokens", 4),
        image_embed_encoding_size=raw.get("image_embed_encoding_size", 1024),
        image_embed_encoding_multiplier=raw.get("image_embed_encoding_multiplier", 256),
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
    quantized = "kernel_q" in params["decoder"]["layers"][0]["self_attn"]["q_proj"]
    if quantized:
        qwen_decoder.quantize_weights(model.decoder)  # the leaves fill the int8 buffers
    pnn.load_jax_params(model, params)
    model = model.to(device=device, dtype=dtype or model_dtype(device))
    if settings.RECOGNITION_WEIGHT_QUANTIZE and not quantized:
        qwen_decoder.quantize_weights(model.decoder)
    return model.eval().requires_grad_(False)


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
    if isinstance(model.decoder, lfm2_decoder.Lfm2Decoder):
        model.decoder.init_extra_(gen)
    model = model.to(dtype=dtype or model_dtype(device))
    _quantize(model)
    return model.eval().requires_grad_(False)


def _quantize(model: FoundationModel) -> None:
    """int8 decoder projections under RECOGNITION_WEIGHT_QUANTIZE (the
    Qwen2-style decoder only: the lfm2_moe decoder raises)."""
    if not settings.RECOGNITION_WEIGHT_QUANTIZE:
        return
    if isinstance(model.decoder, lfm2_decoder.Lfm2Decoder):
        lfm2_decoder.check_supported(quantize_weights=True)
    qwen_decoder.quantize_weights(model.decoder)


def load_recognition_model(
    checkpoint: Optional[str] = None, tiny: bool = False, device=None, jax_params: Optional[dict] = None,
    config: Optional[dict] = None,
) -> Tuple[FoundationModel, FoundationConfig, RecognitionProcessor]:
    """(model, config, processor) of the checkpoint that resolves; where none
    does, random weights at `config` (a config.json as a dict, read by
    config_from_json, its vocabulary the byte-level tokenizer's) or else at
    the default widths (tiny: the test widths)."""
    ckpt_dir = None
    if jax_params is None:
        device = resolve_device(device)
        ckpt_dir = checkpoint_dir(checkpoint or settings.RECOGNITION_MODEL_CHECKPOINT, "recognition")
    if ckpt_dir is not None:
        raw = load_config_json(ckpt_dir)
        config = config_from_json(raw)
        tokenizer = OCRTokenizer(special_tokens=raw.get("special_ocr_tokens"),
                                 math_tokenizer=QwenMathTokenizer(ckpt_dir))
        model = load_model(ckpt_dir, "recognition", lambda: FoundationModel(config),
                           lambda t: foundation.convert_torch(t, config), device, model_dtype(device))
        _quantize(model)
    else:
        tokenizer = OCRTokenizer(math_tokenizer=ByteFallbackMathTokenizer())
        if config is not None:
            config = config_from_json(config)
            if config.vocab_size != tokenizer.vocab_size:
                raise ValueError(f"config vocab_size {config.vocab_size} is not the tokenizer's "
                                 f"{tokenizer.vocab_size}")
        else:
            config = recognition_config(tokenizer, tiny=tiny)
        if jax_params is not None:
            model = from_jax_params(jax_params, config, device)
        else:
            model = random_model(config, device)
    processor = RecognitionProcessor(
        tokenizer,
        patch_size=config.encoder.patch_size,
        merge_size=config.encoder.spatial_merge_size,
        num_register_tokens=config.num_register_tokens,
    )
    return model, config, processor
