"""OCR error detection of the PyTorch port: a DistilBERT classifier that
labels each text "good" or "bad" (counterpart of surya_tpu/ocr_error).

Texts are WordPiece-encoded on the host; each batch is padded to the
smallest of SEQ_BUCKETS that holds its longest text and its rows to the
next power of two up to the batch size (the last row repeated), so that a
partial last batch does not pay for a full one; only the real rows' labels
are kept. One batch stays in flight: batch k's logits are fetched only
after batch k + 1 is enqueued (pinned uploads, an event wait). On CUDA the
predictor runs on a stream of its own.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from tqdm import tqdm

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.checkpoint import checkpoint_dir, load_model
from surya_tpu_torch.common.predictor import BasePredictor
from surya_tpu_torch.common.weights import load_config_json
from surya_tpu_torch.models import distilbert
from surya_tpu_torch.models.distilbert import ID2LABEL, DistilBert, DistilBertConfig
from surya_tpu_torch.ocr_error.schema import OCRErrorDetectionResult
from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer
from surya_tpu_torch.settings import model_dtype, resolve_device, settings

SEQ_BUCKETS = (64, 128, 256, 512)
# surya_tpu/ocr_error/__init__.py's tiny config
TINY = dict(n_layers=2, n_heads=4, dim=64, hidden_dim=128)


def ocr_error_config(tiny: bool = False) -> DistilBertConfig:
    return DistilBertConfig(**TINY) if tiny else DistilBertConfig()


def from_jax_params(params: dict, config: DistilBertConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> DistilBert:
    """The port's model with the weights of a JAX DistilBERT pytree given as
    numpy leaves (``jax.tree.map(np.asarray, params)``)."""
    device = resolve_device(device)
    model = DistilBert(config)
    pnn.load_jax_params(model, params)
    return model.to(device=device, dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def random_model(config: DistilBertConfig, device=None, dtype: Optional[torch.dtype] = None,
                 seed: Optional[int] = None) -> DistilBert:
    """Random weights from `seed` (default WEIGHT_SEED), drawn on the device:
    linear weights and embeddings ~ N(0, 0.02^2), biases 0, norms identity."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = DistilBert(config)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(settings.WEIGHT_SEED if seed is None else seed)
    pnn.init_normal_(model, gen)
    return model.to(dtype=dtype or model_dtype(device)).eval().requires_grad_(False)


def config_from_json(raw: dict) -> DistilBertConfig:
    """A checkpoint's config.json with surya_tpu/ocr_error's defaults."""
    return DistilBertConfig(
        vocab_size=raw.get("vocab_size", 30522),
        max_position_embeddings=raw.get("max_position_embeddings", 512),
        n_layers=raw.get("n_layers", 6),
        n_heads=raw.get("n_heads", 12),
        dim=raw.get("dim", 768),
        hidden_dim=raw.get("hidden_dim", 3072),
    )


def load_ocr_error_model(checkpoint: Optional[str] = None, tiny: bool = False, device=None,
                         jax_params: Optional[dict] = None) -> Tuple[DistilBert, DistilBertConfig, WordPieceTokenizer]:
    """(model, config, tokenizer): the checkpoint that ``checkpoint`` (else
    OCR_ERROR_MODEL_CHECKPOINT) resolves to, with its WordPiece vocabulary;
    else full width (6 layers, 768 wide, 12 heads) or the tiny test config,
    with the weights of `jax_params` (nothing resolved) or random ones
    (ALLOW_RANDOM_WEIGHTS) and the tokenizer's hash vocabulary."""
    if jax_params is not None:
        config = ocr_error_config(tiny)
        return from_jax_params(jax_params, config, device), config, WordPieceTokenizer()
    device = resolve_device(device)
    ckpt_dir = checkpoint_dir(checkpoint or settings.OCR_ERROR_MODEL_CHECKPOINT, "ocr_error")
    if ckpt_dir is not None:
        config = config_from_json(load_config_json(ckpt_dir))
        model = load_model(ckpt_dir, "ocr_error", lambda: DistilBert(config),
                           lambda t: distilbert.convert_torch(t, config), device, model_dtype(device))
        return model, config, WordPieceTokenizer.from_pretrained(ckpt_dir)
    config = ocr_error_config(tiny)
    return random_model(config, device), config, WordPieceTokenizer()


def row_bucket(current: int, batch_size: int) -> int:
    """Rows a batch of `current` texts runs at: the next power of two, at
    most the batch size."""
    return min(1 << max(current - 1, 0).bit_length(), batch_size)


class OCRErrorPredictor(BasePredictor):
    batch_size_setting = "OCR_ERROR_BATCH_SIZE"
    default_batch_sizes = {"cpu": 8, "cuda": 64}

    def __init__(self, checkpoint: Optional[str] = None, tiny: bool = False, *, device=None,
                 jax_params: Optional[dict] = None):
        """checkpoint: a local directory or ``s3://`` name (default
        OCR_ERROR_MODEL_CHECKPOINT); tiny: the small test configuration of
        random weights; jax_params: the JAX DistilBERT pytree as numpy
        leaves, whose weights the model takes (no checkpoint is resolved)."""
        self._tiny = tiny
        self._jax_params = jax_params
        super().__init__(checkpoint, device)

    def _load(self):
        self.model, self.config, self.processor = load_ocr_error_model(self.checkpoint, self._tiny, self.device,
                                                                       self._jax_params)
        self._jax_params = None
        self.last_run: dict = {}  # the last call's batches: (rows, sequence bucket) of each

    def __call__(self, texts: List[str], batch_size: Optional[int] = None) -> OCRErrorDetectionResult:
        return self.batch_ocr_error_detection(texts, batch_size)

    def batch_ocr_error_detection(self, texts: List[str], batch_size: Optional[int] = None
                                  ) -> OCRErrorDetectionResult:
        if batch_size is None:
            batch_size = self.get_batch_size()
        run = self.last_run = {"batches": []}
        predictions: List[int] = []
        inflight = None
        for lo in tqdm(range(0, len(texts), batch_size), total=math.ceil(len(texts) / batch_size),
                       desc="Running OCR Error Detection", disable=self.disable_tqdm):
            encoded = self.processor(texts[lo:lo + batch_size], max_length=self.config.max_position_embeddings)
            ids = np.asarray(encoded["input_ids"], np.int32)
            mask = np.asarray(encoded["attention_mask"], np.int32)
            current = ids.shape[0]
            L = next(b for b in SEQ_BUCKETS if b >= ids.shape[1])
            rows = row_bucket(current, batch_size)
            ids = np.pad(ids, ((0, 0), (0, L - ids.shape[1])))
            mask = np.pad(mask, ((0, 0), (0, L - mask.shape[1])))
            ids, mask = (np.pad(a, ((0, rows - current), (0, 0)), mode="edge") for a in (ids, mask))
            run["batches"].append((rows, L))
            with self._on_stream(), torch.inference_mode():
                handle = self._fetch(self.model(self._upload(ids), self._upload(mask)))
            # fetch the previous batch only now that this one is enqueued
            if inflight is not None:
                predictions.extend(self._finish(*inflight))
            inflight = (handle, current)
        if inflight is not None:
            predictions.extend(self._finish(*inflight))
        return OCRErrorDetectionResult(texts=texts, labels=[ID2LABEL[p] for p in predictions])

    def _finish(self, handle, current: int) -> List[int]:
        [logits] = self._wait(handle)
        return logits.argmax(axis=1)[:current].tolist()
