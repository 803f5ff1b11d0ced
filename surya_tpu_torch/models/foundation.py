"""The recognition foundation model: vision encoder + decoder + dual heads.

Counterpart of surya_tpu/models/foundation.py. ``prefill`` encodes the
images, scatters them into the prompt's <IMAGE> positions, runs the decoder
prefill, writes the KV into the slot cache and samples token 0.
``decode_chunk`` runs ``num_steps`` greedy steps on the device: a Python loop
with no host synchronisation inside (nor in ``prefill``: no copy from the
host, no read of a device value), over a read-only cache plus a chunk
buffer that is committed once at the end. Where the JAX loop exits early once
no slot is active, the port runs every step; a slot that is no longer active
emits pad and does not advance, so the outputs are the same.

The lm head shares the token embedding matrix (plus ``lm_head_bias``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from surya_tpu_torch.models import qwen_decoder, qwen_encoder


@dataclass(frozen=True)
class FoundationConfig:
    vocab_size: int = 65536
    bbox_size: int = 1025
    eos_token_id: int = 1
    pad_token_id: int = 2
    max_sequence_length: int = 1536
    num_register_tokens: int = 4
    image_embed_encoding_size: int = 1024
    encoder: qwen_encoder.EncoderConfig = field(default_factory=qwen_encoder.EncoderConfig)
    decoder: qwen_decoder.DecoderConfig = field(default_factory=qwen_decoder.DecoderConfig)

    @property
    def hidden_size(self) -> int:
        return self.decoder.hidden_size


class FoundationModel(nn.Module):
    """Submodule names follow surya_tpu foundation.init_params' pytree."""

    def __init__(self, config: FoundationConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.vision_encoder = qwen_encoder.VisionEncoder(config.encoder)
        self.decoder = qwen_decoder.Decoder(config.decoder)
        self.token_embed = nn.Embedding(config.vocab_size, h)
        self.img_w_embed = nn.Embedding(config.image_embed_encoding_size, h)
        self.img_h_embed = nn.Embedding(config.image_embed_encoding_size, h)
        self.bbox_head = nn.Linear(h, 6)
        self.lm_head_bias = nn.Parameter(torch.zeros(config.vocab_size))

    # -- pieces ----------------------------------------------------------------

    def sample_greedy(self, hidden):
        """Greedy token, its softmax probability and the int bbox, from
        last-token hidden states [B, h]."""
        logits = (hidden @ self.token_embed.weight.T + self.lm_head_bias).float()
        token = logits.argmax(-1).to(torch.int32)
        score = torch.softmax(logits, dim=-1).amax(-1)
        bbox = torch.sigmoid(self.bbox_head(hidden).float())
        return token, score, (bbox * self.config.bbox_size).to(torch.int32)

    def embed_prompt_tokens(self, input_ids, img_gather, image_tokens):
        """Token embeddings with image tokens put at the <IMAGE> positions.
        img_gather: [B, L] row of image_tokens per position, -1 for text."""
        tok = self.token_embed(input_ids.long())
        img = image_tokens[img_gather.long().clamp(min=0)]
        return torch.where((img_gather >= 0)[..., None], img.to(tok.dtype), tok)

    def encode_images(self, patches, enc_args, llm_h_idx, llm_w_idx, kv_range: int, win_range: int,
                      use_kernels: bool = True):
        """Vision encoder + 2-D learned position embeddings -> image tokens
        [cap // merge_unit, hidden] in original order. enc_args: the tensors
        of EncoderLayout.device_args."""
        img_tokens = self.vision_encoder(
            patches, *enc_args, kv_range=kv_range, win_range=win_range, use_kernels=use_kernels
        )
        return img_tokens + self.img_h_embed(llm_h_idx.long()) + self.img_w_embed(llm_w_idx.long())

    # -- programs ----------------------------------------------------------------

    def prefill(self, cache: dict, patches, enc_args, llm_h_idx, llm_w_idx, input_ids, img_gather,
                seq_lens, slot_idx, kv_range: int, win_range: int):
        """Encode, embed, decoder prefill, KV into the cache slots (in place),
        sample token 0. Returns (token [B], score [B], bbox [B, 6])."""
        image_tokens = self.encode_images(patches, enc_args, llm_h_idx, llm_w_idx, kv_range, win_range)
        embeds = self.embed_prompt_tokens(input_ids, img_gather, image_tokens)
        new_k, new_v, last_hidden = self.decoder.prefill(embeds, seq_lens)
        qwen_decoder.merge_prefill(cache, new_k, new_v, seq_lens, slot_idx)
        return self.sample_greedy(last_hidden)

    def decode_chunk(self, cache: dict, last_token, active, num_steps: int, run=None,
                     repeat_window: int = 0, pin_decode: bool = False):
        """Up to num_steps greedy decode steps on the device.

        A slot stops when it emits EOS/PAD (the token is still recorded); with
        ``pin_decode`` only the host stops it. With ``run``/``repeat_window``
        a slot also stops after repeat_window identical tokens in a row.
        Returns (tokens [B, K], scores [B, K], bboxes [B, K, 6], last_token,
        active, run); the cache is updated in place."""
        cfg = self.config
        dec = cfg.decoder
        B = last_token.shape[0]
        K = num_steps
        dev = last_token.device
        run = run if run is not None else torch.zeros_like(last_token)
        tokens_buf = torch.full((B, K), cfg.pad_token_id, dtype=torch.int32, device=dev)
        scores_buf = torch.zeros((B, K), dtype=torch.float32, device=dev)
        bbox_buf = torch.zeros((B, K, 6), dtype=torch.int32, device=dev)
        kv_shape = (dec.num_hidden_layers, B, dec.num_key_value_heads, K, dec.head_dim)
        chunk_k = torch.zeros(kv_shape, dtype=self.token_embed.weight.dtype, device=dev)
        chunk_v = torch.zeros_like(chunk_k)
        base_len = cache["len"].clone()
        advance = torch.zeros((B,), dtype=torch.int32, device=dev)
        pad = cfg.pad_token_id

        for step in range(K):
            emb = self.token_embed(last_token.long())
            hidden = self.decoder.decode_step_chunked(cache, chunk_k, chunk_v, emb, step, base_len)
            token, score, bbox = self.sample_greedy(hidden)
            done = (token == cfg.eos_token_id) | (token == cfg.pad_token_id)
            tokens_buf[:, step] = torch.where(active, token, pad)
            scores_buf[:, step] = torch.where(active & ~done, score, 0.0)
            bbox_buf[:, step] = torch.where(active[:, None], bbox, 0)
            advance += active.to(torch.int32)
            next_active = active if pin_decode else active & ~done
            run = torch.where(active, torch.where(token == last_token, run + 1, 1), run)
            if repeat_window:
                next_active = next_active & (run < repeat_window)
            last_token = torch.where(next_active, token, pad)
            active = next_active

        qwen_decoder.commit_chunk(cache, chunk_k, chunk_v, base_len, advance)
        return tokens_buf, scores_buf, bbox_buf, last_token, active, run
