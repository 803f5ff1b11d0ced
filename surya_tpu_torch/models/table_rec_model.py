"""Table structure recognition model: DonutSwin + ADETR multi-head decoder,
in PyTorch.

Counterpart of surya_tpu/models/table_rec_model.py, with the same outputs.
The decoder emits 10-component label vectors (bbox 6, category, merges,
colspan, is_header), embedded as concatenated box and property embeddings
and read out through five heads. A prompt (the query, or the query with the
columns' labels for the cell pass) is right-padded to a bucket and prefilled
causally; the steps then write the cache at rows >= the padded length while
their positions continue from the true one, with the padded rows masked. The
box loop is eager and checks for all-done through ``adetr.DoneWatch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models import adetr, donut_swin

BOX_DIM = 1024
SPECIAL_TOKENS = 5
MERGE_KEYS = {"none": 0, "merge_up": 1, "merge_down": 2, "merge_both": 3}
MERGE_VALUES = [MERGE_KEYS["merge_up"], MERGE_KEYS["merge_down"], MERGE_KEYS["merge_both"]]
ID_TO_CATEGORY = {0: "Blank", 1: "Table-row", 2: "Table-column", 3: "Table-cell", 4: "Table"}
CATEGORY_TO_ID = {v: k for k, v in ID_TO_CATEGORY.items()}
ID_TO_HEADER = {0: "None", 1: "Header"}

# (key, head output count before the special-token shift, mode)
BOX_PROPERTIES = [
    ("bbox", 6, "regression"),
    ("category", len(ID_TO_CATEGORY), "classification"),
    ("merges", len(MERGE_KEYS), "classification"),
    ("colspan", 1, "regression"),
    ("is_header", len(ID_TO_HEADER), "classification"),
]


@dataclass(frozen=True)
class TableRecConfig:
    vocab_size: int = BOX_DIM + 1
    bbox_size: int = BOX_DIM
    property_embed_size: int = 64
    box_embed_size: int = 512 - 64
    special_token_count: int = SPECIAL_TOKENS
    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 1
    query_end_token_id: int = 4
    max_boxes: int = 150
    layer_norm_eps: float = 1e-5
    encoder: donut_swin.DonutSwinConfig = field(
        default_factory=lambda: donut_swin.DonutSwinConfig(depths=(2, 2, 12, 2), encoder_length=1024)
    )
    decoder: adetr.ADETRConfig = field(
        default_factory=lambda: adetr.ADETRConfig(
            num_hidden_layers=6, hidden_size=512, intermediate_size=2048,
            encoder_hidden_size=1024, num_attention_heads=8, num_key_value_heads=4,
            double_residual_flow=False,
            cross_attn_layers=tuple(range(10)), self_attn_layers=tuple(range(10)),
        )
    )


_BOX_FIELDS = ("cx", "cy", "w", "h", "xskew", "yskew")
_CORNER_FIELDS = ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4")  # only x1, y1, x3, y3 are embedded


class TableRecModel(nn.Module):
    """Submodule names follow surya_tpu table_rec_model.init_params' pytree."""

    def __init__(self, config: TableRecConfig):
        super().__init__()
        self.config = config
        embed = {f"{f}_embed": nn.Embedding(config.vocab_size, config.box_embed_size)
                 for f in _BOX_FIELDS + _CORNER_FIELDS}
        prop = config.property_embed_size
        embed["category_embed"] = nn.Embedding(len(ID_TO_CATEGORY) + 2 * SPECIAL_TOKENS, prop)
        embed["merge_embed"] = nn.Embedding(len(MERGE_KEYS) + 2 * SPECIAL_TOKENS, prop)
        embed["colspan_embed"] = nn.Embedding(config.vocab_size, prop)
        h = config.decoder.hidden_size
        self.encoder = donut_swin.DonutSwin(config.encoder)
        self.decoder = adetr.ADETRDecoder(config.decoder)
        self.embedder = nn.ModuleDict(embed)
        self.pre_output_norm = pnn.LayerNorm(h, config.layer_norm_eps)
        self.heads = nn.ModuleDict({
            k: nn.Linear(h, count + SPECIAL_TOKENS if mode == "classification" else count, bias=False)
            for k, count, mode in BOX_PROPERTIES
        })

    def embed_labels(self, vectors):
        """Label vectors [..., 10] -> concat(box embeddings, property
        embeddings) [..., box_embed_size + property_embed_size]."""
        c = self.config
        e = self.embedder
        v = vectors.long().clamp(0, c.vocab_size - 1)
        cx, cy, w, h, xskew, yskew = v[..., :6].unbind(-1)
        category, merges, colspan = v[..., 6], v[..., 7], v[..., 8]
        # trunc of a true division for the skew, floor division for w // 2
        xs = torch.trunc((xskew - c.bbox_size // 2) / 2).long()
        ys = torch.trunc((yskew - c.bbox_size // 2) / 2).long()
        x1 = (cx - w // 2 - xs).clamp(0, c.bbox_size)
        y1 = (cy - h // 2 - ys).clamp(0, c.bbox_size)
        x3 = (cx + w // 2 + xs).clamp(0, c.bbox_size)
        y3 = (cy + h // 2 + ys).clamp(0, c.bbox_size)
        box = (
            e["w_embed"](w) + e["h_embed"](h)
            + e["cx_embed"](cx) + e["cy_embed"](cy)
            + e["xskew_embed"](xskew) + e["yskew_embed"](yskew)
            + e["x1_embed"](x1) + e["y1_embed"](y1)
            + e["x3_embed"](x3) + e["y3_embed"](y3)
        )
        prop = e["category_embed"](category) + e["merge_embed"](merges) + e["colspan_embed"](colspan)
        return torch.cat([box, prop], dim=-1)

    def head_outputs(self, hidden) -> Dict[str, torch.Tensor]:
        """fp32 logits of each property; bbox through a sigmoid."""
        h = self.pre_output_norm(hidden)
        out = {k: self.heads[k](h).float() for k, _, _ in BOX_PROPERTIES}
        out["bbox"] = torch.sigmoid(out["bbox"])
        return out

    def encode(self, pixel_values):
        return self.encoder(pixel_values)

    def generate(self, encoder_hidden, input_vectors, seq_lens, max_steps: int,
                 category_script: Optional[Sequence[int]] = None, watch: Optional[adetr.DoneWatch] = None):
        """AR decode of a batch of query prompts against encoder states.
        input_vectors: [B, L, 10] int, right-padded; seq_lens [B] int32.

        Per step: bbox sigmoid * 1024; category, merges and is_header argmax
        shifted down by SPECIAL_TOKENS; colspan round(max(x, 1)); a row is
        done at category EOS or PAD (before the shift) and records nothing
        after. category_script: a host sequence of max_steps raw category
        ids; an entry >= 0 replaces the argmax at its step (random weights'
        category logits sit near zero, so benches and tests pin the control
        flow with it). Returns bbox [B, M, 6] fp32, category, merges,
        colspan, is_header [B, M] int32, valid [B, M] bool."""
        c = self.config
        B, L, _ = input_vectors.shape
        dev = encoder_hidden.device
        watch = watch or adetr.DoneWatch(dev)
        cross_k, cross_v = self.decoder.precompute_cross_kv(encoder_hidden)
        cache = self.decoder.init_cache(B, L + max_steps + 1, encoder_hidden.dtype, dev)
        last_hidden = self.decoder.prefill(cache, cross_k, cross_v, self.embed_labels(input_vectors), seq_lens)

        bufs = {"bbox": torch.zeros((B, max_steps, 6), dtype=torch.float32, device=dev)}
        for k in ("category", "merges", "colspan", "is_header"):
            bufs[k] = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
        bufs["valid"] = torch.zeros((B, max_steps), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)

        def process(hidden, i):
            """Record step i; returns (done, the next input vector [B, 10])."""
            out = self.head_outputs(hidden)
            bbox = out["bbox"] * BOX_DIM
            if category_script is not None and category_script[i] >= 0:
                cat_raw = torch.full((B,), int(category_script[i]), dtype=torch.int64, device=dev)
            else:
                cat_raw = out["category"].argmax(-1)
            merges_raw = out["merges"].argmax(-1)
            header_raw = out["is_header"].argmax(-1)
            colspan = torch.round(torch.clamp(out["colspan"][..., 0], min=1.0)).long()
            done_after = done | (cat_raw == c.eos_token_id) | (cat_raw == c.pad_token_id)
            record = ~done_after
            bufs["bbox"][:, i] = torch.where(record[:, None], bbox, 0.0)
            bufs["category"][:, i] = torch.where(record, cat_raw - SPECIAL_TOKENS, 0).int()
            bufs["merges"][:, i] = torch.where(record, merges_raw - SPECIAL_TOKENS, 0).int()
            bufs["is_header"][:, i] = torch.where(record, header_raw - SPECIAL_TOKENS, 0).int()
            bufs["colspan"][:, i] = torch.where(record, colspan, 0).int()
            bufs["valid"][:, i] = record
            # the next input: bbox truncated to ints and clamped, the
            # classification fields as raw (shifted-up) ids
            nxt = torch.cat([torch.clamp(bbox, 0, BOX_DIM).long(), cat_raw[:, None], merges_raw[:, None],
                             colspan[:, None], header_raw[:, None]], dim=-1)
            return done_after, nxt

        done, vec = process(last_hidden, 0)
        write_base = torch.full((B,), L, dtype=torch.int32, device=dev)
        i = 1
        while not watch.poll(done) and i < max_steps:  # a poll after every recorded step
            hidden = self.decoder.step(cache, cross_k, cross_v, self.embed_labels(vec),
                                       pos=seq_lens + i - 1, write_idx=write_base + i - 1,
                                       seq_lens=seq_lens, prompt_len=L)
            done, vec = process(hidden, i)
            i += 1
        return bufs
