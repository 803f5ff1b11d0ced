"""Layout analysis model: DonutSwin encoder + ADETR box decoder, in PyTorch.

Counterpart of surya_tpu/models/layout_model.py, with the same outputs. The
JAX package runs the whole box loop as one device ``while_loop`` that stops
once every row is done; here it is an eager loop of up to ``max_boxes``
steps that asks the device whether every row is done only every
``adetr.DoneWatch.every`` steps, through a non-blocking copy read after an
event (a done row records nothing, so the extra steps change no output).
Each step applies the PageHeader/PageFooter rewrite in token space, as
there. Reading order is emission order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.models import adetr, donut_swin

SPECIAL_TOKENS = 3
ID_TO_LABEL = {
    0: "Blank",
    1: "Text",
    2: "TextInlineMath",
    3: "Code",
    4: "SectionHeader",
    5: "Caption",
    6: "Footnote",
    7: "Equation",
    8: "ListItem",
    9: "PageFooter",
    10: "PageHeader",
    11: "Picture",
    12: "Figure",
    13: "Table",
    14: "Form",
    15: "TableOfContents",
    16: "Handwriting",
}
LABEL_TO_ID = {v: k for k, v in ID_TO_LABEL.items()}
# shifted class ids of PageFooter/PageHeader for the position rule
_HF_CLASS_IDS = (LABEL_TO_ID["PageFooter"] + SPECIAL_TOKENS, LABEL_TO_ID["PageHeader"] + SPECIAL_TOKENS)


@dataclass(frozen=True)
class LayoutConfig:
    vocab_size: int = 1025  # bbox coordinate vocabulary (0..1024)
    bbox_size: int = 1024
    skew_scaler: int = 512
    label_count: int = len(ID_TO_LABEL) + SPECIAL_TOKENS
    special_token_count: int = SPECIAL_TOKENS
    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 1
    pause_token_id: int = 2
    max_boxes: int = 100
    layer_norm_eps: float = 1e-5
    encoder: donut_swin.DonutSwinConfig = field(default_factory=donut_swin.DonutSwinConfig)
    decoder: adetr.ADETRConfig = field(default_factory=adetr.ADETRConfig)


_BOX_FIELDS = ("cx", "cy", "w", "h", "xskew", "yskew")
_CORNER_FIELDS = ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4")


class LayoutModel(nn.Module):
    """Submodule names follow surya_tpu layout_model.init_params' pytree."""

    def __init__(self, config: LayoutConfig):
        super().__init__()
        self.config = config
        h = config.decoder.hidden_size
        self.encoder = donut_swin.DonutSwin(config.encoder)
        self.decoder = adetr.ADETRDecoder(config.decoder)
        embed = {f"{f}_embed": nn.Embedding(config.vocab_size, h) for f in _BOX_FIELDS + _CORNER_FIELDS}
        embed["label_embed"] = nn.Embedding(config.label_count, h)
        self.embedder = nn.ModuleDict(embed)
        self.pre_output_norm = pnn.LayerNorm(h, config.layer_norm_eps)
        self.lm_head = nn.Linear(h, config.label_count, bias=False)
        self.bbox_head = nn.Linear(h, 6)

    def embed_boxes(self, boxes):
        """7-field box tokens [B, 7] -> the summed embeddings of the fields
        and of the 8 corners derived from them."""
        c = self.config
        e = self.embedder
        cx, cy, w, h, xskew, yskew, label = boxes.long().unbind(-1)
        xs = torch.trunc((xskew - c.bbox_size // 2) / 2).long()
        ys = torch.trunc((yskew - c.bbox_size // 2) / 2).long()

        def clamp(v):
            return v.clamp(0, c.bbox_size)

        corners = {
            "x1": clamp(cx - w // 2 - xs),
            "y1": clamp(cy - h // 2 - ys),
            "x2": clamp(cx + w // 2 - xs),
            "y2": clamp(cy + h // 2 + ys),
            "x3": clamp(cx + w // 2 + xs),
            "y3": clamp(cy + h // 2 + ys),
            "x4": clamp(cx - w // 2 + xs),
            "y4": clamp(cy - h // 2 - ys),
        }
        out = e["label_embed"](label)
        for f, v in zip(_BOX_FIELDS, (cx, cy, w, h, xskew, yskew)):
            out = out + e[f"{f}_embed"](v)
        for f, v in corners.items():
            out = out + e[f"{f}_embed"](v)
        return out

    def heads(self, hidden):
        """(class logits, boxes in [0, 1]), both fp32."""
        h = self.pre_output_norm(hidden)
        return self.lm_head(h).float(), torch.sigmoid(self.bbox_head(h).float())

    def position_rule(self, box_f, class_pred):
        """True where the PageHeader/PageFooter rewrite applies: the box is
        not confined to a page margin (thresholds in 0..bbox_size token space,
        where the page scaling cancels)."""
        c = self.config
        cx, cy, w, h, xskew, yskew = box_f.unbind(-1)
        skew_x = torch.floor((xskew - c.skew_scaler) / 2)
        skew_y = torch.floor((yskew - c.skew_scaler) / 2)
        skew_x = torch.where(skew_x.abs() < 0.001, 0.0, skew_x)
        skew_y = torch.where(skew_y.abs() < 0.001, 0.0, skew_y)
        x0 = cx - w / 2 - skew_x
        y0 = cy - h / 2 - skew_y
        x2 = cx + w / 2 + skew_x
        y2 = cy + h / 2 + skew_y
        is_hf = (class_pred == _HF_CLASS_IDS[0]) | (class_pred == _HF_CLASS_IDS[1])
        lo = 0.2 * c.bbox_size
        hi = 0.8 * c.bbox_size
        return is_hf & (y0 < hi) & (y2 > lo) & (x0 < hi) & (x2 > lo)

    def generate(self, pixel_values, watch: Optional[adetr.DoneWatch] = None):
        """Layout of a batch of normalized pages [B, H, W, 3].

        Returns (boxes [B, MAX, 7] fp32: the 6 box values in 0..bbox_size and
        the final class id; class_logits [B, MAX, label_count] fp32, after the
        rewrite; valid [B, MAX] bool: the step was recorded, its row not yet
        done). ``watch`` (made here if not given) counts the steps and syncs."""
        c = self.config
        B = pixel_values.shape[0]
        MAX = c.max_boxes
        dev = pixel_values.device
        watch = watch or adetr.DoneWatch(dev)

        enc = self.encoder(pixel_values)
        cross_k, cross_v = self.decoder.precompute_cross_kv(enc)
        cache = self.decoder.init_cache(B, MAX + 1, enc.dtype, dev)

        last_box = torch.full((B, 7), c.bos_token_id, dtype=torch.int32, device=dev)
        boxes_buf = torch.zeros((B, MAX, 7), dtype=torch.float32, device=dev)
        logits_buf = torch.zeros((B, MAX, c.label_count), dtype=torch.float32, device=dev)
        valid_buf = torch.zeros((B, MAX), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(MAX):
            emb = self.embed_boxes(last_box)
            pos = torch.full((B,), i, dtype=torch.int32, device=dev)
            hidden = self.decoder.step(cache, cross_k, cross_v, emb, pos)
            class_logits, bbox = self.heads(hidden)
            box_f = bbox * c.bbox_size  # float box values, recorded as they are
            class_pred = class_logits.argmax(-1)
            done = done | (class_pred == c.eos_token_id) | (class_pred == c.pad_token_id)

            rule = self.position_rule(box_f, class_pred)
            onehot = class_pred[:, None] == torch.arange(c.label_count, device=dev)
            new_logits = torch.where(rule[:, None] & onehot, 0.0, class_logits)
            class_final = torch.where(rule, new_logits.argmax(-1), class_pred)

            record = ~done
            token = torch.cat([box_f, class_final[:, None].float()], dim=-1)
            boxes_buf[:, i] = torch.where(record[:, None], token, 0.0)
            logits_buf[:, i] = torch.where(record[:, None], new_logits, 0.0)
            valid_buf[:, i] = record
            last_box = torch.cat([box_f.to(torch.int32), class_final[:, None].to(torch.int32)], dim=-1)
            if watch.poll(done):
                break
        return boxes_buf, logits_buf, valid_buf
