"""Layout analysis model: DonutSwin encoder + ADETR box decoder, in PyTorch.

Counterpart of surya_tpu/models/layout_model.py, with the same outputs. The
JAX layout predictor jits one program: the gray broadcast and normalisation
of its uint8 tiles, the encoder and the box loop, a device ``while_loop``
that stops once every row is done. Here that program is one
``common.graphs.Loop``: its ``begin`` runs the prologue (the channel
broadcast, the scaling and normalisation of uint8 tiles, DonutSwin and the
cross-attention K/V) from its static input, then up to ``max_boxes`` steps
whose cond is the same (some row not done): a CUDA graph on the card that
skips the steps after it fails, the eager loop with the cond read after
each step on the CPU. Each step applies the PageHeader/PageFooter rewrite
in token space, as there. Reading order is emission order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common import graphs
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

    def generate(self, pixel_values):
        """Layout of a batch of pages: the plain version of
        ``launch_generate`` (the prologue, then the eager box loop, the cond
        read on the host after each step) on any device.

        Returns (boxes [B, MAX, 7] fp32: the 6 box values in 0..bbox_size and
        the final class id; class_logits [B, MAX, label_count] fp32, after the
        rewrite; valid [B, MAX] bool: the step was recorded, its row not yet
        done)."""
        outputs, _ = self.launch_generate(pixel_values, graphs.EagerLoops())
        return outputs

    def launch_generate(self, pixel_values, loops) -> tuple:
        """generate through `loops` (a predictor's store: CUDA graphs on the
        card), without waiting, as one program keyed as jit keys the JAX
        one: by the pixels' device, shape (the channel count included) and
        dtype, the model's dtype and the config. pixel_values: uint8 tiles
        [B, H, W, 1 or 3] (the predictor's: broadcast and normalised inside
        the program), or pages [B, H, W, 3] normalised already (surya_tpu
        layout_model.generate's input). Returns (generate's outputs, which a
        graph owns until its next replay, and common.graphs.Ran)."""
        key = ("layout", pixel_values.device, tuple(pixel_values.shape), pixel_values.dtype, self.dtype, self.config)
        return loops.run(key, lambda: self.generate_loop(pixel_values), {"pixels": pixel_values})

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    def generate_loop(self, pixel_values) -> graphs.Loop:
        """The whole generate as a graphs.Loop over the static input
        "pixels", like pixel_values: begin runs the prologue (uint8 pixels
        normalised, the encoder, the cross-attention K/V written into the
        loop's buffers), then zeroes the self-attention cache and the
        buffers; step i embeds the last box, runs the decoder step and
        records the box unless its row is done; the cond is that some row is
        not done."""
        c, dec = self.config, self.config.decoder
        dev, dtype = pixel_values.device, self.dtype
        B, MAX = pixel_values.shape[0], c.max_boxes
        pixels = torch.empty(pixel_values.shape, dtype=pixel_values.dtype, device=dev)
        cross_k = torch.zeros((dec.num_hidden_layers, B, c.encoder.tokens, dec.num_key_value_heads, dec.head_dim),
                              dtype=dtype, device=dev)
        cross_v = torch.zeros_like(cross_k)
        cache = self.decoder.init_cache(B, MAX + 1, dtype, dev)
        last_box = torch.zeros((B, 7), dtype=torch.int32, device=dev)
        boxes_buf = torch.zeros((B, MAX, 7), dtype=torch.float32, device=dev)
        logits_buf = torch.zeros((B, MAX, c.label_count), dtype=torch.float32, device=dev)
        valid_buf = torch.zeros((B, MAX), dtype=torch.bool, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        pred = torch.zeros((), dtype=torch.bool, device=dev)

        def begin():
            x = donut_swin.normalize_u8(pixels, dtype) if pixels.dtype == torch.uint8 else pixels
            k, v = self.decoder.precompute_cross_kv(self.encoder(x))
            cross_k.copy_(k)
            cross_v.copy_(v)
            for buf in (cache["k"], cache["v"], boxes_buf, logits_buf, valid_buf, done):
                buf.zero_()
            last_box.fill_(c.bos_token_id)
            pred.fill_(B > 0)

        def step(i: int):
            emb = self.embed_boxes(last_box)
            pos = torch.full((B,), i, dtype=torch.int32, device=dev)
            hidden = self.decoder.step(cache, cross_k, cross_v, emb, pos)
            class_logits, bbox = self.heads(hidden)
            box_f = bbox * c.bbox_size  # float box values, recorded as they are
            class_pred = class_logits.argmax(-1)
            done.logical_or_((class_pred == c.eos_token_id) | (class_pred == c.pad_token_id))

            rule = self.position_rule(box_f, class_pred)
            onehot = class_pred[:, None] == torch.arange(c.label_count, device=dev)
            new_logits = torch.where(rule[:, None] & onehot, 0.0, class_logits)
            class_final = torch.where(rule, new_logits.argmax(-1), class_pred)

            record = ~done
            token = torch.cat([box_f, class_final[:, None].float()], dim=-1)
            boxes_buf[:, i] = torch.where(record[:, None], token, 0.0)
            logits_buf[:, i] = torch.where(record[:, None], new_logits, 0.0)
            valid_buf[:, i] = record
            last_box.copy_(torch.cat([box_f.to(torch.int32), class_final[:, None].to(torch.int32)], dim=-1))
            pred.copy_(~done.all())

        return graphs.Loop(MAX, {"pixels": pixels}, (boxes_buf, logits_buf, valid_buf), pred, begin, step)


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(tensors, config: LayoutConfig) -> dict:
    """The upstream torch checkpoint as surya_tpu layout_model's pytree (numpy
    leaves, JAX layout; surya_tpu layout_model.convert_torch)."""
    from surya_tpu_torch.common.weights import TensorBag

    bag = tensors if isinstance(tensors, TensorBag) else TensorBag(tensors)
    embed = {
        f"{f}_embed": bag.embedding(f"decoder.model.embed_tokens.{f}_embed")
        for f in _BOX_FIELDS + _CORNER_FIELDS
    }
    embed["label_embed"] = bag.embedding("decoder.model.embed_tokens.label_embed")
    params = {
        "encoder": donut_swin.convert_torch(bag, config.encoder, "encoder"),
        "decoder": adetr.convert_torch(bag, config.decoder, "decoder.model"),
        "embedder": embed,
        "pre_output_norm": bag.layernorm("decoder.pre_output_norm"),
        "lm_head": bag.linear("decoder.lm_head", bias=False),
        "bbox_head": bag.linear("decoder.bbox_head"),
    }
    bag.warn_unused("layout")
    return params
