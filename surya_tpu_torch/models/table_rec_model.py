"""Table structure recognition model: DonutSwin + ADETR multi-head decoder,
in PyTorch.

Counterpart of surya_tpu/models/table_rec_model.py, with the same outputs.
The decoder emits 10-component label vectors (bbox 6, category, merges,
colspan, is_header), embedded as concatenated box and property embeddings
and read out through five heads. A prompt (the query, or the query with the
columns' labels for the cell pass) is right-padded to a bucket and prefilled
causally; the steps then write the cache at rows >= the padded length while
their positions continue from the true one, with the padded rows masked. The
JAX predictor's jitted ``generate`` (each row's encoder states gathered by
index, the cross-attention K/V, the prompt's prefill, the box loop) is
``generate_loop``, one ``common.graphs.Loop`` whose cond is the JAX
package's (some row not done): a CUDA graph on the card that skips the steps
after it fails, the eager loop with the cond read after each step on the
CPU. The JAX predictor's jitted ``encode`` (the gray broadcast and
normalisation of its uint8 crops, then the encoder) is ``encode_program``,
a ``common.graphs.Program``: one CUDA graph replay on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common import graphs
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

    def launch_encode(self, pixels, programs):
        """surya_tpu table_rec's jitted encode through `programs` (a
        predictor's store: CUDA graphs on the card): uint8 crops [B, H, W, 1
        or 3] -> encoder states [B, tokens, hidden], keyed as jit keys it:
        by the pixels' device, shape (the channel count included) and
        dtype, the model's dtype and the config. The states are the graph's
        until the store's next replay of this key."""
        dtype = self.pre_output_norm.weight.dtype
        key = ("table_encode", pixels.device, tuple(pixels.shape), pixels.dtype, dtype, self.config)
        return programs.run(key, lambda: self.encode_program(pixels), {"pixels": pixels})["states"]

    def encode_program(self, pixels) -> graphs.Program:
        """encode of uint8 crops like `pixels` as a graphs.Program: the
        channel broadcast, the scaling to [0, 1], the normalisation and the
        encoder, into the output "states"."""
        c, dtype = self.config.encoder, self.pre_output_norm.weight.dtype
        x = graphs.static_inputs({"pixels": pixels}, pixels.device)
        out = {"states": torch.empty((pixels.shape[0], c.tokens, c.hidden_size), dtype=dtype, device=pixels.device)}

        def body():
            out["states"].copy_(self.encode(donut_swin.normalize_u8(x["pixels"], dtype)))

        return graphs.Program(x, out, body)

    def generate(self, encoder_hidden, input_vectors, seq_lens, max_steps: int,
                 category_script: Optional[Sequence[int]] = None):
        """AR decode of a batch of query prompts against encoder states.
        input_vectors: [B, L, 10] int, right-padded; seq_lens [B] int32.

        Per step: bbox sigmoid * 1024; category, merges and is_header argmax
        shifted down by SPECIAL_TOKENS; colspan round(max(x, 1)); a row is
        done at category EOS or PAD (before the shift) and records nothing
        after. category_script: a sequence of max_steps raw category ids (a
        host sequence or a device int vector); an entry >= 0 replaces the
        argmax at its step (random weights' category logits sit near zero,
        so benches and tests pin the control flow with it). The plain
        version of ``launch_generate`` (the prologue, then the eager box
        loop, the cond read on the host after each step) on any device, row
        i reading encoder_hidden[i]. Returns bbox [B, M, 6] fp32, category,
        merges, colspan, is_header [B, M] int32, valid [B, M] bool."""
        rows = torch.arange(encoder_hidden.shape[0], device=encoder_hidden.device)
        bufs, _ = self.launch_generate(encoder_hidden, rows, input_vectors, seq_lens, max_steps, category_script,
                                       graphs.EagerLoops())
        return bufs

    def launch_generate(self, states, enc_idx, input_vectors, seq_lens, max_steps: int, category_script,
                        loops) -> tuple:
        """surya_tpu table_rec's jitted generate through `loops` (a
        predictor's store: CUDA graphs on the card), without waiting, as one
        program: row i of the prompts reads encoder states
        states[enc_idx[i]] (states [n_tables, tokens, hidden]: the batch's,
        gathered inside the program). Keyed as jit keys it: by the states'
        device, the inputs' shapes and types (rows, the prompt bucket, the
        tables, max_steps) and the config. The inputs may be host tensors
        (pinned on CUDA). Returns (generate's buffers, which a graph owns
        until its next replay, and common.graphs.Ran)."""
        if category_script is None:
            script = torch.full((max_steps,), -1, dtype=torch.int64)
        else:
            script = torch.as_tensor(category_script).long()
        inputs = {"states": states, "enc_idx": enc_idx, "vectors": input_vectors,
                  "seq_lens": seq_lens.to(torch.int32), "script": script}
        key = ("table_rec", states.device, self.pre_output_norm.weight.dtype, self.config,
               *((name, tuple(t.shape), t.dtype) for name, t in inputs.items()))
        return loops.run(key, lambda: self.generate_loop(inputs, states.device), inputs)

    def generate_loop(self, inputs: Dict[str, torch.Tensor], device) -> graphs.Loop:
        """The whole generate as a graphs.Loop over static inputs on `device`
        like launch_generate's: begin runs the prologue (the gather of each
        row's encoder states, the cross-attention K/V into the loop's
        buffers, the self-attention cache zeroed, the prompt's embedding and
        prefill) and records step 0 from the prefill's last hidden state;
        step i - 1 embeds the last vector, runs the decoder step at cache
        row L + i - 1 and records step i; the cond is that some row is not
        done."""
        c, dec = self.config, self.config.decoder
        x = graphs.static_inputs(inputs, device)
        states, enc_idx, vectors, seq_lens, script = x.values()
        B, L, _ = vectors.shape
        max_steps = script.shape[0]
        dtype = self.pre_output_norm.weight.dtype
        cross_k = torch.zeros((dec.num_hidden_layers, B, states.shape[1], dec.num_key_value_heads, dec.head_dim),
                              dtype=dtype, device=device)
        cross_v = torch.zeros_like(cross_k)
        cache = self.decoder.init_cache(B, L + max_steps + 1, dtype, device)
        bufs = {"bbox": torch.zeros((B, max_steps, 6), dtype=torch.float32, device=device)}
        for k in ("category", "merges", "colspan", "is_header"):
            bufs[k] = torch.zeros((B, max_steps), dtype=torch.int32, device=device)
        bufs["valid"] = torch.zeros((B, max_steps), dtype=torch.bool, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        vec = torch.zeros((B, 10), dtype=torch.int64, device=device)
        write_base = torch.full((B,), L, dtype=torch.int32, device=device)
        pred = torch.zeros((), dtype=torch.bool, device=device)

        def process(hidden, i):
            """Record step i; set done, the next input vector and the cond."""
            out = self.head_outputs(hidden)
            bbox = out["bbox"] * BOX_DIM
            cat_raw = torch.where(script[i] >= 0, script[i], out["category"].argmax(-1))
            merges_raw = out["merges"].argmax(-1)
            header_raw = out["is_header"].argmax(-1)
            colspan = torch.round(torch.clamp(out["colspan"][..., 0], min=1.0)).long()
            done.logical_or_((cat_raw == c.eos_token_id) | (cat_raw == c.pad_token_id))
            record = ~done
            bufs["bbox"][:, i] = torch.where(record[:, None], bbox, 0.0)
            bufs["category"][:, i] = torch.where(record, cat_raw - SPECIAL_TOKENS, 0).int()
            bufs["merges"][:, i] = torch.where(record, merges_raw - SPECIAL_TOKENS, 0).int()
            bufs["is_header"][:, i] = torch.where(record, header_raw - SPECIAL_TOKENS, 0).int()
            bufs["colspan"][:, i] = torch.where(record, colspan, 0).int()
            bufs["valid"][:, i] = record
            # the next input: bbox truncated to ints and clamped, the
            # classification fields as raw (shifted-up) ids
            vec.copy_(torch.cat([torch.clamp(bbox, 0, BOX_DIM).long(), cat_raw[:, None], merges_raw[:, None],
                                 colspan[:, None], header_raw[:, None]], dim=-1))
            pred.copy_(~done.all())

        def begin():
            k, v = self.decoder.precompute_cross_kv(states[enc_idx.long()])
            cross_k.copy_(k)
            cross_v.copy_(v)
            for buf in (cache["k"], cache["v"], *bufs.values(), done):
                buf.zero_()
            process(self.decoder.prefill(cache, cross_k, cross_v, self.embed_labels(vectors), seq_lens), 0)

        def step(k: int):
            i = k + 1
            hidden = self.decoder.step(cache, cross_k, cross_v, self.embed_labels(vec), pos=seq_lens + i - 1,
                                       write_idx=write_base + i - 1, seq_lens=seq_lens, prompt_len=L)
            process(hidden, i)

        return graphs.Loop(max_steps - 1, x, bufs, pred, begin, step)


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(tensors, config: TableRecConfig) -> dict:
    """The upstream torch checkpoint as surya_tpu table_rec_model's pytree
    (numpy leaves, JAX layout; surya_tpu table_rec_model.convert_torch)."""
    from surya_tpu_torch.common.weights import TensorBag

    bag = tensors if isinstance(tensors, TensorBag) else TensorBag(tensors)
    embed = {
        f"{f}_embed": bag.embedding(f"decoder.model.embed_tokens.{f}_embed")
        for f in _BOX_FIELDS + _CORNER_FIELDS
    }
    embed["category_embed"] = bag.embedding("decoder.model.embed_tokens.category_embed")
    embed["merge_embed"] = bag.embedding("decoder.model.embed_tokens.merge_embed")
    embed["colspan_embed"] = bag.embedding("decoder.model.embed_tokens.colspan_embed")
    heads = {
        k: bag.linear(f"decoder.box_property_heads.{k}", bias=False) for k, _, _ in BOX_PROPERTIES
    }
    params = {
        "encoder": donut_swin.convert_torch(bag, config.encoder, "encoder"),
        "decoder": adetr.convert_torch(bag, config.decoder, "decoder.model"),
        "embedder": embed,
        "pre_output_norm": bag.layernorm("decoder.pre_output_norm"),
        "heads": heads,
    }
    bag.warn_unused("table_rec")
    return params
