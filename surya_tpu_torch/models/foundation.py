"""The recognition foundation model: vision encoder + decoder + dual heads.

Counterpart of surya_tpu/models/foundation.py. ``prefill`` encodes the
images, scatters them into the prompt's <IMAGE> positions, runs the decoder
prefill, writes the KV into the slot cache and samples token 0.
``prefill_program`` builds a prefill wave as the JAX recognition
predictor's jitted ``prefill_fn`` runs it (the kill, the patch
normalisation, ``prefill``, the new slots' state from token 0) in the form
of a ``common.graphs.Program``, which a CUDA graph replays on the card
(``launch_prefill``).
``decode_chunk`` runs up to ``num_steps`` greedy steps over a read-only
cache plus a chunk buffer that is committed once at the end, as the JAX
package's ``while_loop`` does: ``chunk_loop`` builds it as a
``common.graphs.Loop`` whose ``pred`` is the JAX cond (some slot active),
which a CUDA graph replays with each step in an IF node (no host
synchronisation inside, nor in ``prefill``: no copy from the host, no read
of a device value), and the CPU runs eagerly with the cond read after each
step.

The lm head shares the token embedding matrix (plus ``lm_head_bias``).

The decoder is the one ``decoder.model_type`` names (``DECODERS``): the
Qwen2-style decoder (models/qwen_decoder.py, "qwen2") or LFM2-MoE's hybrid
of short convolutions and attention over sparse experts
(models/lfm2_decoder.py, "lfm2_moe"), whose slot cache holds the
convolution state beside the attention layers' KV. Either takes the same
programs; ``MeshedFoundation`` runs the Qwen2-style one only.

``MeshedFoundation`` runs both programs on a mesh (parallel/mesh.py): rows
and slots over the data axis, the decoder tensor-parallel over the model
axis. Its prefill wave is a ``common.graphs.Program`` over every shard,
with static routes from the rows to the slots (each slot takes its source
row, -1 for none: ``slot_sources``), so that one wave shape is one program
whatever slots it fills; its decode chunk is a ``common.graphs.Loop`` over
every shard, with the JAX loop's cond reduced over all of them. On a mesh
whose shards all lie on one card each is one CUDA graph replay (a chunk's
steps in IF nodes); over distinct cards they run eagerly, the chunk's cond
read on the host after each step.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from surya_tpu_torch.common import graphs
from surya_tpu_torch.models import lfm2_decoder, qwen_decoder, qwen_encoder
from surya_tpu_torch.parallel.mesh import Placement, Sharded, gather_rows

# decoder.model_type -> (the decoder's module class, the module of its slot-cache helpers)
DECODERS = {"qwen2": (qwen_decoder.Decoder, qwen_decoder),
            lfm2_decoder.MODEL_TYPE: (lfm2_decoder.Lfm2Decoder, lfm2_decoder)}


def decoder_kind(config) -> tuple:
    """DECODERS' entry for a decoder config, by its model_type."""
    if config.model_type not in DECODERS:
        raise ValueError(f"no decoder of model_type {config.model_type!r}; known: {sorted(DECODERS)}")
    return DECODERS[config.model_type]


def init_cache(config, n_slots: int, max_seq: int, dtype, device, quantize: bool = False, mesh=None) -> dict:
    """The slot cache of the decoder that `config` describes (its module's init_cache)."""
    return decoder_kind(config)[1].init_cache(config, n_slots, max_seq, dtype, device, quantize=quantize, mesh=mesh)


@dataclass(frozen=True)
class FoundationConfig:
    vocab_size: int = 65536
    bbox_size: int = 1025
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 2
    image_token_id: int = 3
    max_sequence_length: int = 1536
    num_register_tokens: int = 4
    image_embed_encoding_size: int = 1024
    image_embed_encoding_multiplier: int = 256
    encoder: qwen_encoder.EncoderConfig = field(default_factory=qwen_encoder.EncoderConfig)
    # a qwen_decoder.DecoderConfig or an lfm2_decoder.Lfm2Config
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
        self.decoder = decoder_kind(config.decoder)[0](config.decoder)
        self.token_embed = nn.Embedding(config.vocab_size, h)
        self.img_w_embed = nn.Embedding(config.image_embed_encoding_size, h)
        self.img_h_embed = nn.Embedding(config.image_embed_encoding_size, h)
        self.bbox_head = nn.Linear(h, 6)
        self.lm_head_bias = nn.Parameter(torch.zeros(config.vocab_size))

    # -- pieces ----------------------------------------------------------------

    def projection_type(self) -> str:
        """What the graphs key the decoder's projections by: the type of the
        first attention projection (nn.Linear, or nn.QuantLinear with int8
        weights)."""
        layer = next(layer for layer in self.decoder.layers if hasattr(layer, "self_attn"))
        return type(layer.self_attn.q_proj).__name__

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

    # -- the slot state (surya_tpu recognition's _apply_kill and _seed_slots) --------

    def apply_kill(self, last_token, active, kill):
        """Stops the host found (budget, repeats) reach the device with the
        next dispatch: deactivate killed slots before running it."""
        return torch.where(kill, self.config.pad_token_id, last_token), active & ~kill

    def token0_state(self, tok, pin: bool, no_output_token: int):
        """A newly filled slot's last token and active flag from its prefill token 0."""
        cfg = self.config
        done0 = torch.zeros_like(tok, dtype=torch.bool) if pin else (tok == cfg.eos_token_id) | (tok == no_output_token)
        return torch.where((tok == cfg.eos_token_id) | (tok == cfg.pad_token_id), cfg.pad_token_id, tok), ~done0

    def seed_slots(self, last_token, active, run, tok, slot_idx, row_valid, pin: bool, no_output_token: int):
        """Device state of the newly filled slots, from prefill token 0."""
        lt_new, active_new = self.token0_state(tok, pin, no_output_token)
        idx = (slot_idx.long(),)
        last_token = last_token.index_put(idx, torch.where(row_valid, lt_new, last_token[idx]))
        active = active.index_put(idx, torch.where(row_valid, active_new, active[idx]))
        run = run.index_put(idx, torch.where(row_valid, 1, run[idx]))  # token 0 starts each run
        return last_token, active, run

    def seed_slot_sources(self, last_token, active, run, tok, rows, take, pin: bool, no_output_token: int):
        """seed_slots with the map turned round: slot s takes token 0 of row
        rows[s] of tok where take[s], and keeps its state elsewhere (rows,
        take [slots]). The same state whatever slots a wave fills, in
        static shapes."""
        lt_new, active_new = self.token0_state(tok[rows.clamp(0, tok.shape[0] - 1).long()], pin, no_output_token)
        return torch.where(take, lt_new, last_token), torch.where(take, active_new, active), torch.where(take, 1, run)

    # -- programs ----------------------------------------------------------------

    def prefill(self, cache: dict, patches, enc_args, llm_h_idx, llm_w_idx, input_ids, img_gather,
                seq_lens, slot_idx, kv_range: int, win_range: int):
        """Encode, embed, decoder prefill, KV into the cache slots (in place),
        sample token 0. Returns (token [B], score [B], bbox [B, 6])."""
        image_tokens = self.encode_images(patches, enc_args, llm_h_idx, llm_w_idx, kv_range, win_range)
        embeds = self.embed_prompt_tokens(input_ids, img_gather, image_tokens)
        *state, last_hidden = self.decoder.prefill(embeds, seq_lens)
        decoder_kind(self.config.decoder)[1].merge_prefill(cache, *state, seq_lens, slot_idx)
        return self.sample_greedy(last_hidden)

    def launch_prefill(self, cache: dict, inputs: dict, kv_range: int, win_range: int, pin: bool, normalize,
                       no_output_token: int, programs) -> dict:
        """prefill_program through `programs` (a predictor's store: CUDA
        graphs on the card), keyed as surya_tpu's prefill_fn is jitted: by
        the inputs' shapes and types (rows, L, the patch capacity and the
        layout arrays), kv_range, win_range, pin, the slot cache (its
        tensors' addresses: cache_id), the decoder's projection type and the
        config (normalize and no_output_token are the processor's, one for
        a predictor's store). Returns its outputs, which a graph owns until
        its next replay."""
        key = ("prefill", cache_id(cache), kv_range, win_range, bool(pin), self.projection_type(), self.config,
               *((name, tuple(t.shape), t.dtype) for name, t in inputs.items()))
        return programs.run(key, lambda: self.prefill_program(cache, inputs, kv_range, win_range, pin, normalize,
                                                              no_output_token), inputs)

    def prefill_program(self, cache: dict, inputs: dict, kv_range: int, win_range: int, pin: bool, normalize,
                        no_output_token: int) -> graphs.Program:
        """A prefill wave over `cache` as a graphs.Program (surya_tpu
        recognition's prefill_fn). Static inputs, made like `inputs` on the
        cache's device: the slot state last_token, active, run and the kill
        mask [slots]; patches (uint8 rows); enc_0 to enc_6, the encoder
        layout's device_args; llm_h_idx, llm_w_idx; input_ids, img_gather
        [rows, L]; seq_lens, slot_idx, row_valid [rows]. The body: the kill,
        normalize(patches, dtype), prefill (the KV into the cache, in place),
        the new slots' state from token 0 (seed_slots). Outputs: "packed"
        [rows, 8] (pack_outputs of token 0) and the slot state."""
        dev = cache["len"].device
        x = graphs.static_inputs(inputs, dev)
        out = {"packed": torch.empty((x["input_ids"].shape[0], 8), dtype=torch.float32, device=dev),
               **{name: torch.empty_like(x[name]) for name in ("last_token", "active", "run")}}
        dtype = self.token_embed.weight.dtype

        def body():
            last_token, active = self.apply_kill(x["last_token"], x["active"], x["kill"])
            tok, score, bbox = self.prefill(
                cache, normalize(x["patches"], dtype), tuple(x[f"enc_{i}"] for i in range(7)), x["llm_h_idx"],
                x["llm_w_idx"], x["input_ids"], x["img_gather"], x["seq_lens"], x["slot_idx"], kv_range, win_range)
            state = self.seed_slots(last_token, active, x["run"], tok, x["slot_idx"], x["row_valid"], pin,
                                    no_output_token)
            out["packed"].copy_(pack_outputs(tok, score, bbox))
            for name, t in zip(("last_token", "active", "run"), state):
                out[name].copy_(t)

        return graphs.Program(x, out, body)

    def decode_chunk(self, cache: dict, last_token, active, num_steps: int, run=None,
                     repeat_window: int = 0, pin_decode: bool = False):
        """Up to num_steps greedy decode steps; the loop exits once no slot
        is active. The plain version of ``launch_chunk`` (the eager loop,
        the cond read on the host after each step) on any device.

        A slot stops when it emits EOS/PAD (the token is still recorded); with
        ``pin_decode`` only the host stops it. With ``run``/``repeat_window``
        a slot also stops after repeat_window identical tokens in a row.
        Returns (tokens [B, K], scores [B, K], bboxes [B, K, 6], last_token,
        active, run); the cache is updated in place."""
        outputs, _ = self.launch_chunk(cache, last_token, active, num_steps, run, repeat_window, pin_decode,
                                       graphs.EagerLoops())
        return outputs

    def launch_chunk(self, cache: dict, last_token, active, num_steps: int, run, repeat_window: int,
                     pin_decode: bool, loops) -> tuple:
        """decode_chunk through `loops` (a predictor's store: CUDA graphs
        on the card), without waiting: returns (its outputs, which a graph
        owns until its next replay, and common.graphs.Ran)."""
        run = run if run is not None else torch.zeros_like(last_token)
        key = ("decode_chunk", cache_id(cache), last_token.shape[0], num_steps, bool(pin_decode), repeat_window,
               self.projection_type(), self.config)
        return loops.run(key, lambda: self.chunk_loop(cache, last_token.shape[0], num_steps, repeat_window,
                                                      pin_decode),
                         {"last_token": last_token, "active": active, "run": run})

    def chunk_loop(self, cache: dict, n_slots: int, num_steps: int, repeat_window: int,
                   pin_decode: bool) -> graphs.Loop:
        """The decode chunk over `cache` as a graphs.Loop: static inputs
        last_token, active and run [n_slots]; begin zeroes the chunk
        buffers (so that commit_chunk writes the same bytes however many
        steps ran) and takes the cache lengths (and, for a decoder with
        convolution state, a copy of that state, which the steps roll);
        step i is the embedding, decode_step_chunked and decode_step_update;
        the cond is any(active); end commits the chunk (and writes the
        rolled state back). Outputs: decode_chunk's."""
        dev = cache["len"].device
        state = {"last_token": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
                 "active": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
                 "run": torch.zeros((n_slots,), dtype=torch.int32, device=dev)}
        last_token, active, run = state.values()
        bufs = self.chunk_buffers(last_token, self.config.decoder.num_key_value_heads, num_steps)
        tokens_buf, scores_buf, bbox_buf, chunk_k, chunk_v, advance = bufs
        base_len = torch.zeros_like(cache["len"])
        pred = torch.zeros((), dtype=torch.bool, device=dev)
        # the slots' convolution state, rolled by the steps (lfm2_decoder)
        conv = {"conv_state": torch.empty_like(cache["conv"])} if "conv" in cache else {}

        def begin():
            tokens_buf.fill_(self.config.pad_token_id)
            for buf in (scores_buf, bbox_buf, chunk_k, chunk_v, advance):
                buf.zero_()
            base_len.copy_(cache["len"])
            if conv:
                conv["conv_state"].copy_(cache["conv"])
            pred.copy_(active.any())

        def step(i: int):
            emb = self.token_embed(last_token.long())
            hidden = self.decoder.decode_step_chunked(cache, chunk_k, chunk_v, emb, i, base_len, **conv)
            for dst, src in zip((last_token, active, run), self.decode_step_update(
                    hidden, i, bufs, last_token, active, run, repeat_window, pin_decode)):
                dst.copy_(src)
            pred.copy_(active.any())

        def end():
            qwen_decoder.commit_chunk(cache, chunk_k, chunk_v, base_len, advance)
            if conv:
                cache["conv"].copy_(conv["conv_state"])

        return graphs.Loop(num_steps, state, (tokens_buf, scores_buf, bbox_buf, last_token, active, run), pred,
                           begin, step, end)

    def chunk_buffers(self, last_token, n_kv_heads: int, num_steps: int) -> tuple:
        """A decode chunk's buffers over last_token's B slots, on its device:
        (tokens [B, K] pad, scores [B, K], bboxes [B, K, 6], chunk_k and
        chunk_v [cache layers, B, n_kv_heads, K, head_dim], advance [B])."""
        cfg, dec = self.config, self.config.decoder
        B, K, dev = last_token.shape[0], num_steps, last_token.device
        chunk_k = torch.zeros((dec.cache_layers, B, n_kv_heads, K, dec.head_dim),
                              dtype=self.token_embed.weight.dtype, device=dev)
        return (
            torch.full((B, K), cfg.pad_token_id, dtype=torch.int32, device=dev),
            torch.zeros((B, K), dtype=torch.float32, device=dev),
            torch.zeros((B, K, 6), dtype=torch.int32, device=dev),
            chunk_k,
            torch.zeros_like(chunk_k),
            torch.zeros((B,), dtype=torch.int32, device=dev),
        )

    def decode_step_update(self, hidden, step: int, bufs: tuple, last_token, active, run,
                           repeat_window: int, pin_decode: bool):
        """One decode step's sampling and slot state (decode_chunk's stop
        policy): the step's column of bufs (chunk_buffers) written for the
        active slots, advance counted in place. Returns (last_token, active,
        run) for the next step."""
        cfg = self.config
        pad = cfg.pad_token_id
        tokens_buf, scores_buf, bbox_buf, _, _, advance = bufs
        token, score, bbox = self.sample_greedy(hidden)
        done = (token == cfg.eos_token_id) | (token == pad)
        tokens_buf[:, step] = torch.where(active, token, pad)
        scores_buf[:, step] = torch.where(active & ~done, score, 0.0)
        bbox_buf[:, step] = torch.where(active[:, None], bbox, 0)
        advance += active.to(torch.int32)
        next_active = active if pin_decode else active & ~done
        run = torch.where(active, torch.where(token == last_token, run + 1, 1), run)
        if repeat_window:
            next_active = next_active & (run < repeat_window)
        return torch.where(next_active, token, pad), next_active, run


def pack_outputs(tokens, scores, bboxes):
    """tokens/scores/bboxes -> one float32 array [..., 8], fetched in one copy."""
    return torch.cat([tokens.float()[..., None], scores[..., None], bboxes.float()], dim=-1)


def cache_id(cache: dict) -> tuple:
    """What a decode chunk's or a prefill's graph keys a slot cache by: the device, dtype,
    shape and address of each of its tensors (the graph reads them there)."""
    return tuple((name, t.device, t.dtype, tuple(t.shape), t.data_ptr()) for name, t in sorted(cache.items()))


def mesh_cache_id(cache: dict, mesh) -> tuple:
    """cache_id of a sharded cache: every shard's entries, in mesh order."""
    return tuple(itertools.chain.from_iterable(cache_id(qwen_decoder.shard_view(cache, dm)) for dm in mesh.coords()))


class MeshedFoundation:
    """The foundation model on a mesh: surya_tpu foundation's prefill
    (_sharded_encode_embed included) and decode_chunk with a mesh. Shard
    (d, m) runs data shard d's rows (prefill rows, cache slots: split_sizes
    over the data axis) on mesh.device(d, m), with that device's replica of
    the model (parallel/mesh.Placement) and its decoder shard
    (ShardedDecoder): every model shard of a data row embeds, samples and
    keeps the row's slot state itself, as every device of the JAX package's
    SPMD program does. Per-shard values are dicts {(d, m): tensor}."""

    def __init__(self, model: FoundationModel, mesh):
        if model.config.decoder.model_type != "qwen2":
            lfm2_decoder.check_supported(mesh=mesh)
        self.mesh = mesh
        self.config = model.config
        self.placement = Placement(model, mesh)
        self.decoder = qwen_decoder.ShardedDecoder(self.placement)

    def model(self, dm) -> FoundationModel:
        return self.placement.model(*dm)

    def encode_embed(self, inputs: dict, kv_range: int, win_range: int, sharded: bool) -> dict:
        """Prompt embeddings {(d, m): [rows_d, L, hidden]}. inputs[(d, m)]:
        (patches, enc_args, llm_h_idx, llm_w_idx, input_ids, img_gather) on
        the shard's device. sharded (the data-sharded encoder): each data
        shard's inputs are its own packed plan and rows, so it encodes only
        its rows' images, with the single-device K1, and its <IMAGE> gather
        is local to it. Otherwise (one data row) every shard encodes the
        whole batch, the attention through K1-mesh."""
        if sharded:
            img = {dm: self.model(dm).encode_images(*args[:4], kv_range, win_range) for dm, args in inputs.items()}
        else:
            tokens = qwen_encoder.encode_on_mesh(
                {dm: self.model(dm).vision_encoder for dm in inputs},
                {dm: (args[0], *args[1]) for dm, args in inputs.items()}, kv_range, win_range, self.mesh,
            )
            img = {dm: tokens[dm] + self.model(dm).img_h_embed(args[2].long()) + self.model(dm).img_w_embed(args[3].long())
                   for dm, args in inputs.items()}
        return {dm: self.model(dm).embed_prompt_tokens(args[4], args[5], img[dm]) for dm, args in inputs.items()}

    def prefill(self, cache: dict, inputs: dict, seq_lens: dict, sources: dict, kv_range: int, win_range: int,
                sharded: bool) -> dict:
        """Encode, embed, decoder prefill, KV into the sharded cache (in
        place), token 0. seq_lens {(d, m): [rows_d]}; sources {(t, m): [slots_t]}
        on (t, m)'s device: the row of the wave whose KV each slot of data
        shard t takes, -1 for none (slot_sources). Returns {(d, m): (token,
        score, bbox)} over data shard d's rows."""
        embeds = self.encode_embed(inputs, kv_range, win_range, sharded)
        new_k, new_v, last = self.decoder.prefill(embeds, seq_lens)
        self.merge_prefill(cache, new_k, new_v, seq_lens, sources)
        return {dm: self.model(dm).sample_greedy(h) for dm, h in last.items()}

    def row_sources(self, sources: dict, seq_lens: dict):
        """For each data shard d of the rows and each shard (t, m) of the
        slots: (the local row of d that each slot of t takes, and where it
        takes one: the source lies in d's rows), on (t, m)'s device."""
        lo = 0
        for d in range(self.mesh.n_data):
            n = seq_lens[d, 0].shape[0]
            for tm, src in sources.items():
                local = src - lo
                yield d, tm, local, (local >= 0) & (local < n)
            lo += n

    def merge_prefill(self, cache: dict, new_k: Sharded, new_v: Sharded, seq_lens: dict, sources: dict) -> None:
        """qwen_decoder.merge_prefill on the sharded cache, by slot: every
        slot of shard (t, m) whose source row lies in data shard d takes its
        KV rows (model shard m's kv heads, from model shard m) and length,
        the others keep theirs (qwen_decoder.merge_prefill_slots). Every
        pair of shards is visited, so the shapes are static whatever the
        wave's slots."""
        for d, (t, m), rows, take in self.row_sources(sources, seq_lens):
            dev = self.mesh.device(t, m)
            qwen_decoder.merge_prefill_slots(qwen_decoder.shard_view(cache, (t, m)), new_k[d, m].to(dev),
                                             new_v[d, m].to(dev), seq_lens[d, m].to(dev), rows, take)

    def launch_prefill(self, cache: dict, inputs: dict, kv_range: int, win_range: int, sharded: bool, pin: bool,
                       normalize, no_output_token: int, programs) -> dict:
        """prefill_program through `programs` (a predictor's store: one CUDA
        graph over every shard where they all lie on one card; the plain
        version is graphs.EagerPrograms), keyed as FoundationModel.
        launch_prefill keys it, by every shard's cache (mesh_cache_id), and by
        the mesh's shape and `sharded`. inputs {(d, m): {name: tensor}}
        (prefill_program's). Returns its outputs, which a graph owns until its
        next replay."""
        mesh = self.mesh
        flat = {f"{name}/{d},{m}": t for (d, m), group in inputs.items() for name, t in group.items()}
        key = ("meshed_prefill", mesh_cache_id(cache, mesh), (mesh.n_data, mesh.n_model), kv_range, win_range,
               bool(sharded), bool(pin), self.model((0, 0)).projection_type(),
               self.config, *((name, tuple(t.shape), t.dtype) for name, t in flat.items()))
        return programs.run(key, lambda: self.prefill_program(cache, inputs, kv_range, win_range, sharded, pin,
                                                              normalize, no_output_token), flat)

    def prefill_program(self, cache: dict, inputs: dict, kv_range: int, win_range: int, sharded: bool, pin: bool,
                        normalize, no_output_token: int) -> graphs.Program:
        """A prefill wave over the sharded cache as a graphs.Program
        (surya_tpu recognition's prefill_fn with a mesh). Static inputs
        "name/d,m" on shard (d, m)'s device, made like inputs[d, m][name]:
        the slot state last_token, active, run, the kill mask and each slot's
        "source" row (slot_sources) over data shard d's slots; patches
        (uint8 rows), enc_0 to enc_6 (the encoder layout's device_args),
        llm_h_idx, llm_w_idx (data shard d's plan when sharded, else the
        whole wave's); input_ids, img_gather, seq_lens of data shard d's
        rows. The body: the kill, normalize(patches, dtype), prefill (the KV
        into the sharded cache, in place), every slot's state from token 0
        of its source row (seed_slot_sources). Outputs: "packed" [rows, 8]
        on the mesh's first device (pack_outputs of token 0, joined from
        each data shard's first model shard), and the slot state
        "last_token", "active", "run", each {(d, m): tensor}."""
        mesh = self.mesh
        x = {dm: {name: torch.empty(t.shape, dtype=t.dtype, device=mesh.device(*dm)) for name, t in group.items()}
             for dm, group in inputs.items()}
        rows = sum(x[d, 0]["input_ids"].shape[0] for d in range(mesh.n_data))
        out = {"packed": torch.empty((rows, 8), dtype=torch.float32, device=mesh.first),
               **{name: {dm: torch.empty_like(v[name]) for dm, v in x.items()} for name in ("last_token", "active",
                                                                                           "run")}}
        dtype = self.model((0, 0)).token_embed.weight.dtype

        def body():
            state = {dm: (*self.model(dm).apply_kill(v["last_token"], v["active"], v["kill"]), v["run"])
                     for dm, v in x.items()}
            enc = {dm: (normalize(v["patches"], dtype), tuple(v[f"enc_{i}"] for i in range(7)), v["llm_h_idx"],
                        v["llm_w_idx"], v["input_ids"], v["img_gather"]) for dm, v in x.items()}
            seq_lens = {dm: v["seq_lens"] for dm, v in x.items()}
            sources = {dm: v["source"] for dm, v in x.items()}
            sampled = self.prefill(cache, enc, seq_lens, sources, kv_range, win_range, sharded)
            out["packed"].copy_(gather_rows([pack_outputs(*sampled[d, 0]) for d in range(mesh.n_data)], mesh.first))
            for d, (t, m), local, take in self.row_sources(sources, seq_lens):
                state[t, m] = self.model((t, m)).seed_slot_sources(
                    *state[t, m], sampled[d, m][0].to(mesh.device(t, m)), local, take, pin, no_output_token)
            for dm, values in state.items():
                for name, value in zip(("last_token", "active", "run"), values):
                    out[name][dm].copy_(value)

        return graphs.Program({f"{name}/{d},{m}": t for (d, m), v in x.items() for name, t in v.items()}, out, body)

    def launch_chunk(self, cache: dict, last_token: dict, active: dict, num_steps: int, run: dict,
                     repeat_window: int, pin_decode: bool, loops) -> tuple:
        """FoundationModel.decode_chunk on the sharded cache, each shard
        over its slots with a chunk buffer of its own, through `loops` (a
        predictor's store: CUDA graphs where every shard lies on one card;
        the plain version is graphs.EagerLoops), without waiting, keyed by every
        shard's cache (mesh_cache_id), the mesh's shape, the slots a shard,
        num_steps, pin, repeat_window, the decoder's projection type and the
        config. Returns ((tokens, scores, bboxes, last_token, active, run),
        each {(d, m): ...}, which a graph owns until its next replay, and
        common.graphs.Ran)."""
        mesh = self.mesh
        key = ("meshed_decode_chunk", mesh_cache_id(cache, mesh), (mesh.n_data, mesh.n_model),
               tuple(last_token[dm].shape[0] for dm in mesh.coords()), num_steps, bool(pin_decode), repeat_window,
               self.model((0, 0)).projection_type(), self.config)
        inputs = {f"{name}/{d},{m}": x[d, m] for name, x in (("last_token", last_token), ("active", active),
                                                            ("run", run)) for d, m in mesh.coords()}
        return loops.run(key, lambda: self.chunk_loop(cache, {dm: t.shape[0] for dm, t in last_token.items()},
                                                      num_steps, repeat_window, pin_decode), inputs)

    def chunk_loop(self, cache: dict, n_slots: dict, num_steps: int, repeat_window: int,
                   pin_decode: bool) -> graphs.Loop:
        """The meshed decode chunk as a graphs.Loop, FoundationModel.chunk_loop
        on every shard: static inputs "last_token/d,m", "active/d,m" and
        "run/d,m" [n_slots[d, m]] on each shard's device; begin zeroes every
        shard's chunk buffers and takes its base lengths; step i is every
        shard's embedding, the sharded decode_step_chunked (its cross-shard
        sums included) and each shard's decode_step_update; the cond is
        any(active) over all shards, reduced on the mesh's first device; end
        commits every shard's chunk. Outputs: launch_chunk's."""
        mesh, first = self.mesh, self.mesh.first
        state = {name: {} for name in ("last_token", "active", "run")}
        inputs = {}
        for dm, n in n_slots.items():
            dev = mesh.device(*dm)
            for name, dtype in (("last_token", torch.int32), ("active", torch.bool), ("run", torch.int32)):
                state[name][dm] = inputs[f"{name}/{dm[0]},{dm[1]}"] = torch.zeros((n,), dtype=dtype, device=dev)
        last_token, active, run = state.values()
        bufs = {dm: self.model(dm).chunk_buffers(lt, self.decoder.shards[dm].n_kv_heads, num_steps)
                for dm, lt in last_token.items()}
        base_len = {dm: torch.zeros_like(cache["len"][dm]) for dm in n_slots}
        chunks = [Sharded(mesh, qwen_decoder.CHUNK_SPEC, {dm: b[i] for dm, b in bufs.items()}) for i in (3, 4)]
        lengths = Sharded(mesh, qwen_decoder.ROWS_SPEC, base_len)
        pred = torch.zeros((), dtype=torch.bool, device=first)
        pad = self.config.pad_token_id

        def any_active():
            pred.copy_(torch.stack([a.any().to(first) for a in active.values()]).any())

        def begin():
            for dm, (tokens_buf, *rest) in bufs.items():
                tokens_buf.fill_(pad)
                for buf in rest:
                    buf.zero_()
                base_len[dm].copy_(cache["len"][dm])
            any_active()

        def step(i: int):
            emb = {dm: self.model(dm).token_embed(lt.long()) for dm, lt in last_token.items()}
            hidden = self.decoder.decode_step_chunked(cache, *chunks, emb, i, lengths)
            for dm, h in hidden.items():
                for dst, src in zip((last_token[dm], active[dm], run[dm]), self.model(dm).decode_step_update(
                        h, i, bufs[dm], last_token[dm], active[dm], run[dm], repeat_window, pin_decode)):
                    dst.copy_(src)
            any_active()

        def end():
            for dm, (_, _, _, chunk_k, chunk_v, advance) in bufs.items():
                qwen_decoder.commit_chunk(qwen_decoder.shard_view(cache, dm), chunk_k, chunk_v, base_len[dm],
                                          advance)

        outputs = tuple({dm: b[i] for dm, b in bufs.items()} for i in range(3)) + (last_token, active, run)
        return graphs.Loop(num_steps, inputs, outputs, pred, begin, step, end)


def slot_sources(slot_idx: np.ndarray, row_valid: np.ndarray, n_slots: int) -> np.ndarray:
    """Each cache slot's source row in a prefill wave (the valid row that
    fills it), -1 for a slot that no row fills: the inverse of slot_idx,
    for MeshedFoundation.prefill. The padding rows fill nothing (the JAX
    package writes them into the trash slot, which nothing reads)."""
    src = np.full((n_slots,), -1, np.int64)
    rows = np.flatnonzero(row_valid)
    src[slot_idx[rows]] = rows
    return src


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(tensors, config: FoundationConfig) -> dict:
    """The upstream torch checkpoint as surya_tpu foundation.init_params'
    pytree (numpy leaves, JAX layout; surya_tpu foundation.convert_torch).
    ``lm_head.weight`` is tied to the token embedding; ``lm_head.bias`` is
    optional (zeros without it)."""
    from surya_tpu_torch.common.weights import TensorBag

    bag = tensors if isinstance(tensors, TensorBag) else TensorBag(tensors)
    params = {
        "vision_encoder": qwen_encoder.convert_torch(bag, config.encoder, "vision_encoder"),
        "decoder": decoder_kind(config.decoder)[1].convert_torch(bag, config.decoder, "decoder"),
        "token_embed": bag.embedding("embedder.token_embed"),
        "img_w_embed": bag.embedding("img_w_embed"),
        "img_h_embed": bag.embedding("img_h_embed"),
        "bbox_head": bag.linear("bbox_head"),
    }
    if "lm_head.bias" in bag.tensors:
        params["lm_head_bias"] = bag.raw("lm_head.bias")
    else:
        params["lm_head_bias"] = np.zeros((config.vocab_size,), np.float32)
    bag.used.add("lm_head.weight")  # tied to the embedding
    bag.warn_unused("foundation")
    return params
