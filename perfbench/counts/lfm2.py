"""Recognition's work with LFM2-8B-A1B's language model as the decoder
(configuration lfm2_8b_a1b_ocr), per line: the vision encoder and the
token head as counts/ocr.py counts them, the decoder's prefill over the
prompt and one decode step for each token after the first, at the active
parameters (``num_experts_per_tok`` experts a token); and the sparse
layers' expert GEMMs from the program's own counters (bf16: 2 bytes an
element)."""

from __future__ import annotations

from typing import Dict, Tuple

from perfbench.counts import ocr

BF16 = 2


def _decoder(cfg: dict) -> dict:
    return cfg["decoder"]


def token_flops(d: dict) -> float:
    """One token's decoder FLOPs outside attention's scores: the projections
    of every layer, the convolution taps, the dense feed-forwards, and the
    router and the chosen experts of every sparse layer."""
    h, hd = d["hidden_size"], d["hidden_size"] // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    n_attn = d["layer_types"].count("full_attention")
    n_conv = len(d["layer_types"]) - n_attn
    n_dense = d["num_dense_layers"]
    n_sparse = d["num_hidden_layers"] - n_dense
    attn = 2 * (2 * h * h + 2 * h * kv)
    conv = 2 * (3 * h * h + h * h) + 2 * d["conv_L_cache"] * h
    dense = 2 * 3 * h * d["intermediate_size"]
    sparse = 2 * h * d["num_experts"] + d["num_experts_per_tok"] * 2 * 3 * h * d["moe_intermediate_size"]
    return n_attn * attn + n_conv * conv + n_dense * dense + n_sparse * sparse


def line_work(cfg: dict, grid: Tuple[int, int], prompt_len: int, served: int) -> Dict[str, float]:
    """One line: {"model_flops", "k1_flops", "k1_bytes", "k2_flops",
    "k2_bytes", "k3_flops", "k3_bytes"}, as counts/ocr.line_work gives them
    for the Qwen2-style decoder."""
    d = _decoder(cfg)
    h, hd = d["hidden_size"], d["hidden_size"] // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    n_attn = d["layer_types"].count("full_attention")
    # the encoder, K1 and the token head: counts/ocr's with a decoder of no layers
    empty = {"hidden_size": h, "intermediate_size": 0, "num_hidden_layers": 0, "num_attention_heads": 1,
             "num_key_value_heads": 1}
    w = ocr.line_work(dict(cfg, decoder=empty), grid, prompt_len, served)
    P = prompt_len
    k2_flops = n_attn * 4 * (P * (P + 1) // 2) * h
    k2_bytes = n_attn * P * (2 * h + 2 * kv) * BF16
    steps = range(1, served)  # token j > 0 is chosen by a decode step over P + j keys
    k3_flops = sum(n_attn * 4 * (P + j) * h for j in steps)
    k3_bytes = sum(n_attn * ((P + j) * 2 * kv + 2 * h) * BF16 for j in steps)
    per_token = token_flops(d)
    w["model_flops"] += P * per_token + k2_flops + len(steps) * per_token + k3_flops
    w.update(k2_flops=k2_flops, k2_bytes=k2_bytes, k3_flops=k3_flops, k3_bytes=k3_bytes)
    return w


def expert_bytes(d: dict) -> int:
    """One expert's weights: w1, w3 [I, H] and w2 [H, I]."""
    return 3 * d["hidden_size"] * d["moe_intermediate_size"] * BF16


def moe_work(cfg: dict, rows: float, experts_hit: float) -> Dict[str, float]:
    """The expert GEMMs of `rows` token-expert rows over layer calls that
    hit `experts_hit` experts in all (the program's counters
    recognition.moe_rows and recognition.moe_experts_hit): {"moe_flops",
    "moe_bytes"}. Each hit expert's weights are read once a layer call, and
    a row reads its input, writes and reads its SwiGLU output and writes
    its result."""
    d = _decoder(cfg)
    h, inter = d["hidden_size"], d["moe_intermediate_size"]
    return {"moe_flops": rows * 2 * 3 * h * inter,
            "moe_bytes": experts_hit * expert_bytes(d) + rows * (2 * h + 2 * inter) * BF16}
