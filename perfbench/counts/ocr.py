"""Recognition's work, per line: the vision encoder over its patch grid,
the decoder's prefill over its prompt, and one decode step for each token
after the first (bf16: 2 bytes an element)."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16 = 2


def _windows(grid: Tuple[int, int], cfg: dict):
    """The patch count of each attention window of an image of `grid` patches."""
    e = cfg["encoder"]
    m = e["spatial_merge_size"]
    wc = e["window_size"] // m // e["patch_size"]
    ch, cw = grid[0] // m, grid[1] // m
    for r in range(0, ch, wc):
        for c in range(0, cw, wc):
            yield min(wc, ch - r) * min(wc, cw - c) * m * m


def line_work(cfg: dict, grid: Tuple[int, int], prompt_len: int, served: int) -> Dict[str, float]:
    """One line: {"model_flops", "k1_flops", "k1_bytes", "k2_flops",
    "k2_bytes", "k3_flops", "k3_bytes"}."""
    e, d = cfg["encoder"], cfg["decoder"]
    n = grid[0] * grid[1]
    eh, ei = e["hidden_size"], e["intermediate_size"]
    m2 = e["spatial_merge_size"] ** 2
    pdim = 3 * e["patch_size"] ** 2
    window_pairs = sum(w * w for w in _windows(grid, cfg))
    full = len(e["fullatt_block_indexes"])
    pairs = full * n * n + (e["depth"] - full) * window_pairs
    k1_flops = 4 * pairs * eh  # Q K^T and P V over every head
    k1_bytes = e["depth"] * 4 * n * eh * BF16  # q, k, v read, o written
    enc = 2 * n * pdim * eh + e["depth"] * 2 * n * (3 * eh * eh + eh * eh + 3 * eh * ei) + k1_flops
    enc += 2 * (n // m2) * (m2 * eh) * (m2 * eh + e["out_hidden_size"])
    h, inter, L, V = d["hidden_size"], d["intermediate_size"], d["num_hidden_layers"], cfg["vocab_size"]
    hd = h // d["num_attention_heads"]
    kv = d["num_key_value_heads"] * hd
    per_token = L * 2 * (2 * h * h + 2 * h * kv + 3 * h * inter)
    P = prompt_len
    k2_flops = L * 4 * (P * (P + 1) // 2) * h
    k2_bytes = L * P * (2 * h + 2 * kv) * BF16
    prefill = P * per_token + k2_flops + 2 * h * V
    steps = range(1, served)  # token j > 0 is chosen by a decode step over P + j keys
    k3_flops = sum(L * 4 * (P + j) * h for j in steps)
    k3_bytes = sum(L * ((P + j) * 2 * kv + 2 * h) * BF16 for j in steps)
    decode = len(steps) * (per_token + 2 * h * V) + k3_flops
    return {"model_flops": enc + prefill + decode, "k1_flops": k1_flops, "k1_bytes": k1_bytes,
            "k2_flops": k2_flops, "k2_bytes": k2_bytes, "k3_flops": k3_flops, "k3_bytes": k3_bytes}


def total(works: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v
    return out
