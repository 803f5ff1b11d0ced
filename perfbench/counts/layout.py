"""Layout's work, per tile: DonutSwin over the tile, the cross-attention
keys and values of its tokens, and one ADETR step for each box."""

from __future__ import annotations

from typing import Dict


def tile_work(cfg: dict, steps: int) -> Dict[str, float]:
    e, d = cfg["encoder"], cfg["decoder"]
    gh, gw = e["image_size"][0] // e["patch_size"], e["image_size"][1] // e["patch_size"]
    win = e["window_size"] ** 2
    flops = 2 * gh * gw * 3 * e["patch_size"] ** 2 * e["embed_dim"]
    for s, depth in enumerate(e["depths"]):
        dim = e["embed_dim"] * 2**s
        n = (gh >> s) * (gw >> s)
        kv = dim * e["num_kv_heads"][s] // e["num_heads"][s]
        block = 2 * n * (2 * dim * dim + 2 * dim * kv + 8 * dim * dim) + 4 * n * min(win, n) * dim
        flops += depth * block
        if s < len(e["depths"]) - 1:
            flops += 2 * (n // 4) * 4 * dim * 2 * dim
    tokens = (gh >> (len(e["depths"]) - 1)) * (gw >> (len(e["depths"]) - 1))
    h, inter, L = d["hidden_size"], d["intermediate_size"], d["num_hidden_layers"]
    kvw = d["num_key_value_heads"] * h // d["num_attention_heads"]
    flops += L * 2 * tokens * d["encoder_hidden_size"] * 2 * kvw  # cross K and V, once a tile
    for i in range(steps):
        per = L * 2 * (2 * h * h + 2 * h * h + 2 * h * kvw + 3 * h * inter)  # cross q, o; self q, k, v, o; MLP
        per += L * 4 * (tokens + i + 1) * h  # cross and self attention
        per += 2 * h * (cfg["label_count"] + 6)
        flops += per
    return {"model_flops": float(flops)}
