"""The counts against cases worked out by hand."""

import pytest

from perfbench import peaks
from perfbench.counts import layout, ocr

# one block (full attention), 4 wide, 2 heads, patch 2, cells of 2x2 patches,
# windows of 1 cell; a decoder of 1 layer, 4 wide, 2/1 heads, vocabulary 10
OCR = {"vocab_size": 10,
       "encoder": {"depth": 1, "hidden_size": 4, "intermediate_size": 8, "num_heads": 2, "patch_size": 2,
                   "spatial_merge_size": 2, "window_size": 4, "out_hidden_size": 4, "fullatt_block_indexes": [0]},
       "decoder": {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
                   "num_key_value_heads": 1}}


def test_line_work_by_hand():
    w = ocr.line_work(OCR, (2, 4), prompt_len=3, served=3)  # 8 patches, 2 cells
    # encoder: patch embed 2*8*12*4; qkv, proj, MLP 2*8*(3*16 + 16 + 3*4*8); attention 4*8*8*4;
    # merger 2*2*16*(16 + 4)
    assert w["k1_flops"] == 4 * 64 * 4
    assert w["k1_bytes"] == 4 * 8 * 4 * 2
    enc = 2 * 8 * 12 * 4 + 2 * 8 * (48 + 16 + 96) + 4 * 64 * 4 + 2 * 2 * 16 * 20
    # decoder: per token 2*(2*16 + 2*4*2 + 3*4*8) = 2*144; kv width 2
    per_token = 2 * (32 + 16 + 96)
    assert w["k2_flops"] == 4 * 6 * 4  # 3*4/2 causal pairs
    assert w["k2_bytes"] == 3 * (8 + 4) * 2
    prefill = 3 * per_token + 4 * 6 * 4 + 2 * 4 * 10
    # decode steps for tokens 1 and 2 over 4 and 5 keys
    assert w["k3_flops"] == 4 * 4 * 4 + 4 * 5 * 4
    assert w["k3_bytes"] == ((4 * 4 + 8) + (5 * 4 + 8)) * 2
    decode = 2 * (per_token + 2 * 4 * 10) + w["k3_flops"]
    assert w["model_flops"] == enc + prefill + decode


def test_windows_split_the_grid():
    cfg = {"encoder": dict(OCR["encoder"], window_size=4)}
    assert list(ocr._windows((6, 4), cfg)) == [4, 4, 4, 4, 4, 4]
    cfg = {"encoder": dict(OCR["encoder"], window_size=8)}
    assert list(ocr._windows((6, 4), cfg)) == [16, 8]


def test_tile_work_by_hand():
    cfg = {"label_count": 3,
           "encoder": {"image_size": [8, 8], "patch_size": 4, "embed_dim": 2, "depths": [1], "num_heads": [1],
                       "num_kv_heads": [1], "window_size": 2},
           "decoder": {"hidden_size": 2, "intermediate_size": 4, "num_hidden_layers": 1, "num_attention_heads": 1,
                       "num_key_value_heads": 1, "encoder_hidden_size": 2}}
    w = layout.tile_work(cfg, steps=1)["model_flops"]
    enc = 2 * 4 * 48 * 2 + 2 * 4 * (8 + 8 + 32) + 4 * 4 * 4 * 2
    cross_kv = 2 * 4 * 2 * 4
    step = 2 * (8 + 8 + 8 + 24) + 4 * 5 * 2 + 2 * 2 * 9
    assert w == enc + cross_kv + step


def test_bound_is_the_slower_roof():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
