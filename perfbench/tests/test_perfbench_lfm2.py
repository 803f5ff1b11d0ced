"""The lfm2_8b_a1b_ocr pieces on the CPU: its counts against cases worked
out by hand, and whole runs of its system at a tiny width with every kind
of layer, in a throwaway checkout that adds the configuration, the limits
and the cell as files and entries only."""

import json

import pytest

from perfbench.counts import lfm2, ocr
from perfbench.tests import tiny

SEED = 2**31 + 31
# a language model of 1 dense and 1 sparse layer, conv then attention, 8 wide,
# 2/1 heads, 4 experts of width 4, 2 a token
LM = {"conv_L_cache": 3, "conv_bias": False, "hidden_size": 8, "intermediate_size": 12,
      "layer_types": ["conv", "full_attention"], "max_position_embeddings": 4096, "model_type": "lfm2_moe",
      "moe_intermediate_size": 4, "norm_eps": 1e-05, "norm_topk_prob": True, "num_attention_heads": 2,
      "num_dense_layers": 1, "num_experts": 4, "num_experts_per_tok": 2, "num_hidden_layers": 2,
      "num_key_value_heads": 1, "rope_theta": 1000000, "routed_scaling_factor": 1, "use_expert_bias": True,
      "vocab_size": 65536}


def test_token_flops_by_hand():
    # conv: 2 (3*64 + 64) + 2*3*8; dense: 2*3*8*12; attention: 2 (2*64 + 2*8*4); sparse: 2*8*4 + 2 * 2*3*8*4
    assert lfm2.token_flops(LM) == (2 * 256 + 48) + 576 + 2 * (128 + 64) + (64 + 2 * 192)


def test_line_work_adds_the_decoder_to_the_encoder_and_head():
    ocr_cfg = {"vocab_size": 10, "encoder": {"depth": 1, "hidden_size": 4, "intermediate_size": 8, "num_heads": 2,
                                             "patch_size": 2, "spatial_merge_size": 2, "window_size": 4,
                                             "out_hidden_size": 8, "fullatt_block_indexes": [0]}}
    cfg = dict(ocr_cfg, decoder=LM)
    w = lfm2.line_work(cfg, (2, 4), prompt_len=3, served=3)
    # one attention layer, width 8, kv width 4
    assert w["k2_flops"] == 4 * 6 * 8 and w["k2_bytes"] == 3 * (16 + 8) * 2
    assert w["k3_flops"] == 4 * 4 * 8 + 4 * 5 * 8
    assert w["k3_bytes"] == ((4 * 8 + 16) + (5 * 8 + 16)) * 2
    empty = {"hidden_size": 8, "intermediate_size": 0, "num_hidden_layers": 0, "num_attention_heads": 1,
             "num_key_value_heads": 1}
    base = ocr.line_work(dict(ocr_cfg, decoder=empty), (2, 4), 3, 3)
    assert w["k1_flops"] == base["k1_flops"]
    assert w["model_flops"] == base["model_flops"] + 5 * lfm2.token_flops(LM) + w["k2_flops"] + w["k3_flops"]


def test_moe_work_reads_each_hit_expert_once():
    d = {"decoder": LM}
    assert lfm2.expert_bytes(LM) == 3 * 8 * 4 * 2
    w = lfm2.moe_work(d, rows=10, experts_hit=3)
    assert w["moe_flops"] == 10 * 2 * 3 * 8 * 4
    assert w["moe_bytes"] == 3 * 192 + 10 * (16 + 8) * 2
    # the published widths: 22.0 MB an expert
    assert lfm2.expert_bytes({"hidden_size": 2048, "moe_intermediate_size": 1792}) == 22_020_096


TINY = {
    "name": "tiny_lfm2", "system": "ocr_lfm2", "rate_metric": "ocr_pages_per_s", "source": "tiny",
    **dict(LM, hidden_size=96, intermediate_size=192, moe_intermediate_size=32, num_attention_heads=4,
           num_key_value_heads=2, num_experts=8, num_experts_per_tok=4, num_hidden_layers=4, num_dense_layers=1,
           layer_types=["conv", "full_attention", "conv", "full_attention"]),
    "deployment": "tiny",
    "model": {"dtype": "float32", "vocab_size": 65825, "image_embed_encoding_size": 1024,
              "image_embed_encoding_multiplier": 256, "line_image_size": [1024, 256],
              "encoder": dict(tiny.OCR["model"]["encoder"]), "tokens": tiny.OCR["model"]["tokens"]},
    "serving": {"slots": 8, "decode_chunk": 12},
    "weights": {"seed": 9, "scale": "fan_in"},
}
CELL = "tiny.ocr_lfm2.lines"
# float32 on the CPU: the program reads within about 1e-5 of the reference; a
# routing margin under 1e-6 is one that float32's order of sums can turn over
LIMITS = {"limits": {"crop_diff": 0, "bad_tokens": 0, "route_ties": 0},
          "tolerances": {"token": 1e-4, "route_band": 1e-6}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.checkout(tmp_path_factory.mktemp("perfbench_lfm2"))
    (root / "perfbench" / "configs" / "tiny_lfm2.json").write_text(json.dumps(TINY))
    (root / "perfbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_lfm2", "source": "tiny", "file": "perfbench/configs/tiny_lfm2.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tiny_lfm2", "traffic": "tiny_lines", "chips": 1, "why": "tiny"})
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ocr_lfm2.lines40" in next((r.get("workloads", []) for r in real["end_to_end"] + real["per_layer"]
                                       if r["name"] == m["name"]), []):
            m["workloads"] = m.get("workloads", []) + [CELL]
    for name in ("moe_gemm_roofline.ocr", "moe_load_skew.ocr"):
        entry = next(m for m in real["per_layer"] if m["name"] == name)
        if not any(m["name"] == name for m in bench["per_layer"]):
            bench["per_layer"].append(dict(entry, workloads=[CELL]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_sound_run_is_correct_and_reads_its_metrics(root):
    out = tiny.run_cell(root, CELL, SEED, trace=1)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and set(out["checks"]) == {"crop_diff", "bad_tokens", "route_ties"}
    skew = out["metrics"]["moe_load_skew.ocr"]["value"]
    assert 1.0 <= skew <= TINY["num_experts"]
    assert 0 < out["metrics"]["decode_row_use.ocr"]["value"] <= 100
    # no device was traced: the roofline has nothing to read, and is left out
    assert "moe_gemm_roofline.ocr" not in out["metrics"]


def test_control_is_not_correct(root):
    out = tiny.run_cell(root, CELL, SEED, control=1)
    assert not out["correct"], out["checks"]
    assert out["checks"]["bad_tokens"]["value"] > 0
