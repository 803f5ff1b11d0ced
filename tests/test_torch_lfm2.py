"""The lfm2_moe recognition decoder (models/lfm2_decoder.py) and its
sparse-expert layer (ops/moe.py) on the CPU, float32, at a tiny width with
every kind of layer (conv and attention, dense and sparse feed-forward),
against the plain reference in tests/lfm2_reference.py."""

import os

import pytest
import torch
import torch.nn.functional as F

import lfm2_reference as ref
from surya_tpu_torch import nn as pnn
from surya_tpu_torch.common.weights import TensorBag
from surya_tpu_torch.models import foundation, lfm2_decoder, qwen_decoder
from surya_tpu_torch.models.foundation import FoundationModel
from surya_tpu_torch.ops import decode_attn, flash, moe
from surya_tpu_torch.recognition.loader import DEFAULT_DECODER, config_from_json, random_model
from surya_tpu_torch.settings import settings as port_settings

TOL = 1e-4  # float32 on the CPU: the program's order of sums against the reference's
DECODER = dict(model_type="lfm2_moe", hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
               layer_types=["conv", "full_attention", "conv", "full_attention"], num_dense_layers=1, num_experts=8,
               num_experts_per_tok=4, norm_topk_prob=True, routed_scaling_factor=1.0, use_expert_bias=True,
               conv_L_cache=3, conv_bias=False, rope_theta=1000000.0, norm_eps=1e-5)
RAW = {"vocab_size": 65825, "eos_token_id": 256, "pad_token_id": 259, "image_token_id": 258,
       "vision_encoder": dict(depth=1, hidden_size=32, intermediate_size=64, num_heads=2, window_size=56,
                              out_hidden_size=64, fullatt_block_indexes=[0]),
       "decoder": DECODER}
PAD = RAW["pad_token_id"]


@pytest.fixture(autouse=True, scope="module")
def _no_checkpoint():
    """Random weights: no checkpoint resolves, none is fetched."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


def per_expert(state: dict) -> dict:
    """A state dict of the program's with each stacked expert tensor split
    into the checkpoint's per-expert ones (the reference's names)."""
    out = {}
    for k, v in state.items():
        if k.endswith("experts.w13"):
            inter = v.shape[1] // 2
            for e in range(v.shape[0]):
                out[f"{k[:-3]}{e}.w1.weight"], out[f"{k[:-3]}{e}.w3.weight"] = v[e, :inter], v[e, inter:]
        elif k.endswith("experts.w2"):
            for e in range(v.shape[0]):
                out[f"{k[:-2]}{e}.w2.weight"] = v[e]
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def model():
    """The foundation model with the tiny lfm2_moe decoder, float32, its
    matrices at N(0, 1 / fan_in) so that every layer passes on its input's
    spread, the expert bias at N(0, 0.02^2)."""
    m = random_model(config_from_json(RAW), "cpu", torch.float32, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for _, p in m.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5)
        for layer in m.decoder.layers:
            if layer.is_sparse:
                layer.feed_forward.expert_bias.copy_(torch.randn(8, generator=gen) * 0.02)
    return m


def reference_logits(m, embeds, fed):
    """The reference's logits over a row's embedded prompt and its fed-back tokens."""
    x = torch.cat([embeds, m.token_embed.weight[torch.tensor(fed, dtype=torch.long)]])
    return ref.forward(per_expert(m.state_dict()), DECODER, x) @ m.token_embed.weight.T + m.lm_head_bias


def prefill(m, cache, embeds, seq_lens, slots):
    *state, last = m.decoder.prefill(embeds, seq_lens, use_kernels=False)
    lfm2_decoder.merge_prefill(cache, *state, seq_lens, torch.tensor(slots))
    return m.sample_greedy(last)


def test_prefill_then_chunked_decode_match_the_full_forward(model):
    """Prefill of right-padded rows into their slots, then two decode chunks
    through the slot cache (KV and conv state), give the logits of the
    reference's one pass over each row's prompt and fed-back tokens: the
    served tokens are its first choices and their probabilities its own."""
    gen = torch.Generator().manual_seed(5)
    seq_lens = torch.tensor([9, 5, 7])
    embeds = torch.randn(3, 9, 64, generator=gen)
    cache = foundation.init_cache(model.config.decoder, 5, 32, torch.float32, "cpu")
    with torch.no_grad():
        tok, score0, _ = prefill(model, cache, embeds, seq_lens, [2, 0, 3])
        last = torch.full((5,), PAD, dtype=torch.int32)
        last[[2, 0, 3]] = tok
        active = torch.zeros(5, dtype=torch.bool)
        active[[2, 0, 3]] = True
        chunks = []
        for steps in (4, 3):
            toks, scores, _, last, active, _ = model.decode_chunk(cache, last, active, steps, pin_decode=True)
            chunks.append((toks, scores))
        assert cache["len"].tolist() == [5 + 7, 0, 9 + 7, 7 + 7, 0]
        for row, slot in enumerate([2, 0, 3]):
            served = [int(tok[row])] + [t for toks, _ in chunks for t in toks[slot].tolist()]
            P = int(seq_lens[row])
            lg = reference_logits(model, embeds[row, :P], served[:-1])[P - 1:]
            assert lg.argmax(-1).tolist() == served
            probs = torch.softmax(lg, -1).amax(-1)
            mine = torch.cat([score0[row : row + 1]] + [scores[slot] for _, scores in chunks])
            assert (probs - mine).abs().max() < TOL


def test_readmitted_slot_decodes_as_fresh(model):
    """A slot re-admitted mid-loop (its KV rows and conv state overwritten
    by a new prompt's prefill, the other slots decoding on) decodes as the
    same prompt does in a fresh cache."""
    gen = torch.Generator().manual_seed(6)
    first, second, other = (torch.randn(1, 8, 64, generator=gen) for _ in range(3))
    lens = torch.tensor([8])

    def decode(cache, last, active, steps=4):
        toks, scores, _, last, active, _ = model.decode_chunk(cache, last, active, steps, pin_decode=True)
        return toks, scores, last, active

    with torch.no_grad():
        cache = foundation.init_cache(model.config.decoder, 3, 64, torch.float32, "cpu")
        t0, _, _ = prefill(model, cache, torch.cat([first, other]), torch.tensor([8, 8]), [0, 1])
        last = torch.tensor([int(t0[0]), int(t0[1]), PAD], dtype=torch.int32)
        active = torch.tensor([True, True, False])
        _, _, last, active = decode(cache, last, active)
        # slot 0 finishes; the second prompt takes it while slot 1 decodes on
        t1, _, _ = prefill(model, cache, second, lens, [0])
        last[0] = t1[0]
        toks, scores, _, _ = decode(cache, last, active)

        fresh = foundation.init_cache(model.config.decoder, 3, 64, torch.float32, "cpu")
        f0, _, _ = prefill(model, fresh, second, lens, [0])
        assert int(f0[0]) == int(t1[0])
        ftoks, fscores, _, _ = decode(fresh, torch.tensor([int(f0[0]), PAD, PAD], dtype=torch.int32),
                                      torch.tensor([True, False, False]))
    assert toks[0].tolist() == ftoks[0].tolist()
    assert (scores[0] - fscores[0]).abs().max() < 1e-5


def _experts(gen, E=8, H=16, inter=12):
    return (torch.randn(E, H, generator=gen) / 4, torch.randn(E, 2 * inter, H, generator=gen) / 4,
            torch.randn(E, H, inter, generator=gen) / 4)


@pytest.mark.parametrize("case", ["plain", "bias changes the choice", "an expert without rows", "padding tokens"])
def test_sparse_moe_matches_the_reference(case):
    gen = torch.Generator().manual_seed(7)
    T, E, H, k = 24, 8, 16, 4
    x = torch.randn(T, H, generator=gen)
    gate, w13, w2 = _experts(gen, E, H)
    bias = torch.zeros(E)
    valid = None
    if case == "bias changes the choice":
        bias = torch.randn(E, generator=gen) * 0.3
        plain = moe.route(x, gate, torch.zeros(E), k)[0].sort(-1).values
        assert not torch.equal(plain, moe.route(x, gate, bias, k)[0].sort(-1).values)
    elif case == "an expert without rows":
        bias[5] = -10.0  # never among the top 4 of sigmoid scores in (0, 1)
    elif case == "padding tokens":
        valid = torch.arange(T) < 17
    counts = torch.zeros(3, dtype=torch.int64)
    out = moe.sparse_moe(x, gate, bias, w13, w2, k, valid=valid, counts=counts)
    W = {"f.gate.weight": gate, "f.expert_bias": bias}
    for e in range(E):
        W[f"f.experts.{e}.w1.weight"], W[f"f.experts.{e}.w3.weight"] = w13[e, :12], w13[e, 12:]
        W[f"f.experts.{e}.w2.weight"] = w2[e]
    with torch.no_grad():
        expected = ref.sparse_experts(W, "f.", x, dict(DECODER, num_experts=E))
    if valid is not None:
        expected = torch.where(valid[:, None], expected, 0.0)
    assert (out - expected).abs().max() < TOL
    assert (moe.sparse_moe_reference(x, gate, bias, w13, w2, k, valid=valid) - expected).abs().max() < TOL
    chosen = moe.route(x, gate, bias, k)[0][valid if valid is not None else slice(None)]
    per_expert = torch.bincount(chosen.reshape(-1), minlength=E)
    assert counts.tolist() == [int(per_expert.sum()), int((per_expert > 0).sum()), int(per_expert.max())]
    if case == "an expert without rows":
        assert per_expert[5] == 0 and counts[1] == E - 1


def composite(x, gate_w, expert_bias, w13, w2, top_k, norm_topk_prob=True, routed_scaling_factor=1.0, valid=None):
    """The sparse layer as the one composite it was before its glue was
    split into route, permute, swiglu and combine (the yardstick of those
    plain functions): each step's result, and the counters it added."""
    T, H = x.shape
    E, inter = w13.shape[0], w2.shape[2]
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    chosen = torch.topk(scores + expert_bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + moe.NORM_EPS)
    weights = weights * routed_scaling_factor
    flat = chosen.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(top_k), flat, E)
    order = torch.argsort(flat, stable=True)
    per_expert = torch.zeros(E + 1, dtype=torch.int64).scatter_add_(0, flat, torch.ones_like(flat))[:E]
    offs = per_expert.cumsum(0).to(torch.int32)
    rows = x[order // top_k]
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    a = F.silu(h[:, :inter]) * h[:, inter:]
    y = torch._grouped_mm(a, w2.transpose(1, 2), offs=offs)
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel()))
    out = (y[inverse].view(T, top_k, H).float() * weights[..., None]).sum(1)
    if valid is not None:
        out = torch.where(valid[:, None], out, 0.0)
    counts = [int(per_expert.sum()), int((per_expert > 0).sum()), int(per_expert.max())]
    return dict(chosen=flat.view(T, top_k), weights=weights, offs=offs, inverse=inverse, rows=rows, h=h, a=a, y=y,
                out=out.to(x.dtype), counts=counts)


GLUE_CASES = ["plain", "bias changes the choice", "an expert without rows", "padding tokens",
              "scaled, not normalised"]


def glue_case(case):
    """(x, gate, bias, w13, w2, top_k, norm_topk_prob, routed_scaling_factor,
    valid) of a glue test, 8 experts at the tiny width."""
    gen = torch.Generator().manual_seed(8)
    T, E, H = 24, 8, 16
    x = torch.randn(T, H, generator=gen)
    gate, w13, w2 = _experts(gen, E, H)
    bias, valid, norm, scale = torch.zeros(E), None, True, 1.0
    if case == "bias changes the choice":
        bias = torch.randn(E, generator=gen) * 0.3
        assert not torch.equal(moe.route(x, gate, torch.zeros(E), 4)[0], moe.route(x, gate, bias, 4)[0])
    elif case == "an expert without rows":
        bias[2] = -10.0
    elif case == "padding tokens":
        valid = torch.arange(T) % 8 < 5
    elif case == "scaled, not normalised":
        norm, scale = False, 2.5
    return x, gate, bias, w13, w2, 4, norm, scale, valid


@pytest.mark.parametrize("case", GLUE_CASES)
def test_route_matches_the_composite(case):
    """route's choices (the sentinel E for a token that is not valid) and
    weights are the composite's, exactly."""
    x, gate, bias, w13, w2, k, norm, scale, valid = glue_case(case)
    want = composite(x, gate, bias, w13, w2, k, norm, scale, valid)
    chosen, weights = moe.route(x, gate, bias, k, norm, scale, valid)
    assert torch.equal(chosen, want["chosen"])
    assert torch.equal(weights, want["weights"])


@pytest.mark.parametrize("case", GLUE_CASES)
def test_permute_matches_the_composite(case):
    """permute's offsets, each row's place, the sorted rows and the
    counters are the composite's, exactly."""
    x, gate, bias, w13, w2, k, norm, scale, valid = glue_case(case)
    want = composite(x, gate, bias, w13, w2, k, norm, scale, valid)
    counts = torch.zeros(3, dtype=torch.int64)
    rows, offs, inverse = moe.permute(x, want["chosen"], 8, counts)
    assert torch.equal(offs, want["offs"]) and torch.equal(inverse, want["inverse"])
    assert torch.equal(rows, want["rows"])
    assert counts.tolist() == want["counts"]
    total = int(offs[-1])
    # rows of one expert keep their tokens' order; sentinel rows come last
    experts = want["chosen"].reshape(-1)
    placed = torch.empty_like(experts).scatter_(0, inverse, experts)
    assert torch.equal(placed, experts.sort(stable=True).values)
    assert total == int((experts < 8).sum())
    if case == "an expert without rows":
        assert offs[2] == offs[1] and counts[1] == 7
    if case == "padding tokens":
        assert bool((inverse.view(-1, k)[~valid] >= total).all())


@pytest.mark.parametrize("case", GLUE_CASES)
def test_swiglu_and_combine_match_the_composite(case):
    """swiglu and combine, and the whole plain path, within TOL of the
    composite; no kernel launches on the CPU, whatever use_kernels says."""
    x, gate, bias, w13, w2, k, norm, scale, valid = glue_case(case)
    want = composite(x, gate, bias, w13, w2, k, norm, scale, valid)
    assert (moe.swiglu(want["h"], w2.shape[2]) - want["a"]).abs().max() < TOL
    out = moe.combine(want["y"], want["inverse"], want["weights"], valid, x.dtype)
    assert (out - want["out"]).abs().max() < TOL
    launched = [f.launches for f in (moe.route_kernel, moe.permute_kernel, moe.swiglu_kernel, moe.combine_kernel)]
    counts = torch.zeros(3, dtype=torch.int64)
    for use_kernels in (True, False):
        whole = moe.sparse_moe(x, gate, bias, w13, w2, k, norm, scale, valid=valid, counts=counts,
                               use_kernels=use_kernels)
        assert (whole - want["out"]).abs().max() < TOL
    assert counts.tolist() == [2 * n for n in want["counts"]]
    assert launched == [f.launches for f in (moe.route_kernel, moe.permute_kernel, moe.swiglu_kernel,
                                            moe.combine_kernel)]


@pytest.mark.parametrize("bad", ["8 experts", "top-2", "width 512", "float32 router", "valid as int",
                                 "float32 activations"])
def test_the_kernel_path_refuses_what_it_does_not_take(bad):
    """What csrc/moe.cu is not built for raises before any launch (the
    kernel path has no fallback)."""
    E, H, inter, k, T = 32, 1024, 24, 4, 10
    x, gate, bias = _bf16(T, H), _bf16(E, H), torch.zeros(E)
    w13, w2, valid = _bf16(E, 2 * inter, H), _bf16(E, H, inter), torch.ones(T, dtype=torch.bool)
    moe._check_kernels(x, gate, bias, w13, w2, k, valid, None)
    if bad == "8 experts":
        w13, w2 = w13[:8], w2[:8]
    elif bad == "top-2":
        k = 2
    elif bad == "width 512":
        x, gate, w13, w2 = x[:, :512].contiguous(), gate[:, :512].contiguous(), w13[..., :512], w2[:, :512]
    elif bad == "float32 router":
        gate = gate.float()
    elif bad == "float32 activations":  # a float32 model on the card passes use_kernels=False
        x = x.float()
    else:
        valid = valid.int()
    with pytest.raises((ValueError, TypeError)):
        moe._check_kernels(x, gate, bias, w13, w2, k, valid, None)


def test_the_glue_wrappers_share_the_kernels_constants():
    """ops/moe.py allocates and launches by csrc/moe.cu's constants: its
    experts, top-k, tokens a route block (a histogram row each) and route
    blocks a permute CTA at most."""
    import re
    from pathlib import Path

    source = (Path(moe.__file__).resolve().parent.parent / "csrc" / "moe.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"^constexpr int (\w+) = (\d+);", source, re.M)}
    assert (consts["NE"], consts["TOPK"]) == (moe.KERNEL_EXPERTS, moe.KERNEL_TOP_K)
    assert consts["ROUTE_TOKENS"] == moe.ROUTE_TOKENS and consts["MAX_BLOCKS_PER_CTA"] == moe.MAX_BLOCKS_PER_CTA
    assert consts["ROUTE_TOKENS"] * consts["TOPK"] == 32  # a route block's rows are one warp's lanes


def test_config_from_json_builds_each_decoder():
    """decoder.model_type picks the decoder; without it (or "qwen2") the
    Qwen2-style one with the loader's defaults, as before."""
    lfm2 = config_from_json(RAW)
    assert isinstance(lfm2.decoder, lfm2_decoder.Lfm2Config)
    assert lfm2.decoder.layer_types == tuple(DECODER["layer_types"]) and lfm2.decoder.vocab_size == 65825
    assert lfm2.decoder.attention_layers == (1, 3) and lfm2.decoder.cache_layers == 2
    assert isinstance(FoundationModel(lfm2).decoder, lfm2_decoder.Lfm2Decoder)
    for decoder in ({}, {"model_type": "qwen2"}):
        qwen = config_from_json({"vocab_size": 300, "decoder": decoder})
        assert qwen.decoder == qwen_decoder.DecoderConfig(vocab_size=300, **DEFAULT_DECODER, rms_norm_eps=1e-6)
        assert type(FoundationModel(qwen).decoder) is qwen_decoder.Decoder
    with pytest.raises(ValueError, match="model_type"):
        config_from_json({"vocab_size": 300, "decoder": {"model_type": "mamba"}})
    # a language model's own keys that set nothing of the decoder are not read
    extra = config_from_json(dict(RAW, decoder=dict(DECODER, vocab_size=65536, max_position_embeddings=128000)))
    assert extra.decoder == lfm2.decoder


def test_checkpoint_tensors_load_through_the_converter(model):
    """A checkpoint's per-expert tensors (transformers' names under
    "decoder.") load through convert_torch into the stacked module."""
    tensors = {k: v.numpy() for k, v in per_expert(model.decoder.state_dict()).items()}
    tensors = {f"decoder.{k}": v for k, v in tensors.items()}
    fresh = lfm2_decoder.Lfm2Decoder(model.config.decoder)
    pnn.load_jax_params(fresh, lfm2_decoder.convert_torch(TensorBag(tensors), model.config.decoder))
    for name, value in model.decoder.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    stacked = lfm2_decoder.stack_experts({k: torch.from_numpy(v) for k, v in tensors.items()}, model.config.decoder)
    assert all(torch.equal(stacked[f"decoder.{k}"], v) for k, v in model.decoder.state_dict().items())


def test_int8_and_mesh_are_refused():
    with pytest.raises(ValueError, match="bf16 or float32"):
        lfm2_decoder.init_cache(config_from_json(RAW).decoder, 2, 16, torch.float32, "cpu", quantize=True)
    with pytest.raises(ValueError, match="bf16 or float32"):
        lfm2_decoder.check_supported(quantize_weights=True)
    with pytest.raises(ValueError, match="one device"):
        lfm2_decoder.check_supported(mesh=object())


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_k2_and_k3_take_both_head_shapes():
    """K2 and K3 take head dim 64 with 4 query heads a kv head beside 128
    with 3; K3q takes 128 with 3 only."""
    for D, H, kvh in ((128, 12, 4), (64, 32, 8)):
        flash._check_causal("k2", _bf16(1, 64, H, D), _bf16(1, 64, kvh, D), _bf16(1, 64, kvh, D))
        q, cache, chunk = _bf16(2, H, D), _bf16(1, 2, kvh, 16, D), _bf16(1, 2, kvh, 8, D)
        lens = torch.zeros(2, dtype=torch.int32)
        decode_attn._check_decode("k3", q, cache, cache, lens, chunk, chunk, 0, 0)
    q8 = torch.zeros((1, 2, 8, 16, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="head dim 128 with 3"):
        decode_attn._check_decode("k3q", _bf16(2, 32, 64), q8, q8, lens, _bf16(1, 2, 8, 8, 64),
                                  _bf16(1, 2, 8, 8, 64), 0, 0, _bf16(1, 2, 8, 16), _bf16(1, 2, 8, 16))


def test_predictor_runs_the_lfm2_decoder_and_counts_its_experts():
    """RecognitionPredictor built from a config.json whose decoder is
    lfm2_moe serves lines through its scheduler and slot cache; two calls
    serve the same tokens (the second on the kept cache store), and each
    counts its token-expert rows, experts hit and seeded conv states."""
    from PIL import Image, ImageDraw

    from surya_tpu_torch.common import profiling
    from surya_tpu_torch.recognition import RecognitionPredictor

    pred = RecognitionPredictor(device="cpu", config=RAW)
    assert isinstance(pred.model.decoder, lfm2_decoder.Lfm2Decoder)
    img = Image.new("RGB", (400, 120), "white")
    ImageDraw.Draw(img).text((10, 10), "Hello world", fill="black")
    boxes = [[[5, 5, 200, 40], [5, 60, 300, 100], [200, 5, 390, 50]]]
    profiling.report(reset=True)
    first = [line.text for line in pred([img], bboxes=boxes)[0].text_lines]
    stats = profiling.report(reset=True)
    second = [line.text for line in pred([img], bboxes=boxes)[0].text_lines]
    assert first == second
    assert stats["recognition.conv_state_seeds"]["count"] == 3
    rows, hits, largest = (stats[f"recognition.moe_{n}"]["count"] for n in ("rows", "experts_hit", "rows_max"))
    assert 0 < hits and 0 < largest <= rows
    assert int(pred.model.decoder.moe_counts.sum()) == 0  # read and zeroed once a call
