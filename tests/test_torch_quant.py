"""The port's int8 KV cache against the JAX package's, on the CPU in float32.

- ``quantize_kv``: the int8 values and the bits of the bf16 scales equal the
  JAX function's;
- K3q's plain version (``gqa_decode`` on CPU tensors with scales) against
  ``gqa_decode_pallas(..., interpret=True)`` and ``gqa_decode_reference``
  with the same scales, at atol 2e-5 / rtol 1e-4 (fp32, other summation
  orders; the tolerance of tests/test_decode_attn.py);
- the foundation model's prefill, merge into an int8 cache and two decode
  chunks: the same greedy tokens, int bboxes, lengths and device state as
  the JAX int8 run, and scores within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu.ops import decode_attn as jax_decode
from surya_tpu.recognition.loader import load_recognition_model as jax_load
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.ops import decode_attn
from surya_tpu_torch.recognition.loader import load_recognition_model

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16)


def _t_bf16(a):
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 2, 40, 128)).astype(np.float32) * np.float32(0.7)
    x[0, 0, 0, 0] = 0.0  # an all-zero row: the 1e-8 scale floor
    x[0, 0, 0, 1, :4] = [127.0, -63.5, 0.5, -0.5]  # ratios that sit on .5: round half to even
    x[1, 2, 1, 3] *= 1e4  # a large row
    jq, js = jax_decoder.quantize_kv(jnp.asarray(x))
    tq, ts = qwen_decoder.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.view(torch.int16).numpy().view(np.uint16), _bf16_bits(js))
    back = qwen_decoder.dequantize_kv(tq, ts, torch.float32)
    assert np.array_equal(back.numpy(), np.asarray(jax_decoder.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("lengths", [[0, 17, 200, 256], [1, 1, 1, 1], [256, 256, 256, 256], [0, 0, 0, 0]])
def test_gqa_decode_int8_matches_jax(lengths):
    rng = np.random.default_rng(1)
    B, H, kvh, D, S, K, layers = 4, 6, 2, 128, 256, 32, 2
    q = rng.standard_normal((B, H, D), dtype=np.float32) * 0.3
    kc, vc = (rng.standard_normal((layers, B, kvh, S, D), dtype=np.float32) * 0.3 for _ in range(2))
    ck, cv = (rng.standard_normal((layers, B, kvh, K, D), dtype=np.float32) * 0.3 for _ in range(2))
    (jkc, jks), (jvc, jvs) = jax_decoder.quantize_kv(jnp.asarray(kc)), jax_decoder.quantize_kv(jnp.asarray(vc))
    lens = np.asarray(lengths, np.int32)
    jargs = (jnp.asarray(q), jkc, jvc, jnp.asarray(lens), jnp.asarray(ck), jnp.asarray(cv))
    targs = (_t(q), _t(jkc), _t(jvc), _t(lens), _t(ck), _t(cv))
    tscales = (_t_bf16(jks), _t_bf16(jvs))
    before = decode_attn.gqa_decode.launches, decode_attn.gqa_decode.launches_q
    for step, layer in ((0, 0), (7, 1), (31, 0)):
        pallas = jax_decode.gqa_decode_pallas(*jargs, jnp.int32(step), layer, jks, jvs, block_s=64, interpret=True)
        ref = jax_decode.gqa_decode_reference(*jargs, jnp.int32(step), layer, jks, jvs)
        out = decode_attn.gqa_decode(*targs, step, layer, *tscales).numpy()
        np.testing.assert_allclose(out, np.asarray(pallas), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-4)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (decode_attn.gqa_decode.launches, decode_attn.gqa_decode.launches_q) == before


def test_gqa_decode_int8_refuses():
    """Scales for only one of K and V raise; a meta tensor (neither CPU nor
    CUDA) with scales raises instead of falling back."""
    q = torch.zeros((2, 6, 128))
    cache = torch.zeros((1, 2, 2, 16, 128), dtype=torch.int8)
    scale = torch.zeros((1, 2, 2, 16), dtype=torch.bfloat16)
    chunk = torch.zeros((1, 2, 2, 4, 128))
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        decode_attn.gqa_decode(q, cache, cache, lens, chunk, chunk, 0, 0, k_scale=scale)
    meta = [t.to("meta") for t in (q, cache, lens, chunk, scale)]
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.gqa_decode(meta[0], meta[1], meta[1], meta[2], meta[3], meta[3], 0, 0, meta[4], meta[4])


N_SLOTS, CACHE_LEN, K = 4, 256, 8
SEQ_BUCKETS, PATCH_CAPS = (128, 256), (1024, 4096)


@pytest.fixture(scope="module")
def models():
    # a local checkpoint path that does not exist: random init, no download
    params, jcfg, jproc = jax_load(checkpoint=os.devnull, tiny=True)
    model, cfg, proc = load_recognition_model(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, params))
    return params, jcfg, model, cfg, proc


@pytest.mark.parametrize("pin", [True, False])
def test_int8_cache_prefill_and_decode_match_jax(models, pin):
    params, jcfg, model, cfg, proc = models
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in [(28, 1008), (56, 700), (168, 196)]]
    batch = proc.build_prefill_batch(
        imgs, ["ocr_with_boxes"] * 3, [None, "ab", None], [True, False, True], cfg.encoder,
        batch_rows=4, seq_buckets=SEQ_BUCKETS, patch_caps=PATCH_CAPS,
    )
    lay = batch.layout
    patches = proc.normalize_patch_rows(torch.from_numpy(batch.patches), torch.float32)
    slot_idx = np.array([2, 0, 3, N_SLOTS], np.int32)  # row 3 is padding: the trash slot

    prefill = jax.jit(jax_foundation.prefill, static_argnums=(1,),
                      static_argnames=("kv_range", "win_range", "use_pallas"))
    jcache = jax_decoder.init_cache(jcfg.decoder, N_SLOTS + 1, CACHE_LEN, jnp.float32, quantize=True)
    jcache, jtok, jscore, _ = prefill(
        params, jcfg, jcache, jnp.asarray(patches.numpy()), tuple(map(jnp.asarray, lay.device_args)),
        jnp.asarray(lay.llm_h_idx), jnp.asarray(lay.llm_w_idx), jnp.asarray(batch.input_ids),
        jnp.asarray(batch.img_gather), jnp.asarray(batch.seq_lens), jnp.asarray(slot_idx),
        kv_range=lay.kv_range, win_range=lay.win_range, use_pallas=False,
    )
    tcache = qwen_decoder.init_cache(cfg.decoder, N_SLOTS + 1, CACHE_LEN, torch.float32, "cpu", quantize=True)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {k: v.shape for k, v in jcache.items()}
    assert (tcache["k"].dtype, tcache["v_scale"].dtype) == (torch.int8, torch.bfloat16)
    t = torch.from_numpy
    with torch.inference_mode():
        tok, score, _ = model.prefill(
            tcache, patches, tuple(map(t, lay.device_args)), t(lay.llm_h_idx), t(lay.llm_w_idx),
            t(batch.input_ids), t(batch.img_gather), t(batch.seq_lens), t(slot_idx),
            kv_range=lay.kv_range, win_range=lay.win_range,
        )
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.abs(score.numpy() - np.asarray(jscore)).max() < 1e-4
    assert np.array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))

    tok0 = np.asarray(jtok)[:3]
    last = np.full(N_SLOTS + 1, cfg.pad_token_id, np.int32)
    last[slot_idx[:3]] = np.where(np.isin(tok0, (cfg.eos_token_id, cfg.pad_token_id)), cfg.pad_token_id, tok0)
    active = np.zeros(N_SLOTS + 1, bool)
    active[slot_idx[:3]] = True
    run = np.where(active, 1, 0).astype(np.int32)
    window = 0 if pin else 3

    decode = jax.jit(jax_foundation.decode_chunk, static_argnums=(1,),
                     static_argnames=("num_steps", "use_pallas", "repeat_window", "pin_decode"))
    jstate = tstate = (last, active, run)
    for _ in range(2):  # the second chunk attends over the first one's committed, quantized KV
        jcache, jt, js, jb, jl, ja, jr = decode(
            params, jcfg, jcache, *map(jnp.asarray, jstate[:2]), num_steps=K, use_pallas=False,
            run=jnp.asarray(jstate[2]), repeat_window=window, pin_decode=pin,
        )
        with torch.inference_mode():
            tt, ts, tb, tl, ta, tr = model.decode_chunk(
                tcache, *map(t, tstate[:2]), K, run=t(tstate[2]), repeat_window=window, pin_decode=pin,
            )
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        assert np.abs(ts.numpy() - np.asarray(js)).max() < 1e-4
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        for ours, ref in zip((tl, ta, tr, tcache["len"]), (jl, ja, jr, jcache["len"])):
            assert np.array_equal(ours.numpy(), np.asarray(ref))
        jstate = tuple(np.asarray(a) for a in (jl, ja, jr))
        tstate = tuple(a.numpy().copy() for a in (tl, ta, tr))
