"""The port's foundation model against the JAX package's, on the CPU in
float32, on shared weights: the prefill bundle from both processors, then
prefill plus two decode chunks, pinned and free-running. Token ids must be
identical, scores within 1e-4 and int bboxes equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu.recognition.loader import load_recognition_model as jax_load
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.recognition.loader import load_recognition_model

torch.set_num_threads(1)
N_SLOTS, CACHE_LEN, K = 4, 256, 8
SEQ_BUCKETS, PATCH_CAPS = (128, 256), (1024, 4096)


@pytest.fixture(scope="module")
def models():
    # a local checkpoint path that does not exist: random init, no download
    params, jcfg, jproc = jax_load(checkpoint=os.devnull, tiny=True)
    np_params = jax.tree.map(np.asarray, params)
    model, cfg, proc = load_recognition_model(tiny=True, device="cpu", jax_params=np_params)
    return params, jcfg, jproc, model, cfg, proc


def _lines(rng):
    # uint8 line crops, already inside scale_to_fit's pixel budget
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in [(28, 1008), (56, 700), (168, 196)]]


def _batch(proc, enc_cfg, imgs):
    return proc.build_prefill_batch(
        imgs, ["ocr_with_boxes"] * 3, [None, "ab", None], [True, False, True], enc_cfg,
        batch_rows=4, seq_buckets=SEQ_BUCKETS, patch_caps=PATCH_CAPS,
    )


def test_prefill_batch_matches_jax(models):
    _, jcfg, jproc, _, cfg, proc = models
    imgs = _lines(np.random.default_rng(0))
    ours, ref = _batch(proc, cfg.encoder, imgs), _batch(jproc, jcfg.encoder, imgs)
    for name in ("patches", "input_ids", "img_gather", "seq_lens"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    for a, b in zip(ours.layout.device_args, ref.layout.device_args):
        assert np.array_equal(a, b)
    assert (ours.layout.kv_range, ours.layout.win_range) == (ref.layout.kv_range, ref.layout.win_range)


@pytest.mark.parametrize("pin", [True, False])
def test_prefill_and_decode_match_jax(models, pin):
    params, jcfg, jproc, model, cfg, proc = models
    imgs = _lines(np.random.default_rng(1))
    batch = _batch(proc, cfg.encoder, imgs)
    lay = batch.layout
    patches = proc.normalize_patch_rows(torch.from_numpy(batch.patches), torch.float32)
    slot_idx = np.array([2, 0, 3, N_SLOTS], np.int32)  # row 3 is padding: the trash slot

    prefill = jax.jit(jax_foundation.prefill, static_argnums=(1,),
                      static_argnames=("kv_range", "win_range", "use_pallas"))
    jcache = jax_decoder.init_cache(jcfg.decoder, N_SLOTS + 1, CACHE_LEN, jnp.float32)
    jcache, jtok, jscore, jbbox = prefill(
        params, jcfg, jcache, jnp.asarray(patches.numpy()), tuple(map(jnp.asarray, lay.device_args)),
        jnp.asarray(lay.llm_h_idx), jnp.asarray(lay.llm_w_idx), jnp.asarray(batch.input_ids),
        jnp.asarray(batch.img_gather), jnp.asarray(batch.seq_lens), jnp.asarray(slot_idx),
        kv_range=lay.kv_range, win_range=lay.win_range, use_pallas=False,
    )
    tcache = qwen_decoder.init_cache(cfg.decoder, N_SLOTS + 1, CACHE_LEN, torch.float32, "cpu")
    t = torch.from_numpy
    with torch.inference_mode():
        tok, score, bbox = model.prefill(
            tcache, patches, tuple(map(t, lay.device_args)), t(lay.llm_h_idx), t(lay.llm_w_idx),
            t(batch.input_ids), t(batch.img_gather), t(batch.seq_lens), t(slot_idx),
            kv_range=lay.kv_range, win_range=lay.win_range,
        )
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.abs(score.numpy() - np.asarray(jscore)).max() < 1e-4
    assert np.array_equal(bbox.numpy(), np.asarray(jbbox))
    assert np.array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))

    # seed the three filled slots from token 0
    tok0 = np.asarray(jtok)[:3]
    last = np.full(N_SLOTS + 1, cfg.pad_token_id, np.int32)
    last[slot_idx[:3]] = np.where(np.isin(tok0, (cfg.eos_token_id, cfg.pad_token_id)), cfg.pad_token_id, tok0)
    active = np.zeros(N_SLOTS + 1, bool)
    active[slot_idx[:3]] = True
    run = np.where(active, 1, 0).astype(np.int32)
    window = 0 if pin else 3  # a short repeat window so the device stop fires

    decode = jax.jit(jax_foundation.decode_chunk, static_argnums=(1,),
                     static_argnames=("num_steps", "use_pallas", "repeat_window", "pin_decode"))
    jstate = tstate = (last, active, run)
    for _ in range(2):  # the second chunk attends over the first one's committed KV
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
