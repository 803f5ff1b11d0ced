"""The split-KV algorithm of the decode kernels K3 and K3q, held on the CPU.

``split_decode`` below is a plain torch model of how csrc/decode_attn.cu
partitions one decode step: per (slot, kv head), cache splits of T =
SPLIT_ROWS rows and chunk splits of T columns; a split whose first row is at
or past the slot's length (or whose first column is past ``step``) does not
run; each split that runs keeps its own (m, l, acc) in the log2 domain,
updated online over sub-tiles of SUB rows, with the NEG_INF sentinel as its
first max; for an int8 cache the row scales are factored out, logit = ks_r
(q . k_int) and P V takes p_r vs_r; a log-sum-exp merge of the splits that
ran gives the output (a split that runs alone is the output). It lives
here, not in the port: the kernel is its only user on the card, where
chip_smoke.py holds the kernel against the plain version.

It is held against the port's plain version (``gqa_decode`` on CPU tensors)
and against the JAX package's ``gqa_decode_pallas(..., interpret=True)`` and
``gqa_decode_reference``, in float32: tolerance 1e-5 max-abs (the sums run
in other orders). 12/4 heads, D = 128, slots of lengths 0, 1, SUB + 1,
T - 1, T, T + 1 and S, 2 layers, bf16-width (float32 here) and int8 caches.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu.ops import decode_attn as jax_decode
from surya_tpu_torch.ops import decode_attn

torch.set_num_threads(1)
TOL = 1e-5
T = decode_attn.SPLIT_ROWS
SUB = 16  # rows a warp computes at once: SUB in csrc/decode_attn.cu
NEG_INF = -1e30
S = 3 * T
LENGTHS = [0, 1, SUB + 1, T - 1, T, T + 1, S]
LAYERS, KVH, G, D = 2, 4, 3, 128


def split_rows(x: int, n_cache_splits: int, length: int, step: int) -> int:
    """Rows of split x (<= 0: it does not run), the rule of `split_rows` in
    csrc/decode_attn.cu."""
    if x < n_cache_splits:
        return min(T, length - x * T)
    return min(T, step + 1 - (x - n_cache_splits) * T)


def split_decode(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale=None, v_scale=None):
    """The kernel's partition and merge, in float32. Reads no cache row at
    or past a slot's length and no chunk column past `step`."""
    B, H, Dh = q.shape
    kvh, S_, K = k_cache.shape[2], k_cache.shape[3], chunk_k.shape[3]
    nc, nk = -(-S_ // T), -(-K // T)
    scale_log2 = Dh**-0.5 * math.log2(math.e)
    out = torch.empty((B, H, Dh))
    for b in range(B):
        qg = q[b].float().reshape(kvh, H // kvh, Dh)
        length = min(max(int(lengths[b]), 0), S_)
        parts = []
        for x in range(nc + nk):
            n = split_rows(x, nc, length, step)
            if n <= 0:
                continue
            cache = x < nc
            r0 = x * T if cache else (x - nc) * T
            kp, vp = (k_cache, v_cache) if cache else (chunk_k, chunk_v)
            m = torch.full((kvh, H // kvh), NEG_INF)
            l = torch.zeros((kvh, H // kvh))
            acc = torch.zeros((kvh, H // kvh, Dh))
            for j0 in range(r0, r0 + n, SUB):  # the split's sub-tiles, online
                rows = slice(j0, min(j0 + SUB, r0 + n))
                kt, vt = kp[layer, b, :, rows].float(), vp[layer, b, :, rows].float()
                s = torch.einsum("hgd,hkd->hgk", qg, kt) * scale_log2
                if cache and k_scale is not None:  # int8 rows: ks_r (q . k_int)
                    s = s * k_scale[layer, b, :, None, rows].float()
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)  # 0 at the first sub-tile
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                if cache and v_scale is not None:  # p_r vs_r
                    p = p * v_scale[layer, b, :, None, rows].float()
                acc = acc * corr[..., None] + torch.einsum("hgk,hkd->hgd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - M) for m, _, _ in parts]
        L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        O = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts))
        out[b] = (O / L[..., None]).reshape(H, Dh)
    return out


def _inputs(K, quantized, invalid=1e3, seed=0):
    """q, cache, chunk (float32, or an int8 cache with bf16 scales from the
    JAX quantizer) with `invalid` in every cache row at or past a slot's
    length and every chunk column (the test's step decides which are read)."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    q = rng.standard_normal((B, G * KVH, D), dtype=np.float32)
    kc, vc = (rng.standard_normal((LAYERS, B, KVH, S, D), dtype=np.float32) * 0.3 for _ in range(2))
    ck, cv = (rng.standard_normal((LAYERS, B, KVH, K, D), dtype=np.float32) * 0.3 for _ in range(2))
    scales = None
    if quantized:
        (kq, ks), (vq, vs) = jax_decoder.quantize_kv(jnp.asarray(kc)), jax_decoder.quantize_kv(jnp.asarray(vc))
        kc, vc = np.array(kq), np.array(vq)
        scales = tuple(np.array(sc.astype(jnp.float32)) for sc in (ks, vs))
    for b, length in enumerate(LENGTHS):
        for a in (kc, vc):
            a[:, b, :, length:] = np.int8(-128) if quantized else invalid
        for a in scales or ():
            a[:, b, :, length:] = invalid
    return q, kc, vc, np.asarray(LENGTHS, np.int32), ck, cv, scales


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk_beyond(ck, cv, step, value):
    ck, cv = ck.copy(), cv.copy()
    ck[:, :, :, step + 1 :] = value
    cv[:, :, :, step + 1 :] = value
    return ck, cv


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("K,step", [(64, 0), (64, 63), (80, 0), (80, 79), (80, 64)])
def test_split_model_matches_the_plain_version_and_jax(quantized, K, step):
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized)
    ck, cv = _chunk_beyond(ck, cv, step, 1e3)
    for layer in range(LAYERS):
        targs = (_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, layer)
        tsc = tuple(_t(s).to(torch.bfloat16) for s in scales) if quantized else ()
        ours = split_decode(*targs, *tsc).numpy()
        plain = decode_attn.gqa_decode(*targs, *tsc).numpy()
        jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), jnp.asarray(ck),
                 jnp.asarray(cv), jnp.int32(step), layer)
        jsc = tuple(jnp.asarray(s).astype(jnp.bfloat16) for s in scales) if quantized else ()
        pallas = np.asarray(jax_decode.gqa_decode_pallas(*jargs, *jsc, block_s=64, interpret=True))
        ref = np.asarray(jax_decode.gqa_decode_reference(*jargs, *jsc))
        assert np.isfinite(ours).all()
        for other in (plain, pallas, ref):
            assert np.abs(ours - other).max() < TOL


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_split_model_reads_no_row_past_a_length_or_step(quantized):
    """NaN in every cache row at or past a slot's length, in their scales,
    and in every chunk column past `step` changes nothing: no split that
    runs reads them."""
    K, step = 80, 70
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized, invalid=1e3)
    ck, cv = _chunk_beyond(ck, cv, step, 1e3)
    finite = split_decode(_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, 1,
                          *(tuple(_t(s) for s in scales) if quantized else ()))
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized, invalid=np.nan)
    if not quantized:
        assert np.isnan(kc).any()
    ck, cv = _chunk_beyond(ck, cv, step, np.nan)
    poisoned = split_decode(_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, 1,
                            *(tuple(_t(s) for s in scales) if quantized else ()))
    assert torch.equal(finite, poisoned)


@pytest.mark.parametrize("length,cache_splits", [(0, []), (1, [0]), (T - 1, [0]), (T, [0]), (T + 1, [0, 1]),
                                                 (S, [0, 1, 2])])
def test_splits_that_run(length, cache_splits):
    """S = 3T and K = T + 1: cache splits 0..2, chunk splits 3 (columns
    0..T-1) and 4 (column T). A cache split runs while its first row is
    below the length; chunk split 3 runs at every step, split 4 from step T.
    The workspace holds every split, run or not."""
    nc, K = 3, T + 1
    for step, chunk_splits in ((0, [3]), (T - 1, [3]), (T, [3, 4])):
        assert [x for x in range(nc + 2) if split_rows(x, nc, length, step) > 0] == cache_splits + chunk_splits
    assert decode_attn.workspace_floats(2, KVH, S, K) == 2 * KVH * (nc + 2) * G * (D + 2)


def _decode_args(**change):
    """Arguments K3q takes (CPU tensors of the kernel's dtypes), with some changed."""
    B, K = 2, 8
    args = dict(
        q=torch.zeros((B, G * KVH, D), dtype=torch.bfloat16),
        k_cache=torch.zeros((1, B, KVH, 16, D), dtype=torch.int8),
        v_cache=torch.zeros((1, B, KVH, 16, D), dtype=torch.int8),
        lengths=torch.zeros((B,), dtype=torch.int32),
        chunk_k=torch.zeros((1, B, KVH, K, D), dtype=torch.bfloat16),
        chunk_v=torch.zeros((1, B, KVH, K, D), dtype=torch.bfloat16),
        step=0, layer=0,
        k_scale=torch.zeros((1, B, KVH, 16), dtype=torch.bfloat16),
        v_scale=torch.zeros((1, B, KVH, 16), dtype=torch.bfloat16),
    )
    args.update(change)
    return args


REFUSED = {
    "bf16 cache with scales": (dict(k_cache=torch.zeros((1, 2, KVH, 16, D), dtype=torch.bfloat16)), TypeError, "cache"),
    "float32 queries": (dict(q=torch.zeros((2, G * KVH, D))), TypeError, "bfloat16"),
    "float32 scales": (dict(v_scale=torch.zeros((1, 2, KVH, 16))), TypeError, "bfloat16"),
    "int64 lengths": (dict(lengths=torch.zeros((2,), dtype=torch.int64)), ValueError, "int32"),
    "head dim 64": (dict(q=torch.zeros((2, G * KVH, 64), dtype=torch.bfloat16)), ValueError, "does not match"),
    "2 query heads per kv head": (dict(q=torch.zeros((2, 2 * KVH, D), dtype=torch.bfloat16)), ValueError, "built for"),
    "chunk of other slots": (dict(chunk_v=torch.zeros((1, 3, KVH, 8, D), dtype=torch.bfloat16)), ValueError, "chunk"),
    "scales of another length": (dict(k_scale=torch.zeros((1, 2, KVH, 8), dtype=torch.bfloat16)), ValueError, "scales"),
    "strided cache": (dict(v_cache=torch.zeros((1, 2, KVH, D, 16), dtype=torch.int8).transpose(3, 4)), ValueError,
                      "contiguous"),
    "step past the chunk": (dict(step=8), ValueError, "out of range"),
    "layer past the cache": (dict(layer=1), ValueError, "out of range"),
    "8 kv heads": (dict(q=torch.zeros((2, G * 8, D), dtype=torch.bfloat16),
                        k_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                        v_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                        chunk_k=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                        chunk_v=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                        k_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16),
                        v_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)), ValueError, "at most"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_decode_check_refuses(case):
    change, err, match = REFUSED[case]
    args = _decode_args(**change)
    with pytest.raises(err, match=match):
        decode_attn._check_decode("gqa_decode_int8", **args)


def test_decode_check_takes_both_caches():
    assert decode_attn._check_decode("gqa_decode_int8", **_decode_args(step=7)) == (7, 0)
    bf16 = _decode_args(k_cache=torch.zeros((1, 2, KVH, 16, D), dtype=torch.bfloat16),
                        v_cache=torch.zeros((1, 2, KVH, 16, D), dtype=torch.bfloat16), k_scale=None, v_scale=None)
    assert decode_attn._check_decode("gqa_decode", **bf16) == (0, 0)
