"""The sub-tile and cluster schedule of the decode kernels K3 and K3q, held on the CPU.

``cluster_decode`` below is a plain torch model of how csrc/decode_attn.cu
partitions one decode step. Per (slot, kv head), the valid rows are cut
into 16-row sub-tiles, the chunk's columns 0..step first and then the
cache's rows < length; only sub-tiles holding a valid row exist, so
sub-tile 0 (chunk column 0) always does. A cluster of C CTAs
(``cluster_size``, the kernel's rule ``decode_cluster_size`` written out
here: 1 unless the shape allows more sub-tiles than a CTA should walk and
more CTAs fit the card) shares them round robin: rank r
takes sub-tiles r, r + C, ..., and warp w of a CTA's 2 takes the CTA's
sub-tiles w, w + 2, ... and keeps its own (m, l, acc) in the log2 domain,
updated online, with the NEG_INF sentinel as its first max; for an int8
cache the row scales are factored out, logit = ks_r (q . k_int) and P V
takes p_r vs_r. The warps meet by log-sum-exp, then rank 0 merges every
rank's partial, skipping the ranks with l = 0 (those without sub-tiles),
whose accumulator it never reads. It lives here, not in the port: the
kernel is its only user on the card, where chip_smoke.py holds the kernel
against the plain version.

It is held against the port's plain version (``gqa_decode`` on CPU tensors)
and against the JAX package's ``gqa_decode_pallas(..., interpret=True)`` and
``gqa_decode_reference``, in float32: tolerance 1e-5 max-abs (the sums run
in other orders). 12/4 heads, D = 128, slots of lengths 0, 1, SUB + 1,
BLOCK - 1, BLOCK, BLOCK + 1 and S, 2 layers, bf16-width (float32 here) and
int8 caches, with 1, 2 and 8 CTAs a (slot, kv head); and caches of 512 and
2048 rows.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernel_variants
from surya_tpu.models import qwen_decoder as jax_decoder
from surya_tpu.ops import decode_attn as jax_decode
from surya_tpu_torch.ops import decode_attn

torch.set_num_threads(1)
TOL = 1e-5
SUB = 16  # rows of a sub-tile, a TMA box and what a warp computes at once: SUB in csrc/decode_attn.cu
BLOCK = 4 * SUB  # 64 rows: the lengths straddle it
WARPS = 2  # warps of a CTA: NWARP there
SMS = 132  # an H100's SMs
NEG_INF = -1e30
S = 3 * BLOCK
LENGTHS = [0, 1, SUB + 1, BLOCK - 1, BLOCK, BLOCK + 1, S]
LAYERS, KVH, G, D = 2, 4, 3, 128
SUBS_PER_CTA = 12  # sub-tiles a CTA may walk (two rounds of its 6-slot ring) before a cluster: SUBS_PER_CTA there
MAX_CLUSTER = 8  # the portable cluster size: MAX_CLUSTER there
MIN_CTAS = 4  # CTAs an SM holds at most (what the registers are sized for): MIN_CTAS there
SMEM_PER_SM, SMEM_RESERVED = 228 * 1024, 1024  # an H100 SM's shared memory, and the bytes it keeps a CTA


def ctas_per_sm(C: int) -> int:
    """CTAs an H100 SM holds at once with clusters of C: a CTA's shared
    memory is 6 ring slots of 8192 bytes, 7 mbarriers and, in a cluster,
    each rank's partial (3 heads x (128 + 2) floats) in rank 0's; at most
    MIN_CTAS (``decode_ctas_per_sm``)."""
    smem = 6 * 8192 + 7 * 8 + (C * G * (D + 2) * 4 if C > 1 else 0)
    return min(MIN_CTAS, SMEM_PER_SM // (smem + SMEM_RESERVED))


def cluster_size(B: int, kvh: int, S_: int, K: int, sms: int = SMS) -> int:
    """CTAs of a (slot, kv head): enough that none walks more than
    SUBS_PER_CTA of the sub-tiles S_ cache rows and K chunk columns can
    make, at most MAX_CLUSTER, and fewer while the launch's CTAs would not
    all fit the card at once (``decode_cluster_size``)."""
    subs = -(-S_ // SUB) + -(-K // SUB)
    c = min(MAX_CLUSTER, -(-subs // SUBS_PER_CTA))
    while c > 1 and c * B * kvh > ctas_per_sm(c) * sms:
        c -= 1
    return c


def subtiles(length: int, step: int) -> list:
    """(cache?, first row, valid rows) of each sub-tile of a (slot, kv head),
    the kernel's order: the chunk's columns 0..step, then the cache's rows
    < length."""
    chunk = [(False, x * SUB, min(SUB, step + 1 - x * SUB)) for x in range(step // SUB + 1)]
    return chunk + [(True, x * SUB, min(SUB, length - x * SUB)) for x in range(-(-length // SUB))]


def rank_subtiles(length: int, step: int, C: int) -> list:
    """The sub-tiles of each of a cluster's C ranks: rank r takes r, r + C, ..."""
    st = subtiles(length, step)
    return [st[r::C] for r in range(C)]


def lse_merge(parts):
    """Log-sum-exp merge of (m, l, acc) partials, skipping those with l = 0;
    returns (m, l, acc)."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    ran = l > 0
    M = torch.where(ran, m, torch.full_like(m, NEG_INF)).amax(0)
    w = torch.where(ran, torch.exp2(m - M), torch.zeros_like(m))
    acc = torch.where(ran[..., None], acc, torch.zeros_like(acc))  # a rank without blocks: never read
    return M, (w * l).sum(0), (w[..., None] * acc).sum(0)


def cta_partial(qg, its_subtiles, scale_log2):
    """One CTA's partial over its sub-tiles (each (k, v, ks, vs, rows):
    [kvh, rows, D] and [kvh, rows] or None), as its 2 warps walk them: warp
    w the CTA's sub-tiles w, w + 2, ..., then the warps' log-sum-exp."""
    kvh, g, d = qg.shape
    warps = [(torch.full((kvh, g), NEG_INF), torch.zeros((kvh, g)), torch.zeros((kvh, g, d))) for _ in range(WARPS)]
    for k, (kp, vp, ks, vs, rows) in enumerate(its_subtiles):
        m, l, acc = warps[k % WARPS]
        s = torch.einsum("hgd,hkd->hgk", qg, kp) * scale_log2
        if ks is not None:
            s = s * ks[:, None]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)  # 0 at the warp's first sub-tile
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        if vs is not None:
            p = p * vs[:, None]
        warps[k % WARPS] = (m_new, l, acc * corr[..., None] + torch.einsum("hgk,hkd->hgd", p, vp))
    # the warps meet: a warp without rows weighs nothing; a CTA without sub-tiles gives l = 0
    m = torch.stack([w[0] for w in warps])
    M = m.amax(0)
    c = torch.exp2(m - M)
    return (M, (c * torch.stack([w[1] for w in warps])).sum(0),
            (c[..., None] * torch.stack([w[2] for w in warps])).sum(0))


def cluster_decode(q, k_cache, v_cache, lengths, chunk_k, chunk_v, step, layer, k_scale=None, v_scale=None,
                   C=None, idle_acc=0.0):
    """The kernel's partition and merges, in float32. Reads no cache row at
    or past a slot's length and no chunk column past `step`. C: CTAs a
    (slot, kv head), the kernel's rule if None; idle_acc: what a rank
    without blocks leaves in its accumulator slot (the merge must not read
    it)."""
    B, H, Dh = q.shape
    kvh, S_, K = k_cache.shape[2], k_cache.shape[3], chunk_k.shape[3]
    C = C or cluster_size(B, kvh, S_, K)
    scale_log2 = Dh**-0.5 * math.log2(math.e)
    out = torch.empty((B, H, Dh))
    for b in range(B):
        qg = q[b].float().reshape(kvh, H // kvh, Dh)
        length = min(max(int(lengths[b]), 0), S_)
        parts = []
        for mine in rank_subtiles(length, step, C):
            if not mine:
                parts.append((torch.full((kvh, G), NEG_INF), torch.zeros((kvh, G)),
                              torch.full((kvh, G, Dh), idle_acc)))
                continue
            its = []
            for cache, r0, n in mine:
                rows = slice(r0, r0 + n)
                kp, vp = (k_cache, v_cache) if cache else (chunk_k, chunk_v)
                scaled = cache and k_scale is not None
                its.append((kp[layer, b, :, rows].float(), vp[layer, b, :, rows].float(),
                            k_scale[layer, b, :, rows].float() if scaled else None,
                            v_scale[layer, b, :, rows].float() if scaled else None, n))
            parts.append(cta_partial(qg, its, scale_log2))
        _, L, A = lse_merge(parts)
        out[b] = (A / L[..., None]).reshape(H, Dh)
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


@pytest.mark.parametrize("C", [None, 2, 8], ids=["rule", "C2", "C8"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("K,step", [(64, 0), (64, 63), (80, 0), (80, 79), (80, 64)])
def test_split_model_matches_the_plain_version_and_jax(quantized, K, step, C):
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized)
    ck, cv = _chunk_beyond(ck, cv, step, 1e3)
    for layer in range(LAYERS):
        targs = (_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, layer)
        tsc = tuple(_t(s).to(torch.bfloat16) for s in scales) if quantized else ()
        ours = cluster_decode(*targs, *tsc, C=C).numpy()
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
    finite = cluster_decode(_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, 1,
                          *(tuple(_t(s) for s in scales) if quantized else ()))
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized, invalid=np.nan)
    if not quantized:
        assert np.isnan(kc).any()
    ck, cv = _chunk_beyond(ck, cv, step, np.nan)
    poisoned = cluster_decode(_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, 1,
                            *(tuple(_t(s) for s in scales) if quantized else ()))
    assert torch.equal(finite, poisoned)


@pytest.mark.parametrize("length,cache_subtiles", [(0, 0), (1, 1), (SUB - 1, 1), (SUB, 1), (SUB + 1, 2),
                                                   (BLOCK + 1, 5), (S, 12)])
def test_subtiles_that_exist(length, cache_subtiles):
    """Only sub-tiles holding a valid row exist: the chunk's (one up to step
    15, two from step 16, ...), then the cache's, one a started 16 rows.
    Sub-tile 0 is the chunk's first, so rank 0 always has rows; the ranks'
    sub-tiles cover them all once."""
    for step, chunk_subtiles in ((0, 1), (SUB - 1, 1), (SUB, 2), (BLOCK - 1, 4), (BLOCK, 5)):
        st = subtiles(length, step)
        assert [cache for cache, _, _ in st] == [False] * chunk_subtiles + [True] * cache_subtiles
        assert all(0 < n <= SUB for _, _, n in st) and st[0] == (False, 0, min(SUB, step + 1))
        for C in (1, 2, 5, 8):
            ranks = rank_subtiles(length, step, C)
            assert ranks[0] and sorted(x for r in ranks for x in r) == sorted(st)


CLUSTER_RULE = {  # (B, kvh, S, K) -> CTAs a (slot, kv head) on 132 SMs
    (129, 4, 256, 64): 1,  # the main path: 20 sub-tiles, but 2 x 516 CTAs would not fit the card at once
    (65, 2, 256, 64): 2,  # a 2x2 mesh's shard: 130 (slot, kv head)s leave room
    (8, 4, 256, 64): 2,  # few slots at a short cache
    (300, 4, 512, 64): 1,  # 36 sub-tiles, but 1200 CTAs already fill the card
    (40, 4, 512, 64): 3,
    (8, 4, 2048, 64): 8,  # few slots over a long cache: 132 sub-tiles, capped at the portable cluster size
    (16, 4, 4096, 64): 6,  # 8 or 7 would not fit the card at once (3 CTAs an SM above 5)
    (33, 4, 4096, 64): 4,  # 5 would not fit (4 CTAs an SM up to 5)
}


@pytest.mark.parametrize("shape", sorted(CLUSTER_RULE))
def test_cluster_size_shares_only_long_work(shape):
    """A (slot, kv head) takes a cluster only where its shape allows more
    than SUBS_PER_CTA sub-tiles: then as many CTAs as keep each under it,
    at most MAX_CLUSTER (8, the portable size) and no more than fit the
    card at once at that cluster size's shared memory."""
    B, kvh, S_, K = shape
    C = cluster_size(B, kvh, S_, K)
    assert C == CLUSTER_RULE[shape]
    subs = -(-S_ // SUB) + -(-K // SUB)
    assert 1 <= C <= MAX_CLUSTER and (C == 1 or C * B * kvh <= ctas_per_sm(C) * SMS)
    assert C == 1 or (C - 1) * SUBS_PER_CTA < subs


@pytest.mark.parametrize("C,per_sm", [(1, 4), (2, 4), (5, 4), (6, 3), (8, 3)])
def test_cluster_ctas_an_sm_follow_shared_memory(C, per_sm):
    """Each rank's partial in rank 0's shared memory grows a CTA with its
    cluster: 4 fit an H100 SM up to clusters of 5 (57,008 bytes and 1 KB
    reserved, 4 x 58,032 <= 233,472), 3 above (58,568 at 6)."""
    assert ctas_per_sm(C) == per_sm


CSRC = Path(__file__).resolve().parent.parent / "surya_tpu_torch" / "csrc"


def kernel_constants() -> dict:
    """The int constants of csrc/decode_attn.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", (CSRC / "decode_attn.cu").read_text(), re.M):
        env[name] = eval(expr, {}, dict(env))  # noqa: S307 - integer expressions of the file's own constants
    return env


def test_cluster_model_constants_are_the_kernels():
    """The model of the cluster rule above uses the kernel's own constants,
    so the two cannot drift apart unnoticed."""
    c = kernel_constants()
    assert (c["SUB"], c["SUBS_PER_CTA"], c["MAX_CLUSTER"], c["MIN_CTAS"]) == (SUB, SUBS_PER_CTA, MAX_CLUSTER, MIN_CTAS)
    assert (c["NWARP"], c["NSLOT"], c["G"], c["HD"]) == (WARPS, 6, G, D)


@pytest.mark.parametrize("source,rule", [("decode_attn.cu", kernel_variants.DECODE_RULE),
                                         ("flash_attn.cu", kernel_variants.CAUSAL_RULE)], ids=["K3", "K2"])
def test_kernel_variants_find_the_launch_rules(source, rule):
    """kernel_variants.py times other launches by putting a return at the
    top of each rule's function: each must appear once in its source."""
    assert (CSRC / source).read_text().count(rule) == 1


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_ranks_without_blocks_take_part_and_contribute_nothing(quantized):
    """With 8 CTAs a (slot, kv head), a slot of length 0 at step 10 has one
    sub-tile: 7 ranks send the merging CTA a partial with l = 0; whatever
    their accumulator places hold (NaN here) never reaches the output, which
    equals the plain version's."""
    K, step = 80, 10
    q, kc, vc, lens, ck, cv, scales = _inputs(K, quantized)
    ck, cv = _chunk_beyond(ck, cv, step, 1e3)
    targs = (_t(q), _t(kc), _t(vc), _t(lens), _t(ck), _t(cv), step, 0)
    tsc = tuple(_t(s).to(torch.bfloat16) for s in scales) if quantized else ()
    assert sum(not r for r in rank_subtiles(0, step, 8)) == 7
    ours = cluster_decode(*targs, *tsc, C=8, idle_acc=float("nan"))
    assert torch.isfinite(ours).all()
    assert (ours - decode_attn.gqa_decode(*targs, *tsc)).abs().max().item() < TOL


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("S_,K,step,C", [(512, 64, 37, 1), (512, 64, 63, 2), (2048, 40, 39, 5)])
def test_long_caches_through_the_ring(quantized, S_, K, step, C):
    """Caches of 512 and 2048 rows: a CTA walks up to 35 (C = 1) or 27 (C =
    5) sub-tiles, each warp through its 3 slots, and the model equals the
    plain version and the Pallas kernel."""
    rng = np.random.default_rng(7)
    B = 4
    lengths = np.array([0, 130, S_ - 1, S_], np.int32)
    q = rng.standard_normal((B, G * KVH, D), dtype=np.float32)
    kc, vc = (rng.standard_normal((1, B, KVH, S_, D), dtype=np.float32) * 0.3 for _ in range(2))
    ck, cv = (rng.standard_normal((1, B, KVH, K, D), dtype=np.float32) * 0.3 for _ in range(2))
    jsc, tsc = (), ()
    if quantized:
        (kq, ks), (vq, vs) = jax_decoder.quantize_kv(jnp.asarray(kc)), jax_decoder.quantize_kv(jnp.asarray(vc))
        kc, vc = np.array(kq), np.array(vq)
        jsc = (ks, vs)
        tsc = tuple(_t(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (ks, vs))
    assert max(len(r) for r in rank_subtiles(S_, step, C)) == -(-(S_ // SUB + step // SUB + 1) // C)
    targs = (_t(q), _t(kc), _t(vc), _t(lengths), _t(ck), _t(cv), step, 0)
    ours = cluster_decode(*targs, *tsc, C=C).numpy()
    plain = decode_attn.gqa_decode(*targs, *tsc).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths), jnp.asarray(ck),
             jnp.asarray(cv), jnp.int32(step), 0)
    pallas = np.asarray(jax_decode.gqa_decode_pallas(*jargs, *jsc, block_s=64, interpret=True))
    for other in (plain, pallas):
        assert np.abs(ours - other).max() < TOL


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
    "8 kv heads of 2 query heads": (dict(q=torch.zeros((2, 2 * 8, D), dtype=torch.bfloat16),
                                         k_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                                         v_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                                         chunk_k=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                                         chunk_v=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                                         k_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16),
                                         v_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)), ValueError,
                                    "3 query heads per kv head"),
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


def test_decode_check_takes_8_kv_heads():
    """The grid has a kv head axis of its own, so 8 kv heads (a CTA held 4
    before, one warp each) pass the check."""
    eight = _decode_args(q=torch.zeros((2, G * 8, D), dtype=torch.bfloat16),
                         k_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                         v_cache=torch.zeros((1, 2, 8, 16, D), dtype=torch.int8),
                         chunk_k=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                         chunk_v=torch.zeros((1, 2, 8, 8, D), dtype=torch.bfloat16),
                         k_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16),
                         v_scale=torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16))
    assert decode_attn._check_decode("gqa_decode_int8", **eight) == (0, 0)
