"""K1's key spans and K2's plain version at the decoder's own heads, on the CPU.

The K1 kernel walks, for each 16 query rows, only a span of keys that it
finds on the card (``warp_span`` in csrc/flash_attn.cu). ``kv_tile_spans``
below is the same rule in plain torch. On layout plans from the JAX
``plan_layout`` the spans must stay inside each query chunk's window and
cover every (query, key) pair of equal group id there; attention restricted
to the spans must then equal the plain version (float32, 1e-5 max-abs: the
same sums over fewer masked keys). The rule holds only for groups that are
contiguous runs of slots, so a layout with a split group is refused. The
plain K2 is held against the Pallas kernel in interpret mode at 12/4 heads,
D = 128 (1e-5 max-abs, float32).

``causal_tiles`` is the K2 kernel's schedule in plain torch: one CTA for
each (batch row, kv head, run of 64-row blocks) serving the kv head's 3
query heads; rows and keys zero-padded to whole 64-row tiles as TMA pads
them; row block i walks key tiles 0..i only, the diagonal tile masked with
the NEG_INF sentinel; online softmax in the log2 domain; P V with P as its
bf16 value plus its rounding error. It is held against the plain version
and the Pallas kernel (1e-5 max-abs, float32) at L = 128 and 256, at padded
lengths, and with one row block or all of them a CTA. The wrappers'
argument checks refuse what the CUDA kernels do not take; the kernels
themselves run only on the card (chip_smoke.py).
"""

import math

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import qwen_encoder as jax_encoder
from surya_tpu.ops import flash as jax_flash
from surya_tpu_torch.models import qwen_encoder
from surya_tpu_torch.ops import flash

torch.set_num_threads(1)
TOL = 1e-5
SPAN_ROWS = 16  # query rows per key span: one warp's rows in the K1 kernel


def kv_tile_spans(group_id, kv_starts, kv_range: int, q_tile: int = SPAN_ROWS):
    """The keys [lo, hi) that each q_tile-row query tile [r0, r0 + q_tile)
    can attend: from the start of the group run holding r0 to the end of the
    run holding its last row, clipped to the tile's window [kv0, kv0 +
    kv_range) (kv0 = kv_starts[r0 // 128], clamped as K1 clamps it); the
    whole window for a tile that does not lie inside it, where a row without
    a valid key averages the window as the plain version does. Returns int32
    [S / q_tile, 2]."""
    S = group_id.shape[0]
    kv_range = min(int(kv_range), S)
    idx = torch.arange(S)
    edge = torch.ones(1, dtype=torch.bool)
    change = group_id[1:] != group_id[:-1]
    run_start = torch.where(torch.cat([edge, change]), idx, 0).cummax(0).values
    run_end = torch.where(torch.cat([change, edge]), idx + 1, S).flip(0).cummin(0).values.flip(0)
    r0 = idx[::q_tile]
    kv0 = kv_starts.long()[r0 // flash.PLAN_CHUNK].clamp(0, S - kv_range)
    kv1 = kv0 + kv_range
    inside = (r0 >= kv0) & (r0 + q_tile <= kv1)
    lo = torch.where(inside, torch.maximum(run_start[r0], kv0), kv0)
    hi = torch.where(inside, torch.minimum(run_end[r0 + q_tile - 1], kv1), kv1)
    return torch.stack([lo, hi], 1).to(torch.int32)


def _plan(name):
    """(plan, S) of a layout plan from the JAX package."""
    cfg = jax_encoder.EncoderConfig()
    if name == "grids":  # the ranged-window grids of test_torch_kernels
        grids, cap = [(8, 60), (4, 40), (6, 30), (4, 64), (8, 40), (2, 30)], 2048
    elif name == "lines":  # a whole page: many 1-cell-tall line crops, 16-patch windows
        widths = np.random.default_rng(0).integers(20, 70, 40) * 2
        grids, cap = [(2, int(w)) for w in widths], 8192
    else:  # "pads": a few images, then more than half the slots padding
        grids, cap = [(4, 40), (6, 24), (2, 30)], 1024
    plan = jax_encoder.plan_layout(grids, cfg, cap)
    return plan, cap


def _case(plan_name, kind):
    """(group ids, kv_starts, kv_range) of one attention kind of a plan."""
    plan, S = _plan(plan_name)
    if kind == "full":
        return plan.seg_id, plan.kv_starts, plan.kv_range
    if kind == "window":
        return plan.win_id, plan.win_starts, plan.win_range
    return plan.seg_id, np.zeros(S // 128, np.int32), S  # "unranged"


CASES = [(p, kind) for p in ("grids", "lines", "pads") for kind in ("full", "window", "unranged")]


def test_plans_have_the_shapes_the_cases_name():
    lines, _ = _plan("lines")
    assert lines.kv_range < 8192 and lines.win_range < 8192
    _, win_sizes = np.unique(lines.win_id[lines.win_id >= 0], return_counts=True)
    assert win_sizes.max() == 16  # 1-cell-tall windows of 4 cells
    pads, S = _plan("pads")
    assert pads.n_patches < S // 2 and pads.seg_id[-1] == -2 - (S // 128 - 1)


@pytest.mark.parametrize("q_tile", [16, 64])
@pytest.mark.parametrize("plan_name,kind", CASES)
def test_kv_tile_spans_cover_every_pair_inside_the_window(plan_name, kind, q_tile):
    gid, starts, kv_range = _case(plan_name, kind)
    S = gid.shape[0]
    spans = kv_tile_spans(torch.from_numpy(gid), torch.from_numpy(starts), kv_range, q_tile).numpy()
    assert spans.shape == (S // q_tile, 2) and spans.dtype == np.int32
    keys = np.arange(S)
    for t, (lo, hi) in enumerate(spans):
        r0 = t * q_tile
        kv0 = min(max(int(starts[r0 // 128]), 0), S - kv_range)
        assert kv0 <= lo < hi <= kv0 + kv_range  # never leaves the window
        in_window = (keys >= kv0) & (keys < kv0 + kv_range)
        for r in range(r0, r0 + q_tile):
            needed = keys[in_window & (gid == gid[r])]
            assert needed.size and lo <= needed.min() and needed.max() < hi, (t, r)


@pytest.mark.parametrize("plan_name,kind", CASES)
def test_attention_inside_the_spans_equals_the_plain_version(plan_name, kind):
    """What the kernel computes: each 16 query rows attend only the keys of
    their span, masked by group id."""
    gid, starts, kv_range = _case(plan_name, kind)
    S, H, D = gid.shape[0], 2, 16
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, H, D), dtype=np.float32)) for _ in range(3))
    g = torch.from_numpy(gid)
    spans = kv_tile_spans(g, torch.from_numpy(starts), kv_range)
    out = torch.empty_like(q)
    for t, (lo, hi) in enumerate(spans.tolist()):
        rows = slice(t * SPAN_ROWS, (t + 1) * SPAN_ROWS)
        logits = torch.einsum("qhd,khd->hqk", q[rows], k[lo:hi]) * D**-0.5
        logits = logits.masked_fill(~(g[rows, None] == g[None, lo:hi]), flash.NEG_INF)
        out[rows] = torch.einsum("hqk,khd->qhd", logits.softmax(-1), v[lo:hi])
    ref = flash.segmented_block_attention_reference(q, k, v, g, torch.from_numpy(starts), kv_range)
    assert (out - ref).abs().max().item() < TOL


def test_kv_tile_spans_outside_the_window_take_the_whole_window():
    """A query tile its chunk's window does not hold (no plan_layout plan
    makes one) walks the whole window, where the plain version averages."""
    gid = np.repeat(np.arange(4, dtype=np.int32), 64)
    starts = np.array([128, 128], np.int32)
    spans = kv_tile_spans(torch.from_numpy(gid), torch.from_numpy(starts), 128).numpy()
    assert spans[:8].tolist() == [[128, 256]] * 8  # rows 0..127 lie outside [128, 256)
    assert spans[8:].tolist() == [[128, 192]] * 4 + [[192, 256]] * 4


@pytest.mark.parametrize("field", ["seg_id", "win_id"])
def test_layout_with_a_split_group_is_refused(field):
    """A group in two runs of slots would lose the keys of one run in K1, so
    the port's layout refuses it; plan_layout's own plans pass."""
    plan = qwen_encoder.plan_layout([(4, 40), (6, 24), (2, 30)], qwen_encoder.EncoderConfig(), 1024)
    ids = getattr(plan, field).copy()
    first = ids[0]
    ids[plan.n_patches - 1] = first  # the last real slot joins the first group
    with pytest.raises(ValueError, match="more than one run"):
        dataclasses.replace(plan, **{field: ids})


@pytest.mark.parametrize("L", [128, 256])
def test_causal_flash_attention_decoder_heads(L):
    """The plain K2 against the Pallas kernel at the recognition decoder's
    heads: 12 query heads over 4 kv heads, head dim 128."""
    rng = np.random.default_rng(4)
    B, H, kvh, D = 2, 12, 4, 128
    q = rng.standard_normal((B, L, H, D), dtype=np.float32) * 0.3
    k = rng.standard_normal((B, L, kvh, D), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, L, kvh, D), dtype=np.float32) * 0.3
    expected = np.asarray(
        jax_flash.causal_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    )
    before = flash.causal_flash_attention.launches
    out = flash.causal_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert flash.causal_flash_attention.launches == before  # CPU tensors take the plain version
    assert np.abs(out.numpy() - expected).max() < TOL


K2_BLOCK = 64  # rows of a Q tile and keys of a K/V tile: BLOCK in csrc/flash_attn.cu
NEG_INF = -1e30


def split_bf16(p):
    """p as the kernel feeds it to P V: its bf16 value and the bf16 of what that leaves out."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def causal_tiles(q, k, v, rows_per_cta=0, two_terms=True):
    """K2's schedule, float32: q [B, L, H, D], k/v [B, L, kvh, D] -> [B, L,
    H, D] and the number of (row block, key tile) steps each CTA's heads
    walked. rows_per_cta: 64-row blocks of a CTA, 0 for all of them;
    two_terms=False feeds P V the bf16 P alone."""
    B, L, H, D = q.shape
    kvh = k.shape[2]
    g = H // kvh
    nb = -(-L // K2_BLOCK)
    rb = rows_per_cta or nb
    pad = nb * K2_BLOCK - L  # TMA reads past L as zeros

    def tiles(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nb, K2_BLOCK, x.shape[2], D).permute(0, 3, 1, 2, 4)  # [B, heads, nb, 64, D]

    qt = tiles(q).reshape(B, kvh, g, nb, K2_BLOCK, D)
    kt, vt = tiles(k), tiles(v)  # [B, kvh, nb, 64, D]
    scale_log2 = D**-0.5 * math.log2(math.e)
    diag = torch.arange(K2_BLOCK)[None, :] <= torch.arange(K2_BLOCK)[:, None]  # key c valid for row r
    out = torch.empty_like(qt)
    steps = []
    for i0 in range(0, nb, rb):  # a CTA (of every batch row and kv head): row blocks [i0, i0 + rb)
        walked = 0
        for i in range(i0, min(nb, i0 + rb)):
            rows = qt[:, :, :, i]  # [B, kvh, g, 64, D]: the CTA's 3 heads
            m = torch.full(rows.shape[:-1], NEG_INF)
            l = torch.zeros(rows.shape[:-1])
            acc = torch.zeros(rows.shape)
            for j in range(i + 1):  # causal tiles only
                s = torch.einsum("bhgrd,bhcd->bhgrc", rows, kt[:, :, j]) * scale_log2
                if j == i:
                    s = s.masked_fill(~diag, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                hi, lo = split_bf16(p)
                lo = lo if two_terms else torch.zeros_like(lo)
                acc = acc * corr[..., None] + torch.einsum("bhgrc,bhcd->bhgrd", hi, vt[:, :, j]) + \
                    torch.einsum("bhgrc,bhcd->bhgrd", lo, vt[:, :, j])
                m = m_new
                walked += 1
            out[:, :, :, i] = acc / l[..., None]
        steps.append(walked)
    out = out.reshape(B, H, nb * K2_BLOCK, D).permute(0, 2, 1, 3)[:, :L]  # rows past L are not stored
    return out, steps


def _causal_inputs(B, L, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, 12, 128), dtype=np.float32) * 0.3,
            rng.standard_normal((B, L, 4, 128), dtype=np.float32) * 0.3,
            rng.standard_normal((B, L, 4, 128), dtype=np.float32) * 0.3)


@pytest.mark.parametrize("rows_per_cta", [0, 1], ids=["all_rows", "one_block"])
@pytest.mark.parametrize("L", [128, 256, 200, 65])
def test_causal_tiles_match_the_plain_version_and_pallas(L, rows_per_cta):
    """The per-kv-head schedule at the decoder's heads (12/4, D = 128):
    L = 128 and 256, and lengths that end inside a tile (its rows padded
    with zeros), against the plain K2 and the Pallas kernel."""
    q, k, v = _causal_inputs(2, L)
    ours, _ = causal_tiles(*(torch.from_numpy(a) for a in (q, k, v)), rows_per_cta)
    plain = flash.causal_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    pallas = np.asarray(
        jax_flash.causal_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    assert ours.shape == plain.shape
    for other in (plain.numpy(), pallas):
        assert np.abs(ours.numpy() - other).max() < TOL


@pytest.mark.parametrize("L,rows_per_cta,steps", [(128, 0, [3]), (128, 1, [1, 2]), (256, 0, [10]),
                                                  (256, 1, [1, 2, 3, 4]), (200, 0, [10])])
def test_causal_tiles_walk_only_tiles_at_or_below_the_diagonal(L, rows_per_cta, steps):
    """Row block i takes key tiles 0..i: a CTA of all 2 (4) row blocks
    walks 3 (10) tile steps for each of its heads, one of one block walks
    i + 1. The CTAs of one (batch row, kv head) cover every row block once."""
    q, k, v = (torch.zeros(1, L, h, 128) for h in (12, 4, 4))
    _, walked = causal_tiles(q, k, v, rows_per_cta)
    assert walked == steps


def test_causal_tiles_split_p_into_two_bf16_terms():
    """P V with P as one bf16 term moves the output past 1e-5 of the plain
    version; as two it stays inside, which is why the kernel pays a second
    product."""
    q, k, v = (torch.from_numpy(a) for a in _causal_inputs(2, 128, seed=9))
    p = torch.rand(2, 64, 64)
    hi, lo = split_bf16(p)
    assert (hi + lo - p).abs().max().item() < 2**-16 * p.abs().max().item()
    assert (hi - p).abs().max().item() > 2**-10 * p.abs().max().item()
    plain = flash.causal_flash_attention(q, k, v)
    assert (causal_tiles(q, k, v)[0] - plain).abs().max().item() < TOL
    assert (causal_tiles(q, k, v, two_terms=False)[0] - plain).abs().max().item() > TOL


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


SEGMENTED_BAD = {
    "head dim": ((256, 2, 64), 256, (256,), (2,), ValueError, "head dim 80"),
    "S not a multiple of 128": ((192, 2, 80), 192, (192,), (1,), ValueError, "multiple of 128"),
    "kv_range": ((256, 2, 80), 0, (256,), (2,), ValueError, "positive"),
    "seg_id length": ((256, 2, 80), 256, (128,), (2,), ValueError, "do not match"),
    "kv_starts length": ((256, 2, 80), 256, (256,), (1,), ValueError, "do not match"),
}


@pytest.mark.parametrize("case", sorted(SEGMENTED_BAD))
def test_segmented_check_refuses(case):
    shape, kv_range, seg_shape, starts_shape, err, match = SEGMENTED_BAD[case]
    q = _bf16(*shape)
    seg = torch.zeros(seg_shape, dtype=torch.int32)
    starts = torch.zeros(starts_shape, dtype=torch.int32)
    with pytest.raises(err, match=match):
        flash._check_segmented("k1", q, q, q, seg, starts, kv_range)


def test_segmented_check_refuses_types():
    q, seg, starts = _bf16(256, 2, 80), torch.zeros(256, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    assert flash._check_segmented("k1", q, q, q, seg, starts, 1024) == 256  # clipped to S
    with pytest.raises(TypeError, match="int32"):
        flash._check_segmented("k1", q, q, q, seg.long(), starts, 256)
    with pytest.raises(TypeError, match="bfloat16"):
        flash._check_segmented("k1", q.float(), q, q, seg, starts, 256)
    with pytest.raises(ValueError, match="shapes differ"):
        flash._check_segmented("k1", q, _bf16(256, 3, 80), q, seg, starts, 256)


CAUSAL_BAD = {
    "head dim": ((1, 128, 12, 64), (1, 128, 4, 64), "head dim 128"),
    "heads not a multiple of kv heads": ((1, 128, 12, 128), (1, 128, 5, 128), "bad shapes"),
    "kv length": ((1, 128, 12, 128), (1, 64, 4, 128), "bad shapes"),
    "2 query heads per kv head": ((1, 128, 8, 128), (1, 128, 4, 128), "3 query heads per kv head"),
    "6 query heads per kv head": ((1, 128, 12, 128), (1, 128, 2, 128), "3 query heads per kv head"),
}


@pytest.mark.parametrize("case", sorted(CAUSAL_BAD))
def test_causal_check_refuses(case):
    q_shape, kv_shape, match = CAUSAL_BAD[case]
    with pytest.raises(ValueError, match=match):
        flash._check_causal("k2", _bf16(*q_shape), _bf16(*kv_shape), _bf16(*kv_shape))


def test_causal_check_refuses_layouts():
    q, kv = _bf16(2, 128, 12, 128), _bf16(2, 128, 4, 128)
    flash._check_causal("k2", q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash._check_causal("k2", _bf16(128, 2, 12, 128).transpose(0, 1), kv, kv)
    with pytest.raises(TypeError, match="bfloat16"):
        flash._check_causal("k2", q.float(), kv, kv)


def test_wrappers_refuse_meta_tensors_of_the_decoder_shapes():
    """Only CPU tensors take the plain version; a tensor on any other device
    that is not CUDA raises, whatever its shape."""
    q = torch.empty((2, 128, 12, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 128, 4, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash.causal_flash_attention(q, kv, kv)
    qs = torch.empty((256, 16, 80), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((256,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash.segmented_block_attention(qs, qs, qs, seg, seg[:2], 256)
