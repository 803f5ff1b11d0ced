"""K1's key spans and schedule, and K2's plain version at the decoder's own heads, on the CPU.

The K1 kernel walks, for each 64 query rows (a warpgroup's), only a span of
keys that it finds on the card (csrc/flash_attn.cu). ``kv_tile_spans``
below is the same rule in plain torch. On layout plans from the JAX
``plan_layout`` the spans must stay inside each query chunk's window and
cover every (query, key) pair of equal group id there; attention restricted
to the spans must then equal the plain version (float32, 1e-5 max-abs: the
same sums over fewer masked keys). The rule holds only for groups that are
contiguous runs of slots, so a layout with a split group is refused. The
plain K2 is held against the Pallas kernel in interpret mode at 12/4 heads,
D = 128 (1e-5 max-abs, float32).

``segmented_tiles`` is the K1 kernel's schedule in plain torch: one item for
each 128-row plan chunk and head (the kernel's persistent CTAs walk them in
turn; the order changes no sum); each row's valid keys found as the kernel
finds them (``row_intervals``: its group's run, from the changes of group id
among the chunk's rows and scans outwards from them, clipped to the window);
each 64-row warpgroup's span from those, the item walking the union of the
two in 64-key tiles and a warpgroup computing only the tiles that meet its
span; keys inside a row's interval valid, the rest the NEG_INF sentinel and
those past the union's end weight 0; keys past S read as TMA's zeros;
online softmax in the log2 domain; P V with P as its bf16 value plus its
rounding error. It is held against the plain version and the Pallas kernel
in interpret mode (1e-5 max-abs, float32) on the plans above and on edge
layouts (rows outside their window, windows that are no multiple of 64,
clamped starts, groups of 1 to 300 slots).

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
import re
from pathlib import Path

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import qwen_encoder as jax_encoder
from surya_tpu.ops import flash as jax_flash
from surya_tpu_torch.models import qwen_encoder
from surya_tpu_torch.ops import _build, flash

import chip_smoke
import kernel_variants

torch.set_num_threads(1)
TOL = 1e-5
SPAN_ROWS = 64  # query rows per key span: one warpgroup's rows in the K1 kernel (wgmma's m64)


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
    """What the kernel computes: each 64 query rows attend only the keys of
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
    assert spans[:2].tolist() == [[128, 256]] * 2  # rows 0..127 lie outside [128, 256)
    assert spans[2:].tolist() == [[128, 192], [192, 256]]


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


# -- K1's schedule on Hopper ---------------------------------------------------

K1_ROWS = 128  # query rows of an item: one plan chunk (PLAN_CHUNK in csrc/flash_attn.cu)
K1_WG_ROWS = 64  # query rows of a consumer warpgroup: wgmma's m64
K1_BK = 64  # keys of a K/V tile: SEG_BK there
CSRC = Path(flash.__file__).resolve().parent.parent / "csrc"


def row_intervals(gid: np.ndarray, q0: int, kv0: int, kv1: int):
    """Each row of the chunk [q0, q0 + 128)'s valid keys [lo, hi), found as
    the kernel finds them: the group run holding the chunk's first row
    starts where a scan down from q0 - 1 first meets another id (kv0 at the
    latest), the run holding its last row ends where a scan up from q0 + 128
    does (kv1 at the latest); a row's run starts at the last change of id
    among the chunk's rows at or before it and ends at the first after it.
    Both ends are clipped to the window [kv0, kv1); the interval is empty
    for a row whose run the window misses."""
    a = kv0
    if q0 > kv0:
        j = q0 - 1
        while j >= kv0 and gid[j] == gid[q0]:
            j -= 1
        a = j + 1
    last, b = q0 + K1_ROWS - 1, kv1
    if last + 1 < kv1:
        j = last + 1
        while j < kv1 and gid[j] == gid[last]:
            j += 1
        b = j
    rows = gid[q0:q0 + K1_ROWS]
    starts = np.flatnonzero(rows[1:] != rows[:-1]) + 1
    edges = np.concatenate([[a - q0], starts, [b - q0]])
    before = np.searchsorted(starts, np.arange(K1_ROWS), side="right")
    return np.maximum(q0 + edges[before], kv0), np.minimum(q0 + edges[before + 1], kv1)


def warpgroup_spans(gid: np.ndarray, kv_starts: np.ndarray, kv_range: int, c: int):
    """(kv0, kv1, the rows' intervals, each warpgroup's span) of chunk c: a
    warpgroup's span runs from its first row's interval start to its last
    row's end, or is the whole window where its rows do not lie inside it."""
    S = gid.shape[0]
    q0 = c * K1_ROWS
    kv0 = min(max(int(kv_starts[c]), 0), S - kv_range)
    kv1 = kv0 + kv_range
    lo_r, hi_r = row_intervals(gid, q0, kv0, kv1)
    spans = []
    for g in range(K1_ROWS // K1_WG_ROWS):
        r0 = q0 + K1_WG_ROWS * g
        inside = r0 >= kv0 and r0 + K1_WG_ROWS <= kv1
        spans.append((int(lo_r[K1_WG_ROWS * g]), int(hi_r[K1_WG_ROWS * (g + 1) - 1])) if inside else (kv0, kv1))
    return kv0, kv1, lo_r, hi_r, spans


def segmented_tiles(q, k, v, group_id, kv_starts, kv_range: int, two_terms=True, past_s=0.0):
    """K1's schedule, float32: q/k/v [S, H, D] -> ([S, H, D], for each chunk
    (the union's tiles, [tiles each warpgroup computed])). two_terms=False
    feeds P V the bf16 P alone; past_s: what the rows past S hold (TMA reads
    zeros there)."""
    S, H, D = q.shape
    kv_range = min(int(kv_range), S)
    gid, starts = np.asarray(group_id), np.asarray(kv_starts)
    kp, vp = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, K1_BK), value=past_s) for x in (k, v))
    scale_log2 = D**-0.5 * math.log2(math.e)
    out = torch.empty(S, H, D)
    walked = []
    for c in range(S // K1_ROWS):
        _, _, lo_r, hi_r, spans = warpgroup_spans(gid, starts, kv_range, c)
        lo, hi = min(s[0] for s in spans), max(s[1] for s in spans)
        counts = []
        for g, (s_lo, s_hi) in enumerate(spans):
            r0 = c * K1_ROWS + g * K1_WG_ROWS
            lr = torch.from_numpy(lo_r[g * K1_WG_ROWS:(g + 1) * K1_WG_ROWS])[:, None]
            hr = torch.from_numpy(hi_r[g * K1_WG_ROWS:(g + 1) * K1_WG_ROWS])[:, None]
            rows = q[r0:r0 + K1_WG_ROWS].float()
            m = torch.full((H, K1_WG_ROWS), NEG_INF)
            l = torch.zeros(H, K1_WG_ROWS)
            acc = torch.zeros(H, K1_WG_ROWS, D)
            tiles = range((s_lo - lo) // K1_BK, (s_hi - 1 - lo) // K1_BK + 1)
            for t in tiles:
                kt = lo + t * K1_BK
                keys = kt + torch.arange(K1_BK)[None, :]
                s = torch.einsum("rhd,khd->hrk", rows, kp[kt:kt + K1_BK]) * scale_log2
                s = torch.where((keys >= lr) & (keys < hr), s,
                                torch.where(keys < hi, torch.tensor(NEG_INF), torch.tensor(-math.inf)))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                p_hi, p_lo = split_bf16(p)
                p_lo = p_lo if two_terms else torch.zeros_like(p_lo)
                vt = vp[kt:kt + K1_BK]
                acc = acc * corr[..., None] + torch.einsum("hrk,khd->hrd", p_hi, vt) + \
                    torch.einsum("hrk,khd->hrd", p_lo, vt)
                m = m_new
            counts.append(len(tiles))
            out[r0:r0 + K1_WG_ROWS] = (acc * torch.where(l > 0, 1 / l, 0.0)[..., None]).permute(1, 0, 2)
        walked.append((-(-(hi - lo) // K1_BK), counts))
    return out, walked


def _qkv(S, H=2, D=80, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((S, H, D), dtype=np.float32) * 0.3) for _ in range(3))


def _pallas(q, k, v, gid, starts, kv_range, block_k):
    return np.asarray(jax_flash.segmented_block_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(gid), jnp.asarray(starts), kv_range,
        block_k=block_k, interpret=True))


@pytest.mark.parametrize("plan_name,kind", CASES)
def test_row_intervals_are_the_group_id_mask(plan_name, kind):
    """Inside the window, key j is in row r's interval exactly where
    gid[j] == gid[r]: the two integers a row stand for the group-id
    compare of every key, so the kernel reads no group id past its set-up.
    Every row inside the window has a valid key (itself)."""
    gid, starts, kv_range = _case(plan_name, kind)
    S = gid.shape[0]
    keys = np.arange(S)
    for c in range(S // K1_ROWS):
        kv0, kv1, lo_r, hi_r, _ = warpgroup_spans(gid, starts, kv_range, c)
        window = gid[kv0:kv1]
        for i, r in enumerate(range(c * K1_ROWS, (c + 1) * K1_ROWS)):
            in_interval = (keys[kv0:kv1] >= lo_r[i]) & (keys[kv0:kv1] < hi_r[i])
            assert np.array_equal(in_interval, window == gid[r]), (c, r)
            assert not (kv0 <= r < kv1) or lo_r[i] <= r < hi_r[i]


@pytest.mark.parametrize("plan_name,kind", CASES)
def test_warpgroup_spans_are_the_span_rule_and_meet(plan_name, kind):
    """The spans the kernel derives from its rows' intervals are
    ``kv_tile_spans`` at 64 rows, and an item's two spans overlap or touch,
    so each tile of their union meets at least one of them (every tile the
    producer loads is computed by some warpgroup)."""
    gid, starts, kv_range = _case(plan_name, kind)
    S = gid.shape[0]
    rule = kv_tile_spans(torch.from_numpy(gid), torch.from_numpy(starts), kv_range, K1_WG_ROWS).numpy()
    for c in range(S // K1_ROWS):
        (a0, a1), (b0, b1) = warpgroup_spans(gid, starts, kv_range, c)[4]
        assert [[a0, a1], [b0, b1]] == rule[2 * c:2 * c + 2].tolist()
        assert max(a0, b0) <= min(a1, b1), c


@pytest.mark.parametrize("plan_name,kind", CASES)
def test_segmented_tiles_match_the_plain_version_and_pallas(plan_name, kind):
    """The Hopper schedule at the encoder's head dim on layout plans: the
    grids of test_torch_kernels, a 40-line whole page and a plan ending in
    pads, each as full-attention, windowed and unranged blocks."""
    gid, starts, kv_range = _case(plan_name, kind)
    q, k, v = _qkv(gid.shape[0])
    ours, walked = segmented_tiles(q, k, v, gid, starts, kv_range)
    plain = flash.segmented_block_attention(q, k, v, torch.from_numpy(gid), torch.from_numpy(starts), kv_range)
    pallas = _pallas(q, k, v, gid, starts, kv_range, 128 if kind == "window" else 512)
    for other in (plain.numpy(), pallas):
        assert np.abs(ours.numpy() - other).max() < TOL
    assert all(1 <= n <= tiles for tiles, counts in walked for n in counts)


def _edge_layout(S, kv_range, seed, clamp, anywhere=0.5):
    """Contiguous groups of 1 to 300 slots; the other chunks start their
    window so that their rows lie inside it, a share `anywhere` of them
    anywhere: in [0, S - kv_range] at multiples of 8 (the Pallas kernel
    needs whole blocks), or with clamp in [-200, S), clamped as a dynamic
    slice clamps (the plain version clamps the same way)."""
    rng = np.random.default_rng(seed)
    gid = np.repeat(np.arange(S, dtype=np.int32), rng.integers(1, 301, S))[:S]
    n = S // K1_ROWS
    starts = np.clip(K1_ROWS * np.arange(n) - rng.integers(0, max(1, kv_range - K1_ROWS + 1), n), 0, S - kv_range)
    picked = rng.random(n) < anywhere
    starts = np.where(picked, rng.integers(-200, S, n) if clamp else rng.integers(0, S - kv_range + 1, n), starts)
    if not clamp:
        starts = starts // 8 * 8
    return gid, starts.astype(np.int32), picked


EDGES = {  # S, kv_range, clamped starts
    "outside_window_200_keys": (1024, 200, False),
    "clamped_1000_keys": (2048, 1000, True),
    "clamped_40_keys": (1024, 40, True),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_segmented_tiles_on_edge_layouts(case):
    """Where no layout plan takes K1: rows outside their window (a row with
    no valid key averages the window), windows of 200, 1000 and 40 keys (no
    multiple of 64; 40 shorter than a tile), starts clamped to [0, S -
    kv_range]. Against the plain version, and against the Pallas kernel
    where its starts are whole blocks of 8 inside the sequence."""
    S, kv_range, clamp = EDGES[case]
    gid, starts, picked = _edge_layout(S, kv_range, 0, clamp)
    q, k, v = _qkv(S)
    ours, _ = segmented_tiles(q, k, v, gid, starts, kv_range)
    plain = flash.segmented_block_attention(q, k, v, torch.from_numpy(gid), torch.from_numpy(starts), kv_range)
    assert np.abs(ours.numpy() - plain.numpy()).max() < TOL
    kv0 = np.clip(starts.astype(np.int64), 0, S - kv_range)
    rows = np.arange(S).reshape(-1, K1_ROWS)
    assert picked.any() and ((rows < kv0[:, None]) | (rows >= kv0[:, None] + kv_range)).any()
    if not clamp:
        assert np.abs(ours.numpy() - _pallas(q, k, v, gid, starts, kv_range, 8)).max() < TOL


def test_segmented_tiles_give_rows_past_the_union_and_s_weight_zero():
    """Keys past the union's end are real rows of other groups, and past S
    TMA reads zeros: both take weight 0, so what the rows past S hold never
    reaches the output (here 1e3 instead of zeros). Two groups, of rows
    0..99 and 100..255: the last chunk walks keys 100 to 291."""
    gid = np.repeat(np.array([0, 1], np.int32), [100, 156])
    starts, kv_range, S = np.zeros(2, np.int32), 256, 256
    _, _, _, _, spans = warpgroup_spans(gid, starts, kv_range, S // K1_ROWS - 1)
    lo, hi = min(s[0] for s in spans), max(s[1] for s in spans)
    assert hi == S and (hi - lo) % K1_BK  # the last tile holds rows past S
    q, k, v = _qkv(S)
    zeros, _ = segmented_tiles(q, k, v, gid, starts, kv_range)
    large, _ = segmented_tiles(q, k, v, gid, starts, kv_range, past_s=1e3)
    assert torch.equal(zeros, large)


def test_segmented_tiles_split_p_into_two_bf16_terms():
    """P V with P as one bf16 term moves K1's output past 1e-5 of the plain
    version on the whole-page windowed plan; as two it stays inside."""
    gid, starts, kv_range = _case("lines", "window")
    q, k, v = _qkv(gid.shape[0])
    plain = flash.segmented_block_attention(q, k, v, torch.from_numpy(gid), torch.from_numpy(starts), kv_range)
    assert (segmented_tiles(q, k, v, gid, starts, kv_range)[0] - plain).abs().max().item() < TOL
    assert (segmented_tiles(q, k, v, gid, starts, kv_range, two_terms=False)[0] - plain).abs().max().item() > TOL


@pytest.mark.parametrize("plan_name", ["grids", "lines", "pads"])
@pytest.mark.parametrize("kind", ["full", "window"])
def test_computed_pairs_follow_the_schedule(plan_name, kind):
    """chip_smoke.py's count of the pairs K1 computes (its ratio to the
    plan's is printed on the card) is the schedule's: 64 x 64 pairs for each
    tile a warpgroup computes, and never fewer than the plan needs."""
    gid, starts, kv_range = _case(plan_name, kind)
    S = gid.shape[0]
    q = torch.zeros(S, 1, 16)
    _, walked = segmented_tiles(q, q, q, gid, starts, kv_range)
    done = K1_WG_ROWS * K1_BK * sum(sum(counts) for _, counts in walked)
    assert chip_smoke.computed_pairs(gid, starts, kv_range) == done
    _, sizes = np.unique(gid[gid >= 0], return_counts=True)
    assert done >= int((sizes.astype(np.int64) ** 2).sum())


def flash_constants() -> dict:
    """The int constants of csrc/flash_attn.cu that are integer expressions
    of the file's own constants, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", (CSRC / "flash_attn.cu").read_text(), re.M):
        try:
            env[name] = eval(expr, {}, dict(env))  # noqa: S307 - integer expressions of the file's own constants
        except (NameError, SyntaxError):
            continue
    return env


def test_k1_model_constants_are_the_kernels():
    """The schedule above uses the kernel's own constants, and the wrapper's
    plan chunk and head dim are the kernel's."""
    c = flash_constants()
    assert (c["PLAN_CHUNK"], c["SEG_BK"], c["SEG_D"]) == (K1_ROWS, K1_BK, flash.SEGMENTED_HEAD_DIM)
    assert c["PLAN_CHUNK"] == flash.PLAN_CHUNK == c["SEG_WG"] * K1_WG_ROWS
    assert c["SEG_TILE_BYTES"] == K1_WG_ROWS * flash.SEGMENTED_HEAD_DIM * 2  # the two boxes hold a whole row


def test_k1_shared_memory_and_registers_fit_one_cta_an_sm():
    """K1 is persistent, one CTA an SM: its shared memory (the Q tiles of
    SEG_QBUF items, the K/V ring, two item slots of the rows' intervals and
    spans, the barriers, 1 KB to align it) fits what an H100 block may ask
    for (227 KB), and setmaxnreg only moves registers inside the CTA: the
    producer warpgroup gives back what the two consumer warpgroups take,
    from the 168 a thread ptxas gives a CTA of 384 threads."""
    c = flash_constants()
    tiles = (c["SEG_QBUF"] * c["SEG_WG"] + 2 * c["SEG_STAGES"]) * c["SEG_TILE_BYTES"]
    barriers = 8 * (3 * c["SEG_STAGES"] + 2 * c["SEG_QBUF"] + 4)
    slots = 2 * (2 * 4 * c["PLAN_CHUNK"] + 8 * c["SEG_WG"])
    assert tiles + barriers + slots + 1024 <= 227 * 1024
    assert c["SEG_THREADS"] == c["SEG_WG"] * 128 + 128
    launch = 65536 // c["SEG_THREADS"] // 8 * 8
    assert launch == 168
    assert 128 * c["SEG_PRODUCER_REGS"] + c["SEG_WG"] * 128 * c["SEG_CONSUMER_REGS"] == c["SEG_THREADS"] * launch


@pytest.mark.parametrize("variant", sorted(kernel_variants.K1_EDITS))
def test_kernel_variants_find_k1s_loads(variant):
    """kernel_variants.py --k1 times copies of K1 made by replacing lines of
    csrc/flash_attn.cu: each must occur there once."""
    text = (CSRC / "flash_attn.cu").read_text()
    for old, _ in kernel_variants.K1_EDITS[variant]:
        assert text.count(old) == 1, old


def test_build_signatures_are_the_c_entries():
    """Every C entry of csrc/*.cu has an argument list in _build.SIGNATURES
    of its own length, and nothing else is listed there."""
    entries = {}
    for src in CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            entries[name] = len([a for a in args.split(",") if a.strip()])
    assert entries == {name: len(argtypes) for name, argtypes in _build.SIGNATURES.items()}


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
