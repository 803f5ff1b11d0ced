"""Detection's stats and maps programs and recognition's prefill as
common/graphs.py runs them (``Program``, ``ProgramGraphs``, ``until``), on
the CPU in float32, through a stand-in of the CUDA graph: the AR loops'
(test_torch_graphs.StandInGraph), extended with a WHILE node whose capture
runs the body once and whose replay runs it while its bool holds, read on
the host.

- The component flood in a program, its loop a WHILE node, against the
  eager program and the JAX package's ``label_components`` and
  ``component_stats`` on seeded masks (random, a spiral, empty, full, a
  component across a chunk seam): labels, stats, n_comp and n_raw equal,
  and as many blocks of rounds as the host loop.
- Detection's stats program (with and without the device resize) and maps
  program through the stand-in store against the eager program and the JAX
  predictor's jitted ``forward_stats`` / ``forward_resize_stats`` /
  ``forward_resize`` at tiny EfficientViT width, on shared weights with the
  blob hook: counts equal, stats and thresholds within 1e-5 (the moments
  within 1e-4 relative: JAX sums them in float32), the maps
  within one uint8 level of JAX's and equal to the eager program's.
- Recognition's prefill wave, alone and fused with its decode chunk,
  through the stand-in against the eager path and the JAX predictor's
  jitted ``prefill_fn`` / ``prefill_decode_fn``: token ids, slot state and
  cache lengths equal, scores, boxes and cache bytes within 1e-4.
- The store: one capture per key, the heat hook's identity in the key,
  inputs copied into static buffers, K1's and K2's launches (and K1's by
  window length) credited once per replay, a failed capture raising without
  an eager run, prefill graphs dropped with a replaced slot-cache store,
  and CPU predictors building no graph.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.ops import connected_components as jcc
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu_torch.common import graphs
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.detection.util import get_total_splits, split_image
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.ops import connected_components as cc
from surya_tpu_torch.ops import flash
from surya_tpu_torch.recognition import RecognitionPredictor

from test_torch_graphs import StandInGraph

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
DET_ATOL = 1e-5
MOMENT_RTOL = 1e-4
MAX_COMPS = 64


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


class StandIn(StandInGraph):
    """The AR loops' stand-in, taking what the store's graphs share, with the warm-up
    of a program and a WHILE node: capture runs the body once (the launches
    it records are what a capture records), replay runs it while pred holds,
    read on the host."""

    def __init__(self, device, shared=None):
        super().__init__(device)
        self.shared = shared

    def run_once(self, fn):
        fn()

    def until(self, pred, body):
        if self.capturing:
            body()
            return
        while bool(pred):
            body()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(StandInGraph, "captures", 0)
    monkeypatch.setattr(StandInGraph, "fail", False)
    return StandIn


def program_store(stand_in):
    return graphs.ProgramGraphs(stand_in)


# -- the component flood under a WHILE node -----------------------------------

def _spiral(n=41):
    m = np.zeros((n, n), bool)
    lo, hi = 0, n - 1
    while lo < hi:
        m[lo, lo:hi + 1] = m[lo:hi + 1, hi] = m[hi, lo:hi + 1] = True
        m[lo + 2:hi + 1, lo] = True
        if lo + 2 <= hi - 2:
            m[lo + 2, lo:lo + 3] = True
        lo, hi = lo + 2, hi - 2
    return m


def _seam():
    """Two 24-row chunks stacked: a snake crosses the seam at row 24 twice."""
    m = np.zeros((48, 40), bool)
    m[20:30, 5] = m[29, 5:30] = m[18:30, 30] = m[18, 12:31] = m[18:40, 12] = True
    m[2:6, 2:38] = True  # a band of its own above
    return m


MASKS = {
    "random": lambda rng: rng.random((2, 37, 53)) < 0.45,
    "spiral": lambda rng: _spiral()[None],
    "empty": lambda rng: np.zeros((2, 16, 24), bool),
    "full": lambda rng: np.ones((1, 16, 24), bool),
    "chunk_seam": lambda rng: _seam()[None],
}


def _flood_program(heat, low):
    """component_stats and the flood's labels and blocks of one mask as a
    program: the plain test's body."""
    x = graphs.static_inputs({"heat": heat, "low": low}, "cpu")
    P, H, W = heat.shape
    out = {"stats": torch.empty((P, MAX_COMPS, cc.STATS_DIM)), "n_comp": torch.empty(P, dtype=torch.int32),
           "n_raw": torch.empty(P, dtype=torch.int32), "labels": torch.empty((P, H, W), dtype=torch.int64),
           "blocks": torch.empty((), dtype=torch.int32)}

    def body():
        stats, n_comp, n_raw = cc.component_stats(x["heat"], x["low"], max_comps=MAX_COMPS)
        labels, blocks = cc.flood(x["heat"] > x["low"][:, None, None])
        for name, t in zip(out, (stats, n_comp, n_raw, labels, blocks)):
            out[name].copy_(t)

    return graphs.Program(x, out, body)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_flood_while_node_matches_jax(stand_in, mask):
    rng = np.random.default_rng(sorted(MASKS).index(mask))
    m = MASKS[mask](rng)
    heat = np.where(m, rng.uniform(0.6, 1.0, m.shape), rng.uniform(0.0, 0.4, m.shape)).astype(np.float32)
    low = np.full(m.shape[0], 0.5, np.float32)
    inputs = {"heat": torch.from_numpy(heat), "low": torch.from_numpy(low)}
    store = program_store(stand_in)
    build = lambda: _flood_program(*inputs.values())  # noqa: E731
    graphed = {k: v.clone() for k, v in store.run("flood", build, inputs).items()}
    eager = graphs.EagerPrograms().run("flood", build, inputs)
    for name in graphed:
        assert torch.equal(graphed[name], eager[name]), name

    jstats, jn, jraw = (np.asarray(a) for a in jcc.component_stats(jnp.asarray(heat), jnp.asarray(low),
                                                                   max_comps=MAX_COMPS))
    assert np.array_equal(graphed["labels"].numpy(), np.asarray(jcc.label_components(jnp.asarray(m))))
    assert np.array_equal(graphed["n_comp"].numpy(), jn) and np.array_equal(graphed["n_raw"].numpy(), jraw)
    np.testing.assert_allclose(graphed["stats"].numpy(), jstats, rtol=1e-6, atol=0)
    blocks = int(graphed["blocks"])
    assert blocks > 1 if mask == "spiral" else blocks >= 1
    if mask == "chunk_seam":  # the snake across the seam is one component
        assert int(graphed["n_comp"][0]) == 2
    assert stand_in.captures == 1


def test_until_reads_its_bool_before_the_first_run(stand_in):
    """A WHILE node whose bool is false when it starts runs no body; one
    that the body clears after k runs runs k times, on the host as on the
    stand-in."""
    def program(start):
        x = {"n": torch.zeros((), dtype=torch.int32)}
        out = torch.zeros((), dtype=torch.int32)

        def body():
            pred = torch.tensor(start)
            runs = torch.zeros((), dtype=torch.int32)

            def step():
                runs.add_(1)
                pred.copy_(runs < x["n"])

            graphs.until(pred, step)
            out.copy_(runs)

        return graphs.Program(x, out, body)

    store = program_store(stand_in)
    for start, n, want in [(False, 3, 0), (True, 3, 3), (True, 0, 1)]:
        inputs = {"n": torch.tensor(n, dtype=torch.int32)}
        assert int(store.run(("u", start), lambda: program(start), inputs)) == want
        assert int(graphs.EagerPrograms().run(None, lambda: program(start), inputs)) == want


# -- detection's programs ---------------------------------------------------------

@pytest.fixture(scope="module")
def detectors():
    ref = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(ref)
    ours = DetectionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    efficientvit.install_blob_detector(ours)
    return ref, ours


def _pages():
    """A page of text lines and a tall page whose middle line crosses the
    896 px chunk seam."""
    page = Image.new("RGB", (700, 600), "white")
    draw = ImageDraw.Draw(page)
    for i in range(5):
        draw.text((40, 40 + i * 90), f"Line {i}: some text to detect.", fill="black", font_size=28)
    tall = Image.new("RGB", (900, 2000), "white")
    draw = ImageDraw.Draw(tall)
    for y in (300, 893, 1500):
        draw.rectangle((100, y - 9, 800, y + 9), fill="black")
    return [page, tall]


def _batch(det, images, resize: bool):
    """One detection batch's program inputs, as batch_detection builds them:
    (pixels, (Vs, Hs, gid) or None, page_gather, valid_rows, n_real)."""
    proc_h = det.processor_size[0]
    splits = [get_total_splits(im.size, proc_h) for im in images]
    parts, index, heights = [], [], []
    for i, im in enumerate(images):
        p, h = split_image(im.convert("RGB"), proc_h)
        parts += p
        index += [i] * len(p)
        heights += h
    rows = 1 << (len(parts) - 1).bit_length()
    if resize:
        pixels, (uniq, gid) = det._canvas(parts, rows)
        n_groups = 1 << (len(uniq) - 1).bit_length()
        Vs, Hs = det._resize_mats(uniq, n_groups, pixels.shape[1:3])
        mats = (Vs, Hs, torch.from_numpy(gid))
    else:
        pixels, mats = det._prepared(parts, rows), None
    page_gather, valid_rows = det._page_plan(index, heights, splits, list(range(len(images))))
    return pixels, mats, torch.from_numpy(page_gather), torch.from_numpy(valid_rows), len(parts)


@pytest.mark.parametrize("resize", [False, True], ids=["host_resize", "device_resize"])
def test_detection_stats_program_matches_eager_and_jax(detectors, stand_in, resize):
    ref, det = detectors
    pixels, mats, page_gather, valid_rows, _ = _batch(det, _pages(), resize)
    store = det.programs
    try:
        with torch.inference_mode():
            det.programs = program_store(stand_in)
            graphed = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS).clone()
            det.programs = graphs.EagerPrograms()
            eager = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS)
    finally:
        det.programs = store
    assert torch.equal(graphed, eager)

    args = (jnp.asarray(pixels.numpy()),)
    if resize:
        args += tuple(jnp.asarray(t.numpy()) for t in mats)
    fwd = ref._forward_resize_stats if resize else ref._forward_stats
    jstats, jn, jraw, jthr = (np.asarray(a) for a in fwd(
        ref.params, *args, jnp.asarray(page_gather.numpy()), jnp.asarray(valid_rows.numpy()), max_comps=MAX_COMPS))
    out = graphed.numpy()
    P = page_gather.shape[0]
    assert np.array_equal(out[:, -3], jn) and np.array_equal(out[:, -2], jraw)
    assert jn[:2].min() >= 3  # the lines were found: the comparison means something
    stats = out[:, :MAX_COMPS * cc.STATS_DIM].reshape(P, MAX_COMPS, cc.STATS_DIM)
    np.testing.assert_allclose(stats[..., :cc.SUM_X], jstats[..., :cc.SUM_X], rtol=0, atol=DET_ATOL)
    # the moments: the port sums integers exactly (int64), the JAX package in
    # float32, which rounds above 2^24 (a page's y^2 sums reach 1e9)
    np.testing.assert_allclose(stats[..., cc.SUM_X:], jstats[..., cc.SUM_X:], rtol=MOMENT_RTOL, atol=0)
    np.testing.assert_allclose(out[:, -1], jthr, rtol=0, atol=DET_ATOL)


def test_detection_maps_program_matches_eager_and_jax(detectors, stand_in):
    ref, det = detectors
    pixels, mats, _, _, n_real = _batch(det, _pages(), resize=True)
    store = det.programs
    try:
        with torch.inference_mode():
            det.programs = program_store(stand_in)
            graphed = det._maps_program(pixels, mats, n_real, 2).clone()
            det.programs = graphs.EagerPrograms()
            eager = det._maps_program(pixels, mats, n_real, 2)
    finally:
        det.programs = store
    assert torch.equal(graphed, eager)
    jmaps = np.asarray(ref._forward_resize(ref.params, jnp.asarray(pixels.numpy()),
                                           *(jnp.asarray(t.numpy()) for t in mats)))
    expected = jmaps[:n_real].transpose(0, 3, 1, 2).astype(np.int16)
    assert np.abs(graphed.numpy().astype(np.int16) - expected).max() <= 1


def test_heat_hook_is_part_of_the_key(stand_in):
    """A graph captured before install_blob_detector runs the old heat
    tail: the hook gives a key of its own, captured anew."""
    det = DetectionPredictor(tiny=True, device="cpu")
    det.programs = program_store(stand_in)
    pixels, mats, page_gather, valid_rows, _ = _batch(det, _pages()[:1], resize=True)
    with torch.inference_mode():
        before = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS).clone()
        efficientvit.install_blob_detector(det)
        after = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS).clone()
        again = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS)
    assert stand_in.captures == 2 and len(det.programs.programs) == 2
    assert not torch.equal(before, after) and int(after[0, -3]) >= 3 and torch.equal(after, again)


# -- recognition's prefill ------------------------------------------------------------

N_SLOTS, CACHE_LEN, K = 6, 256, 6


@pytest.fixture(scope="module")
def recognizers():
    ref = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
    ours = RecognitionPredictor(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, ref.params))
    return ref, ours


def _wave(pred, rng):
    """A prefill wave of 3 line crops into slots 4, 1 and 2 of N_SLOTS (5
    is the trash slot), at the 4-row bucket: (batch, slot_idx, row_valid)."""
    crops = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in ((28, 112), (56, 84), (28, 56))]
    imgs = [pred._prepare_image(c, "ocr_with_boxes") for c in crops]
    batch = pred.processor.build_prefill_batch(
        imgs, ["ocr_with_boxes"] * 3, [None] * 3, [True] * 3, pred.config.encoder, batch_rows=4,
        seq_buckets=pred.seq_buckets, patch_caps=pred.patch_caps, n_shards=1)
    slot_idx = np.full(4, N_SLOTS - 1, np.int32)
    slot_idx[batch.valid_rows] = [4, 1, 2]
    row_valid = np.zeros(4, bool)
    row_valid[batch.valid_rows] = True
    return batch, slot_idx, row_valid


def _start(cfg, rng):
    """A cache with random rows in the slots the wave does not fill, the
    slot state and a kill mask, as numpy arrays."""
    d = cfg.decoder
    shape = (d.num_hidden_layers, N_SLOTS, d.num_key_value_heads, CACHE_LEN, d.head_dim)
    lens = np.array([9, 0, 0, 17, 0, 0], np.int32)
    cache = {"k": (rng.standard_normal(shape) * (lens > 0)[None, :, None, None, None]).astype(np.float32),
             "v": (rng.standard_normal(shape) * (lens > 0)[None, :, None, None, None]).astype(np.float32),
             "len": lens}
    state = (np.array([300, 2, 2, 301, 2, 2], np.int32), np.array([1, 0, 0, 1, 0, 0], bool),
             np.array([1, 0, 0, 2, 0, 0], np.int32))
    kill = np.array([0, 0, 0, 1, 0, 0], bool)  # slot 3 was stopped by the host
    return cache, state, kill


class CacheRestoringStandIn(StandIn):
    """A loop's capture runs nothing on the card: the chunk that the
    stand-in's capture run commits to the cache is put back."""

    cache = None

    def capture(self, program):
        saved = {k: v.clone() for k, v in self.cache.items()}
        super().capture(program)
        for k, v in saved.items():
            self.cache[k].copy_(v)


@pytest.mark.parametrize("fuse", [False, True], ids=["prefill", "prefill_decode"])
@pytest.mark.parametrize("pin", [False, True], ids=["free", "pinned"])
def test_prefill_program_matches_eager_and_jax(recognizers, stand_in, monkeypatch, fuse, pin):
    ref, ours = recognizers
    rng = np.random.default_rng(3 + 2 * fuse + pin)
    batch, slot_idx, row_valid = _wave(ours, rng)
    cache0, state0, kill = _start(ours.config, rng)
    layout = batch.layout

    def run(programs, loops):
        cache = {k: torch.from_numpy(v.copy()) for k, v in cache0.items()}
        monkeypatch.setattr(CacheRestoringStandIn, "cache", cache)
        ours.programs, ours.loops = programs, loops
        state = tuple(torch.from_numpy(s.copy()) for s in state0)
        with torch.inference_mode():
            handle, state, _ = ours._dispatch_prefill(cache, batch, slot_idx, row_valid, state, kill, pin, fuse)
        return [np.asarray(a).copy() for a in ours._wait(handle)], [s.clone().numpy() for s in state], cache

    saved = (ours.programs, ours.loops)
    try:
        g_packed, g_state, g_cache = run(program_store(stand_in), graphs.LoopGraphs(CacheRestoringStandIn))
        e_packed, e_state, e_cache = run(graphs.EagerPrograms(), graphs.EagerLoops())
    finally:
        ours.programs, ours.loops = saved
    assert len(g_packed) == 1 + fuse and stand_in.captures == 1 + fuse
    for a, b in zip(g_packed + g_state, e_packed + e_state):
        assert np.array_equal(a, b)
    for key in g_cache:
        assert torch.equal(g_cache[key], e_cache[key]), key

    jcache = {k: jnp.asarray(v) for k, v in cache0.items()}
    args = (ref.params, jcache, jnp.asarray(batch.patches), tuple(jnp.asarray(a) for a in layout.device_args),
            jnp.asarray(layout.llm_h_idx), jnp.asarray(layout.llm_w_idx), jnp.asarray(batch.input_ids),
            jnp.asarray(batch.img_gather), jnp.asarray(batch.seq_lens), jnp.asarray(slot_idx),
            jnp.asarray(row_valid), *(jnp.asarray(s) for s in state0), jnp.asarray(kill))
    if fuse:
        jc, *jout = ref._prefill_decode_fn(*args, kv_range=layout.kv_range, win_range=layout.win_range,
                                           num_steps=ours.decode_chunk, pin=pin)
    else:
        jc, *jout = ref._prefill_fn(*args, kv_range=layout.kv_range, win_range=layout.win_range, pin=pin)
    jpacked, jstate = [np.asarray(a) for a in jout[:1 + fuse]], [np.asarray(a) for a in jout[1 + fuse:]]
    for ours_p, ref_p in zip(g_packed, jpacked):
        assert np.array_equal(ours_p[..., 0], ref_p[..., 0])  # token ids
        np.testing.assert_allclose(ours_p[..., 1:], ref_p[..., 1:], atol=ATOL, rtol=RTOL)
    for a, b in zip(g_state, jstate):
        assert np.array_equal(a, b)
    assert np.array_equal(g_cache["len"].numpy(), np.asarray(jc["len"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(g_cache[key].numpy(), np.asarray(jc[key], np.float32), atol=ATOL, rtol=RTOL)


def test_prefill_graphs_go_with_a_replaced_cache_store(stand_in):
    """A prefill graph writes the slot cache at its address: the store's
    replacement (a longer cache) drops the prefill graphs that read it, as
    it does the decode graphs."""
    rec = RecognitionPredictor(tiny=True, device="cpu")
    rec.programs = program_store(stand_in)
    page = Image.new("RGB", (240, 80), "white")
    [res] = rec([page], bboxes=[[[4, 4, 200, 40]]], recognition_batch_size=2)
    assert len(res.text_lines) == 1
    keys = list(rec.programs.programs)
    assert len(keys) == 1 and keys[0][0] == "prefill" and stand_in.captures == 1
    store = rec._kept_cache
    rec._keep_cache(rec._take_cache(store["len"].shape[0], store["k"].shape[3] + 256, False)[1])
    assert rec._kept_cache is not store and not rec.programs.programs


# -- the store ----------------------------------------------------------------------

def _toy_program(n=3):
    x = {"a": torch.zeros(n)}
    out = torch.zeros(n)
    return graphs.Program(x, out, lambda: out.copy_(x["a"] * 2 + 1))


def test_store_captures_once_per_key_and_copies_inputs(stand_in):
    store = program_store(stand_in)
    built = []

    def build(n):
        built.append(n)
        return _toy_program(n)

    for key, n, value in [("a", 3, 1.0), ("a", 3, 4.0), ("b", 5, 2.0), ("a", 3, -1.0)]:
        given = torch.full((n,), value)
        out = store.run(key, lambda n=n: build(n), {"a": given})
        assert out.tolist() == [2 * value + 1] * n
        static = store.programs[key].program.inputs["a"]
        assert static is not given and static.tolist() == given.tolist()
    assert stand_in.captures == len(built) == len(store.programs) == 2 and set(store.captures) == {"a", "b"}
    with pytest.raises(KeyError):
        store.run("a", _toy_program, {"other": torch.zeros(3)})


def test_store_under_threads_captures_each_key_once(stand_in):
    """More threads than cores run one store, two threads a key with the
    same inputs: each key is captured once (the check and the capture are
    one step under the store's lock) and every call reads its key's
    output."""
    import sys
    import threading

    store = program_store(stand_in)
    n_keys, per_key, calls = 4, 2, 40
    errors = []

    def work(k):
        try:
            for _ in range(calls):
                out = store.run(("k", k), lambda: _toy_program(3), {"a": torch.full((3,), float(k))})
                if out.tolist() != [2.0 * k + 1] * 3:
                    errors.append((k, out.tolist()))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append((k, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_keys) for _ in range(per_key)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert stand_in.captures == n_keys and len(store.programs) == n_keys


def test_store_credits_k1_and_k2_once_per_replay(stand_in, monkeypatch):
    """K1's and K2's wrappers count through graphs.count: launched inside a
    program (meta tensors stand for the card's, their launches for the
    kernels'), they are recorded by the capture and credited once a replay,
    K1's by window length too."""
    monkeypatch.setattr(flash, "_launch_segmented", lambda name, q, *a: (torch.empty_like(q), a[-1]))
    monkeypatch.setattr(flash, "_launch_causal", lambda name, q, k, v: torch.empty_like(q))
    monkeypatch.setattr(flash.segmented_block_attention, "launches", 0)
    monkeypatch.setattr(flash.segmented_block_attention, "launches_by_range", {})
    monkeypatch.setattr(flash.causal_flash_attention, "launches", 0)

    def build():
        x = {"q": torch.empty((256, 2, 80), device="meta"), "p": torch.empty((1, 8, 2, 128), device="meta")}
        out = torch.empty((256, 2, 80), device="meta")

        def body():
            seg, starts = torch.zeros(256, dtype=torch.int32, device="meta"), torch.zeros(2, dtype=torch.int32,
                                                                                           device="meta")
            for kv_range in (128, 256, 128):
                out.copy_(flash.segmented_block_attention(x["q"], x["q"], x["q"], seg, starts, kv_range))
            flash.causal_flash_attention(x["p"], x["p"], x["p"])

        return graphs.Program(x, out, body)

    store = program_store(stand_in)
    inputs = {"q": torch.empty((256, 2, 80), device="meta"), "p": torch.empty((1, 8, 2, 128), device="meta")}
    store.run("k", build, inputs)
    # the warm-up's own launches, then the first replay's
    assert flash.segmented_block_attention.launches == 6 and flash.causal_flash_attention.launches == 2
    assert flash.segmented_block_attention.launches_by_range == {128: 4, 256: 2}
    assert store.programs["k"].launches == {(flash.segmented_block_attention, "launches"): 3,
                                            (flash.segmented_block_attention, "launches_by_range", 128): 2,
                                            (flash.segmented_block_attention, "launches_by_range", 256): 1,
                                            (flash.causal_flash_attention, "launches"): 1}
    for replay in range(2):
        store.run("k", build, inputs)
    assert flash.segmented_block_attention.launches == 12 and flash.causal_flash_attention.launches == 4
    assert flash.segmented_block_attention.launches_by_range == {128: 8, 256: 4}


def test_counted_launch_in_a_while_body_raises(stand_in, monkeypatch):
    """The card alone knows how often a WHILE body runs: a counted kernel
    launch inside one cannot be credited, so its capture refuses it."""
    class Counted:
        launches = 0

    def build():
        x = {"a": torch.zeros(1)}
        pred = torch.ones((), dtype=torch.bool)

        def body():
            def step():
                graphs.count(Counted)
                pred.fill_(False)

            graphs.until(pred, step)

        return graphs.Program(x, x["a"], body)

    with pytest.raises(RuntimeError, match="inside a WHILE body"):
        program_store(stand_in).run("w", build, {"a": torch.zeros(1)})


def test_store_capture_failure_raises_without_eager(stand_in, monkeypatch):
    def eager(*a, **k):
        raise AssertionError("the eager program ran")

    monkeypatch.setattr(graphs, "run_program", eager)
    monkeypatch.setattr(StandInGraph, "fail", True)
    store = program_store(stand_in)
    for attempt in range(2):  # nothing is kept: the next call captures again, and fails again
        with pytest.raises(RuntimeError, match="stand-in capture failed"):
            store.run("a", _toy_program, {"a": torch.zeros(3)})
    assert stand_in.captures == 2 and not store.programs


def test_cpu_predictors_build_no_program_graph(monkeypatch):
    def no_graph(*a, **k):
        raise AssertionError("a CPU predictor built a graph")

    monkeypatch.setattr(graphs.ProgramGraphs, "run", no_graph)
    monkeypatch.setattr(graphs.CudaLoopGraph, "__init__", no_graph)
    det = DetectionPredictor(tiny=True, device="cpu")
    efficientvit.install_blob_detector(det)
    rec = RecognitionPredictor(tiny=True, device="cpu")
    assert isinstance(det.programs, graphs.EagerPrograms) and isinstance(rec.programs, graphs.EagerPrograms)
    assert isinstance(graphs.programs_for("cuda"), graphs.ProgramGraphs)
    from surya_tpu_torch.settings import settings

    page = _pages()[0]
    old = (settings.DETECTOR_ON_DEVICE_POSTPROCESS, settings.DETECTOR_DEVICE_RESIZE)
    settings.DETECTOR_ON_DEVICE_POSTPROCESS = settings.DETECTOR_DEVICE_RESIZE = True
    try:
        [found] = det([page.copy()])
    finally:
        settings.DETECTOR_ON_DEVICE_POSTPROCESS, settings.DETECTOR_DEVICE_RESIZE = old
    assert len(found.bboxes) >= 3 and det.stats_batches == 1
    [res] = rec([page], bboxes=[[[4, 4, 200, 40]]], recognition_batch_size=2)
    assert len(res.text_lines) == 1
