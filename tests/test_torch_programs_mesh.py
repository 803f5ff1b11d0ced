"""Table recognition's whole ``generate``, the meshed prefill wave and
meshed detection as common/graphs.py runs them, on the CPU in float32 at
tiny widths, through the stand-in of the CUDA graph
(test_torch_programs.StandIn: captures recorded, replays run on the host),
each held to its plain version and to the JAX package's own jitted function
on seeded numpy inputs. Values agree within 1e-4 (atol and rtol); ids,
categories, valid flags, slot state and steps run are equal.

- Table rec's ``generate`` as one ``graphs.Loop`` (the gather of each row's
  encoder states, the cross K/V, the prompt's prefill and the box loop)
  against the eager loop and the JAX predictor's jitted ``_generate``:
  scripted and unscripted, states of gray and colour crops, a rowcol pass
  and a cell pass whose ``enc_idx`` repeats tables; and the predictor's
  passes through it.
- The meshed prefill wave as one ``graphs.Program`` over every shard on 2x2,
  2x1 and 1x2 CPU meshes, with the data-sharded and the replicated encoder,
  against the eager program and the JAX predictor's ``prefill_fn`` on the
  same mesh: packed outputs, every shard's slot state and the cache's bytes
  and lengths (the trash slot, which nothing reads, aside for JAX); two
  waves of one shape with different slots share one key. A meshed
  predictor through it and the graphed chunk gives the unsharded tokens.
- Meshed detection's stats and maps programs on a 2x1 CPU mesh against the
  eager ones and the JAX predictor's jitted functions on pixels sharded as
  its predictor shards them.
- K1-mesh's and K2-mesh's launches credited once a replay; meshed CPU
  predictors keep eager programs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from PIL import Image, ImageDraw

from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.parallel import mesh as jax_mesh
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch.common import graphs
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.models import efficientvit, qwen_decoder
from surya_tpu_torch.ops import connected_components as cc
from surya_tpu_torch.ops import flash
from surya_tpu_torch.parallel.mesh import Sharded, make_mesh
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.table_rec import install_synthetic_tables

from test_torch_graphs import StandInGraph
from test_torch_graphs import rec_models  # noqa: F401 (a fixture)
from test_torch_mesh import _line_page, _record_tokens
from test_torch_programs import DET_ATOL, MAX_COMPS, MOMENT_RTOL, StandIn, _batch, _pages
from test_torch_programs_encoders import ShardedCacheStandIn, cpu_mesh, tiles
from test_torch_programs_encoders import tables  # noqa: F401 (a fixture)

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(StandInGraph, "captures", 0)
    monkeypatch.setattr(StandInGraph, "fail", False)
    return StandIn


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def jax_grid(n_data, n_model):
    return jax_mesh.make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])


# -- table rec's whole generate --------------------------------------------------

def prompts(rng, n: int, L: int):
    """n right-padded prompts like the predictor's (bos row, a query label,
    the query-end row, then column labels), of lengths min(5, L - 1) to L."""
    vec = np.zeros((n, L, 10), np.int32)
    seq_lens = rng.integers(min(5, L - 1), L + 1, n).astype(np.int32)
    for b in range(n):
        vec[b, 0] = 1
        vec[b, 1, :6] = rng.integers(0, 1025, 6)
        vec[b, 1, 6:] = [4 + 5, 5, 1, 5]
        vec[b, 2] = 4
        for t in range(3, seq_lens[b]):
            vec[b, t, :6] = rng.integers(0, 1025, 6)
            vec[b, t, 6:] = [2 + 5, 5, int(rng.integers(0, 3)), 5]
    return vec, seq_lens


# name -> (gray crops, the cell pass: rows over repeated tables, a category script)
TABLE_CASES = {
    "rowcol-colour-argmax": (False, False, False),
    "rowcol-gray-scripted": (True, False, True),
    "cell-colour-scripted": (False, True, True),
    "cell-gray-argmax": (True, True, False),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_rec_generate_program_matches_eager_and_jax(tables, stand_in, case):
    ref, pred = tables
    gray, cell, scripted = TABLE_CASES[case]
    rng = np.random.default_rng(70 + sorted(TABLE_CASES).index(case))
    M = pred.config.max_boxes
    with torch.inference_mode():
        states = pred.model.launch_encode(torch.from_numpy(tiles(rng, 3, gray)), graphs.EagerPrograms()).clone()
    enc_idx = np.array([2, 0, 2, 1, 0, 2], np.int64) if cell else np.arange(3)
    vec, seq_lens = prompts(rng, len(enc_idx), 16 if cell else 4)
    script = np.full((M,), -1, np.int64)
    if scripted:
        script[:6] = [6, 7, 6, 8, 6, 7]
        script[7] = 1  # EOS: every row stops there
    args = (states, torch.from_numpy(enc_idx), torch.from_numpy(vec), torch.from_numpy(seq_lens), M)
    store = graphs.LoopGraphs(stand_in)
    with torch.inference_mode():
        got, ran = pred.model.launch_generate(*args, script if scripted else None, store)
        got = {k: v.clone() for k, v in got.items()}
        other, ran_other = pred.model.launch_generate(*args[:2], torch.from_numpy(vec[::-1].copy()),
                                                      torch.from_numpy(seq_lens[::-1].copy()), M,
                                                      script if scripted else None, store)
        eager, ran_e = pred.model.launch_generate(*args, script if scripted else None, graphs.EagerLoops())
    assert stand_in.captures == len(store.loops) == 1  # the gather, the prologue and the box loop: one graph
    assert other["valid"] is store.loops[next(iter(store.loops))].loop.outputs["valid"]  # the graph's own
    for k in got:
        assert torch.equal(got[k], eager[k]), k
    steps = ran.credit()
    assert steps == ran_e.credit() and ran_other.credit() <= M - 1

    packed = np.asarray(ref._generate(ref.params, jnp.asarray(states.numpy()), jnp.asarray(enc_idx.astype(np.int32)),
                                      jnp.asarray(vec), jnp.asarray(seq_lens), jnp.asarray(script.astype(np.int32)),
                                      max_steps=M))
    valid = packed[..., 10] > 0.5
    assert np.array_equal(got["valid"].numpy(), valid)
    for j, k in enumerate(("category", "merges", "colspan", "is_header")):
        assert np.array_equal(got[k].numpy(), packed[..., 6 + j]), k
    close(got["bbox"].numpy(), packed[..., :6])
    # the JAX loop's steps after the prefill's: until a step leaves every row done
    assert steps == min(int(valid.sum(1).max()), M - 1)
    if scripted:
        assert steps == 7 and valid[:, :7].all()


def test_table_rec_predictor_passes_through_one_program(tables, stand_in):
    """The predictor's rowcol and cell passes through a stand-in store: one
    key a pass shape, none captured again by a second call, and the eager
    passes' tables and steps."""
    ref, pred = tables
    crop = Image.new("RGB", (300, 200), "white")
    ImageDraw.Draw(crop).rectangle((20, 20, 280, 180), outline="black", width=2)
    crops = [crop, crop.transpose(Image.Transpose.FLIP_LEFT_RIGHT)]
    install_synthetic_tables(pred, n_rows=3, n_cols=2, n_cells=2)
    saved = pred.loops
    try:
        pred.loops = store = graphs.LoopGraphs(stand_in)
        graphed = [pred([c.copy() for c in crops]) for _ in range(2)]
        graphed_passes = pred.last_run["passes"]
        pred.loops = graphs.EagerLoops()
        eager = pred([c.copy() for c in crops])
        eager_passes = pred.last_run["passes"]
    finally:
        pred.loops = saved
        pred._script_rowcol = pred._script_cells = None
    assert stand_in.captures == len(store.loops) == 2 and {k[0] for k in store.loops} == {"table_rec"}
    assert [(p["rows"], p["steps"], p["recorded"]) for p in graphed_passes] == \
        [(p["rows"], p["steps"], p["recorded"]) for p in eager_passes]
    for results in graphed:
        for a, b in zip(results, eager):
            assert (len(a.rows), len(a.cols), len(a.cells)) == (len(b.rows), len(b.cols), len(b.cells))
            assert (len(a.rows), len(a.cols)) == (3, 2)
            for x, y in zip(a.rows + a.cols + a.cells, b.rows + b.cols + b.cells):
                assert x.polygon == y.polygon


# -- the meshed prefill ----------------------------------------------------------

CACHE_LEN = 256


def _crops_wave(pred, rng, n_shards: int):
    """A prefill wave of 3 line crops at the 4-row bucket, built as the
    predictor builds it (data-sharded for n_shards > 1)."""
    crops = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in ((28, 112), (56, 84), (28, 56))]
    imgs = [pred._prepare_image(c, "ocr_with_boxes") for c in crops]
    return pred.processor.build_prefill_batch(
        imgs, ["ocr_with_boxes"] * 3, [None] * 3, [True] * 3, pred.config.encoder, batch_rows=4,
        seq_buckets=pred.seq_buckets, patch_caps=pred.patch_caps, n_shards=n_shards)


def _slots(batch, n_slots: int, targets):
    """(slot_idx, row_valid): the valid rows into `targets`, the padding rows into the trash slot."""
    slot_idx = np.full(batch.input_ids.shape[0], n_slots - 1, np.int32)
    slot_idx[batch.valid_rows] = targets
    row_valid = np.zeros(batch.input_ids.shape[0], bool)
    row_valid[batch.valid_rows] = True
    return slot_idx, row_valid


def _start(cfg, rng, n_slots: int):
    """A cache with random rows in some slots, the slot state and a kill mask, as numpy arrays."""
    d = cfg.decoder
    shape = (d.num_hidden_layers, n_slots, d.num_key_value_heads, CACHE_LEN, d.head_dim)
    lens = np.where(np.arange(n_slots) % 3 == 0, rng.integers(4, 30, n_slots), 0).astype(np.int32)
    filled = (lens > 0)[None, :, None, None, None]
    cache = {"k": (rng.standard_normal(shape) * filled).astype(np.float32),
             "v": (rng.standard_normal(shape) * filled).astype(np.float32), "len": lens}
    state = (np.where(lens > 0, 300 + np.arange(n_slots), 2).astype(np.int32), lens > 0,
             (lens > 0).astype(np.int32))
    kill = np.zeros(n_slots, bool)
    kill[3] = True  # a slot the host stopped
    return cache, state, kill


def _sharded(arrays, mesh):
    return {k: Sharded.split(torch.from_numpy(v.copy()), mesh, qwen_decoder.CACHE_SPECS[k]) for k, v in arrays.items()}


def _gathered_state(state, mesh):
    """Each state tensor joined over the data axis, every model shard holding the same."""
    out = []
    for x in state:
        joined = torch.cat([x[d, 0] for d in range(mesh.n_data)])
        for m in range(mesh.n_model):
            assert torch.equal(torch.cat([x[d, m] for d in range(mesh.n_data)]), joined)
        out.append(joined.clone().numpy())
    return out


# (data, model), data-sharded encoder, pinned decode
PREFILL_CASES = [((2, 2), True, False), ((2, 2), False, True), ((2, 1), True, True), ((2, 1), False, False),
                 ((1, 2), False, False)]


@pytest.mark.parametrize("shape,sharded,pin", PREFILL_CASES,
                         ids=[f"{s[0]}x{s[1]}-{'sharded' if h else 'replicated'}-{'pinned' if p else 'free'}"
                              for s, h, p in PREFILL_CASES])
def test_meshed_prefill_program_matches_eager_and_jax(rec_models, stand_in, monkeypatch, shape, sharded, pin):
    params, jcfg, _, cfg = rec_models
    np_params = jax.tree.map(np.asarray, params)
    mesh = cpu_mesh(*shape)
    ours = RecognitionPredictor(tiny=True, jax_params=np_params, mesh=mesh)
    n_slots = ours.n_slots + 1
    rng = np.random.default_rng(80 + PREFILL_CASES.index((shape, sharded, pin)))
    batch = _crops_wave(ours, rng, shape[0] if sharded else 1)
    assert (batch.patches.ndim == 3) == sharded
    # wave 1 fills slots of every data shard, wave 2 (the same shape) others
    waves = [_slots(batch, n_slots, [n_slots - 2, 1, n_slots // 2]), _slots(batch, n_slots, [2, n_slots - 3, 0])]
    cache0, state0, kill0 = _start(cfg, rng, n_slots)

    def run(programs):
        ours.programs = programs
        cache = _sharded(cache0, mesh)
        state = [Sharded.split(torch.from_numpy(s.copy()), mesh, qwen_decoder.ROWS_SPEC).shards for s in state0]
        outs = []
        with torch.inference_mode():
            for w, (slot_idx, row_valid) in enumerate(waves):
                kill = kill0 if w == 0 else np.zeros_like(kill0)
                handle, state, _ = ours._dispatch_prefill(cache, batch, slot_idx, row_valid, state, kill, pin, False)
                outs.append((ours._wait(handle)[0].copy(), _gathered_state(state, mesh),
                             {k: v.gather().clone() for k, v in cache.items()}))
        return outs

    store = graphs.ProgramGraphs(stand_in)
    graphed, eager = run(store), run(graphs.EagerPrograms())
    assert stand_in.captures == len(store.programs) == 1  # two waves of one shape, other slots: one key
    assert next(iter(store.programs))[0] == "meshed_prefill"
    for (g_packed, g_state, g_cache), (e_packed, e_state, e_cache) in zip(graphed, eager):
        assert np.array_equal(g_packed, e_packed)
        for a, b in zip(g_state, e_state):
            assert np.array_equal(a, b)
        for key in g_cache:
            assert torch.equal(g_cache[key], e_cache[key]), key

    monkeypatch.setattr(jax_settings, "USE_MESH", True)
    monkeypatch.setattr(jax_settings, "MESH_NUM_MODEL_SHARDS", shape[1])
    grid = jax_grid(*shape)
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda *a, **k: grid)
    ref = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
    assert ref.n_slots + 1 == n_slots
    placement = jax_mesh.cache_sharding(grid)
    jcache = {k: jax.device_put(jnp.asarray(v), placement[k]) for k, v in cache0.items()}
    jstate = [jnp.asarray(s) for s in state0]
    layout = batch.layout
    live = np.arange(n_slots) != n_slots - 1  # the trash slot: JAX writes the padding rows there
    with grid:
        for w, (slot_idx, row_valid) in enumerate(waves):
            kill = kill0 if w == 0 else np.zeros_like(kill0)
            jcache, jpacked, *jstate = ref._prefill_fn(
                ref.params, jcache, jnp.asarray(batch.patches), tuple(jnp.asarray(a) for a in layout.device_args),
                jnp.asarray(layout.llm_h_idx), jnp.asarray(layout.llm_w_idx), jnp.asarray(batch.input_ids),
                jnp.asarray(batch.img_gather), jnp.asarray(batch.seq_lens), jnp.asarray(slot_idx),
                jnp.asarray(row_valid), *jstate, jnp.asarray(kill), kv_range=layout.kv_range,
                win_range=layout.win_range, pin=pin)
            packed, state, cache = graphed[w]
            jpacked = np.asarray(jpacked)
            assert np.array_equal(packed[:, 0], jpacked[:, 0])  # token ids
            close(packed[:, 1:], jpacked[:, 1:])
            for a, b in zip(state, jstate):
                assert np.array_equal(a, np.asarray(b))
            assert np.array_equal(cache["len"].numpy()[live], np.asarray(jcache["len"])[live])
            for key in ("k", "v"):
                close(cache[key].numpy()[:, live], np.asarray(jcache[key])[:, live])


def test_meshed_predictor_replays_its_prefill(rec_models, stand_in, monkeypatch):
    """RecognitionPredictor on a 2x2 mesh of one device, its prefill waves
    and decode chunks (fused after the last wave) through stand-in stores:
    a second call captures nothing, and both give the eager meshed
    predictor's and the unsharded predictor's token ids."""
    params, _, _, _ = rec_models
    np_params = jax.tree.map(np.asarray, params)
    ours = RecognitionPredictor(tiny=True, jax_params=np_params, mesh=cpu_mesh(2, 2))
    single = RecognitionPredictor(tiny=True, device="cpu", jax_params=np_params)
    taken = []
    take = ours._take_cache
    monkeypatch.setattr(ours, "_take_cache", lambda *a: taken.append(take(*a)) or taken[-1])

    class StandInOnTaken(ShardedCacheStandIn):
        def capture(self, program):
            self.cache = taken[-1][0]
            super().capture(program)

    ours.programs, ours.loops = graphs.ProgramGraphs(stand_in), graphs.LoopGraphs(StandInOnTaken)
    for p in (ours, single):
        _record_tokens(p)
    page, bboxes = _line_page(), [[[5, 5, 200, 40], [5, 60, 300, 100], [5, 120, 400, 160]]]
    tokens = []
    for call in range(2):
        ours([page], bboxes=bboxes)
        tokens.append(ours.tokens)
        if call == 0:
            captured = stand_in.captures
    assert stand_in.captures == captured == len(ours.programs.programs) + len(ours.loops.loops)
    assert {k[0] for k in ours.programs.programs} == {"meshed_prefill"}
    ours.programs, ours.loops = graphs.EagerPrograms(), graphs.EagerLoops()
    ours([page], bboxes=bboxes)
    single([page], bboxes=bboxes)
    assert tokens[0] == tokens[1] == ours.tokens == single.tokens and len(single.tokens) == 3


# -- meshed detection --------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_detectors():
    ref = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(ref)
    ours = DetectionPredictor(tiny=True, jax_params=jax.tree.map(np.asarray, ref.params), mesh=cpu_mesh(2, 1))
    efficientvit.install_blob_detector(ours)
    return ref, ours


@pytest.mark.parametrize("resize", [False, True], ids=["host_resize", "device_resize"])
def test_meshed_detection_programs_match_eager_and_jax(mesh_detectors, stand_in, resize):
    """The stats program (and, with the device resize, the maps program) of
    a 2x1 meshed predictor: the eager program's outputs, and the JAX
    predictor's on the pixels sharded over the data axis of its 2x1 mesh."""
    ref, det = mesh_detectors
    pixels, mats, page_gather, valid_rows, n_real = _batch(det, _pages(), resize)
    assert pixels.shape[0] % 2 == 0
    saved = det.programs
    try:
        with torch.inference_mode():
            det.programs = store = graphs.ProgramGraphs(stand_in)
            graphed = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS).clone()
            maps = det._maps_program(pixels, mats, n_real, 2).clone() if resize else None
            det.programs = graphs.EagerPrograms()
            eager = det._stats_program(pixels, mats, page_gather, valid_rows, MAX_COMPS)
            eager_maps = det._maps_program(pixels, mats, n_real, 2) if resize else None
    finally:
        det.programs = saved
    assert stand_in.captures == len(store.programs) == 1 + resize
    assert torch.equal(graphed, eager) and (maps is None or torch.equal(maps, eager_maps))

    grid = jax_grid(2, 1)
    px = jax.device_put(jnp.asarray(pixels.numpy()), NamedSharding(grid, P(jax_mesh.DATA_AXIS)))
    extra = tuple(jnp.asarray(t.numpy()) for t in mats) if resize else ()
    fwd = ref._forward_resize_stats if resize else ref._forward_stats
    jstats, jn, jraw, jthr = (np.asarray(a) for a in fwd(
        ref.params, px, *extra, jnp.asarray(page_gather.numpy()), jnp.asarray(valid_rows.numpy()),
        max_comps=MAX_COMPS))
    out = graphed.numpy()
    P_ = page_gather.shape[0]
    assert np.array_equal(out[:, -3], jn) and np.array_equal(out[:, -2], jraw) and jn[:2].min() >= 3
    stats = out[:, :MAX_COMPS * cc.STATS_DIM].reshape(P_, MAX_COMPS, cc.STATS_DIM)
    np.testing.assert_allclose(stats[..., :cc.SUM_X], jstats[..., :cc.SUM_X], rtol=0, atol=DET_ATOL)
    np.testing.assert_allclose(stats[..., cc.SUM_X:], jstats[..., cc.SUM_X:], rtol=MOMENT_RTOL, atol=0)
    np.testing.assert_allclose(out[:, -1], jthr, rtol=0, atol=DET_ATOL)
    if resize:
        jmaps = np.asarray(ref._forward_resize(ref.params, px, *extra))
        expected = jmaps[:n_real].transpose(0, 3, 1, 2).astype(np.int16)
        assert np.abs(maps.numpy().astype(np.int16) - expected).max() <= 1


# -- the stores ------------------------------------------------------------------------

def test_mesh_wrappers_credited_once_per_replay(stand_in, monkeypatch):
    """K1-mesh's and K2-mesh's wrappers count through graphs.count: launched
    inside a program over a 1x2 mesh (meta tensors stand for the card's,
    their launches for the kernels'), they are recorded by the capture and
    credited once a replay, by shard too."""
    monkeypatch.setattr(flash, "_launch_segmented", lambda name, q, *a: (torch.empty_like(q), a[-1]))
    monkeypatch.setattr(flash, "_launch_causal", lambda name, q, k, v: torch.empty_like(q))
    k1, k2 = flash.segmented_block_attention_shard_map, flash.causal_flash_attention_shard_map
    for wrapper in (k1, k2):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_by_shard", {})
    mesh = make_mesh(1, 2, ["meta", "meta"])

    def sharded(*shape, dtype=torch.bfloat16):
        return Sharded(mesh, (None,) * len(shape), {dm: torch.empty(shape, dtype=dtype, device="meta")
                                                    for dm in mesh.coords()})

    def build():
        x = {"q": torch.empty((256, 2, 80), device="meta")}
        out = torch.empty((), device="meta")

        def body():
            q = sharded(256, 2, 80)
            flash.segmented_block_attention_shard_map(q, q, q, sharded(256, dtype=torch.int32),
                                                      sharded(2, dtype=torch.int32), 128, mesh)
            p = sharded(2, 8, 2, 128)
            flash.causal_flash_attention(p, p, p, mesh=mesh)

        return graphs.Program(x, out, body)

    store = graphs.ProgramGraphs(stand_in)
    inputs = {"q": torch.empty((256, 2, 80), device="meta")}
    for replay in range(3):
        store.run("k", build, inputs)
    # the warm-up's own launches, then three replays'
    for wrapper in (k1, k2):
        assert wrapper.launches == 8 and wrapper.launches_by_shard == {(0, 0): 4, (0, 1): 4}


def test_cpu_meshed_predictors_keep_eager_programs():
    """A meshed predictor on the CPU runs its programs eagerly (programs_for:
    no graph off the card)."""
    rec = RecognitionPredictor(tiny=True, mesh=cpu_mesh(2, 1))
    det = DetectionPredictor(tiny=True, mesh=cpu_mesh(2, 1))
    assert isinstance(rec.programs, graphs.EagerPrograms) and isinstance(det.programs, graphs.EagerPrograms)
