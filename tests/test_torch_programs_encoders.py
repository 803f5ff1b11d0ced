"""The last of the JAX package's jitted programs as common/graphs.py runs
them, on the CPU in float32 at tiny widths, through the stand-in of the CUDA
graph (test_torch_programs.StandIn: captures recorded, replays run on the
host), each held to its plain version and to the JAX package's own jitted
function on seeded numpy inputs. Values agree within 1e-4 (atol and rtol);
ids, classes, valid flags and steps run are equal.

- Layout's whole ``generate`` (the gray broadcast and normalisation of uint8
  tiles, DonutSwin and the box loop, one ``graphs.Loop``) against the JAX
  predictor's ``_generate``, gray and colour tiles, as called and cap-bound;
  the predictor's row buckets: a 3-tile and a 4-tile batch share a key, and
  the padded batch's results are the unpadded ones.
- Table rec's ``encode`` program against the JAX predictor's ``encode``.
- OCR error's ``forward`` program against the JAX predictor's ``_forward``
  at two sequence buckets, and the predictor through it.
- The meshed decode chunk's ``Loop`` on CPU meshes (2x1, 1x2, 2x2) against
  the JAX package's ``decode_chunk`` on the same mesh (its params and cache
  placed as its predictor places them) and the port's unsharded chunk: token
  ids, slot state, cache lengths and steps run equal, including a chunk
  whose slots all stop at step 0; a meshed predictor's key captured once.
- The stores: a failed capture raises without an eager run, and CPU
  predictors build no graph.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from PIL import Image, ImageDraw

import surya_tpu.layout as jax_layout_pkg
import surya_tpu.table_rec as jax_table_pkg
from surya_tpu.models import distilbert as jax_distilbert
from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import layout_model as jax_layout
from surya_tpu.models import table_rec_model as jax_trm
from surya_tpu.ocr_error import OCRErrorPredictor as JaxOCRErrorPredictor
from surya_tpu.ocr_error.tokenizer import WordPieceTokenizer as JaxWordPieceTokenizer
from surya_tpu.parallel import mesh as jax_mesh
from surya_tpu_torch.common import graphs
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models import foundation, qwen_decoder
from surya_tpu_torch.models.distilbert import DistilBertConfig
from surya_tpu_torch.ocr_error import OCRErrorPredictor
from surya_tpu_torch.ocr_error import from_jax_params as ocr_from_jax
from surya_tpu_torch.ocr_error.tokenizer import WordPieceTokenizer
from surya_tpu_torch.parallel.mesh import Sharded, make_mesh
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.table_rec import TableRecPredictor

from test_torch_graphs import K, N_SLOTS, WINDOW, StandInGraph, _cache_arrays, _fixed_tokens, _jax_cache
from test_torch_graphs import rec_models  # noqa: F401 (a fixture)
from test_torch_layout import layout_configs, perturbed
from test_torch_mesh import _line_page, _record_tokens
from test_torch_ocr_error import TEXTS, TINY, VOCAB
from test_torch_ocr_error import perturbed as ocr_perturbed
from test_torch_programs import StandIn
from test_torch_table_rec import configs as table_configs

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


def tiles(rng, n, gray: bool) -> np.ndarray:
    """n uint8 tiles of the tiny encoder's 128x128: pages of dark bands on
    a light ground, one channel when gray (the predictors' gray ship)."""
    x = rng.integers(200, 256, (n, 128, 128, 3), dtype=np.uint8)
    for i in range(n):
        for k in range(int(rng.integers(2, 5))):
            y, w = int(rng.integers(4, 110)), int(rng.integers(30, 120))
            x[i, y:y + 10, 4:4 + w] = rng.integers(0, 60, dtype=np.uint8)
    return np.ascontiguousarray(x[..., :1]) if gray else x


# -- layout's whole generate ----------------------------------------------------

def _layout_pair(cap_bound: bool):
    """The JAX layout predictor and the port's on one tiny model (cap-bound:
    no class ends a row, so every row decodes max_boxes steps)."""
    jcfg, pcfg = layout_configs("gqa", max_boxes=10)
    if cap_bound:
        jcfg = dataclasses.replace(jcfg, eos_token_id=-1, pad_token_id=-1)
        pcfg = dataclasses.replace(pcfg, eos_token_id=-1, pad_token_id=-1)
    params = perturbed(jax_layout.init_params(jcfg, jax.random.PRNGKey(7)), 8)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layout_pkg, "load_layout_model", lambda checkpoint=None, tiny=False: (
        jax.tree.map(jnp.asarray, params), jcfg))
    try:
        ref = jax_layout_pkg.LayoutPredictor()
    finally:
        mp.undo()
    return ref, LayoutPredictor(device="cpu", jax_params=params, config=pcfg)


@pytest.fixture(scope="module")
def layouts():
    return {cap_bound: _layout_pair(cap_bound) for cap_bound in (False, True)}


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("cap_bound", [False, True], ids=["as_called", "cap_bound"])
def test_layout_generate_program_matches_eager_and_jax(layouts, stand_in, gray, cap_bound):
    ref, pred = layouts[cap_bound]
    # noise over the whole uint8 range, as the JAX loop's tests feed uniform pixels
    pixels = np.random.default_rng(10 + 2 * cap_bound + gray).integers(0, 256, (3, 128, 128, 1 if gray else 3),
                                                                        dtype=np.uint8)
    expected = np.asarray(ref._generate(ref.params, jnp.asarray(pixels)))
    saved = pred.loops
    try:
        pred.loops = graphs.LoopGraphs(stand_in)
        with torch.inference_mode():
            got, ran = pred._generate(torch.from_numpy(pixels))
            again, ran_again = pred._generate(torch.from_numpy(pixels))
        pred.loops = graphs.EagerLoops()
        with torch.inference_mode():
            eager, ran_e = pred._generate(torch.from_numpy(pixels))
    finally:
        pred.loops = saved
    assert stand_in.captures == 1  # the prologue and the box loop: one graph
    for out in (got, again):
        assert torch.equal(out, eager)
    got, c = got.numpy(), pred.config
    valid = expected[..., -1] > 0.5
    assert np.array_equal(got[..., -1] > 0.5, valid) and np.array_equal(got[..., 6], expected[..., 6])
    close(got[..., :6], expected[..., :6])
    close(got[..., 7:-1], expected[..., 7:-1])
    # the JAX loop ran until every row was done: a step after the longest row's last
    stop = min(c.max_boxes, valid.sum(1).max() + 1)
    assert ran.credit() == ran_again.credit() == ran_e.credit() == stop
    assert stop == c.max_boxes if cap_bound else stop < c.max_boxes


def test_layout_row_buckets_share_a_key(layouts, stand_in, monkeypatch):
    """A batch of 3 tiles runs at the 4-row bucket (copies of its last
    tile), so a 3-tile and a 4-tile batch share one graph, gray pages a
    key of their own; the padded batch gives the unpadded batch's results."""
    _, pred = layouts[False]
    rng = np.random.default_rng(21)
    pages = [Image.fromarray(t) for t in tiles(rng, 4, False)]
    gray = [Image.new("RGB", (300, 200), "white") for _ in range(3)]
    for k, page in enumerate(gray):
        ImageDraw.Draw(page).rectangle((20, 30 + 40 * k, 250, 50 + 40 * k), fill="black")
    saved = pred.loops
    pred.loops = store = graphs.LoopGraphs(stand_in)
    try:
        three = pred([p.copy() for p in pages[:3]])
        assert pred.last_run["tiles"] == [3] and pred.last_run["rows"] == [4]
        pred([p.copy() for p in pages])
        assert pred.last_run["rows"] == [4] and stand_in.captures == 1
        pred([p.copy() for p in gray])
        assert stand_in.captures == 2 and sorted(k[2][-1] for k in store.loops) == [1, 3]
        monkeypatch.setattr(pred, "bucket_rows", lambda current, batch_size: current)
        pred.loops = graphs.EagerLoops()
        unpadded = pred([p.copy() for p in pages[:3]])
        assert pred.last_run["rows"] == [3]
    finally:
        pred.loops = saved
    assert len(three) == len(unpadded) == 3
    for a, b in zip(three, unpadded):
        assert [x.label for x in a.bboxes] == [x.label for x in b.bboxes]
        for x, y in zip(a.bboxes, b.bboxes):
            close(x.polygon, y.polygon)
            close(x.confidence, y.confidence)


# -- table rec's encode -------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    jcfg, pcfg = table_configs(max_boxes=12)
    params = perturbed(jax_trm.init_params(jcfg, jax.random.PRNGKey(31)), 32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_table_pkg, "load_table_rec_model", lambda checkpoint=None, tiny=False: (
        jax.tree.map(jnp.asarray, params), jcfg))
    try:
        ref = jax_table_pkg.TableRecPredictor()
    finally:
        mp.undo()
    return ref, TableRecPredictor(device="cpu", jax_params=params, config=pcfg)


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
def test_table_encode_program_matches_eager_and_jax(tables, stand_in, gray):
    ref, pred = tables
    pixels = tiles(np.random.default_rng(40 + gray), 3, gray)
    expected = np.asarray(ref._encode(ref.params, jnp.asarray(pixels)))
    saved = pred.programs
    try:
        pred.programs = store = graphs.ProgramGraphs(stand_in)
        with torch.inference_mode():
            got = pred._encode(torch.from_numpy(pixels)).clone()
            other = pred._encode(torch.from_numpy(pixels[::-1].copy()))
        pred.programs = graphs.EagerPrograms()
        with torch.inference_mode():
            eager = pred._encode(torch.from_numpy(pixels))
    finally:
        pred.programs = saved
    assert stand_in.captures == 1 and len(store.programs) == 1
    assert other is store.programs[next(iter(store.programs))].program.outputs["states"]  # the graph's own
    assert torch.equal(got, eager)
    close(other.numpy(), eager.flip(0).numpy())
    assert got.shape == expected.shape == (3, pred.config.encoder.tokens, pred.config.encoder.hidden_size)
    close(got.numpy(), expected)


# -- OCR error's forward ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ocr_params():
    """A JAX tiny pytree with every leaf perturbed and the head's spread widened."""
    cfg = jax_distilbert.DistilBertConfig(**TINY)
    params = ocr_perturbed(jax_distilbert.init_params(cfg, jax.random.PRNGKey(3)), 4, 0.05)
    params["pre_classifier"] = ocr_perturbed(params["pre_classifier"], 5, 0.5)
    params["classifier"] = ocr_perturbed(params["classifier"], 6, 1.0)
    ref = JaxOCRErrorPredictor(checkpoint=os.devnull, tiny=True)  # a local path: random init, no download
    ref.params = jax.tree.map(jnp.asarray, params)
    ref.processor = JaxWordPieceTokenizer(vocab=dict(VOCAB))
    return ref, params


@pytest.mark.parametrize("S", [64, 128])
def test_ocr_error_forward_program_matches_eager_and_jax(ocr_params, stand_in, S):
    ref, params = ocr_params
    model = ocr_from_jax(params, DistilBertConfig(**TINY), "cpu")
    rng = np.random.default_rng(S)
    ids = rng.integers(0, model.config.vocab_size, (4, S)).astype(np.int32)
    mask = np.ones((4, S), np.int32)
    mask[1, S // 2:] = 0
    mask[2, 5:] = 0
    expected = np.asarray(ref._forward(ref.params, jnp.asarray(ids), jnp.asarray(mask)))
    store = graphs.ProgramGraphs(stand_in)
    with torch.inference_mode():
        got = model.launch_forward(torch.from_numpy(ids), torch.from_numpy(mask), store).clone()
        again = model.launch_forward(torch.from_numpy(ids), torch.from_numpy(mask), store)
        eager = model.launch_forward(torch.from_numpy(ids), torch.from_numpy(mask), graphs.EagerPrograms())
    assert stand_in.captures == 1 and torch.equal(got, eager) and torch.equal(again, eager)
    assert np.array_equal(got.numpy().argmax(1), expected.argmax(1))
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL * np.abs(expected).max())


def test_ocr_error_predictor_through_programs(ocr_params, stand_in):
    """The predictor through a stand-in store: the JAX predictor's labels,
    a capture per (rows, sequence bucket), none for a repeated call."""
    ref, params = ocr_params
    ours = OCRErrorPredictor(None, True, device="cpu", jax_params=params)
    ours.processor = WordPieceTokenizer(vocab=dict(VOCAB))
    ours.programs = store = graphs.ProgramGraphs(stand_in)
    expected = ref(TEXTS, batch_size=4)
    assert ours(TEXTS, batch_size=4).labels == expected.labels
    assert ours.last_run["batches"] == [(4, 64), (4, 128), (4, 64)] and stand_in.captures == 2
    assert ours(TEXTS, batch_size=4).labels == expected.labels and stand_in.captures == len(store.programs) == 2


# -- the meshed decode chunk -------------------------------------------------------------

def cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, [CPU] * (n_data * n_model))


def _sharded_cache(arrays, mesh) -> dict:
    cache = {}
    for k, v in arrays.items():
        t = torch.from_numpy(v.copy())
        cache[k] = Sharded.split(t.to(torch.bfloat16) if k.endswith("scale") else t, mesh, qwen_decoder.CACHE_SPECS[k])
    return cache


def _sharded_state(mesh, *arrays) -> list:
    return [Sharded.split(torch.from_numpy(a.copy()), mesh, qwen_decoder.ROWS_SPEC).shards for a in arrays]


_jax_meshed_decode = jax.jit(jax_foundation.decode_chunk, static_argnums=(1,),
                             static_argnames=("num_steps", "use_pallas", "mesh", "repeat_window", "pin_decode"))


def _jax_on_mesh(params, jcfg, arrays, last, active, run, window, pin, shape):
    """The JAX package's decode_chunk on a mesh of its virtual CPU devices,
    its params and cache placed as its recognition predictor places them."""
    grid = jax_mesh.make_mesh(n_data=shape[0], n_model=shape[1], devices=jax.devices()[: shape[0] * shape[1]])
    sharding = jax_mesh.cache_sharding(grid)
    cache = {k: jax.device_put(v, sharding[k]) for k, v in _jax_cache(arrays).items()}
    rows = NamedSharding(grid, P(jax_mesh.DATA_AXIS))
    with grid:
        return _jax_meshed_decode(jax_mesh.shard_foundation_params(params, grid), jcfg, cache,
                                  *(jax.device_put(jnp.asarray(a), rows) for a in (last, active)), num_steps=K,
                                  use_pallas=False, mesh=grid, run=jax.device_put(jnp.asarray(run), rows),
                                  repeat_window=window, pin_decode=pin)


class ShardedCacheStandIn(StandIn):
    """A capture runs nothing on the card: what the stand-in's capture run
    commits to the (sharded) cache is put back."""

    cache = None

    def capture(self, program):
        tensors = [t for v in self.cache.values() for t in (v.shards.values() if isinstance(v, Sharded) else (v,))]
        saved = [t.clone() for t in tensors]
        super().capture(program)
        for t, s in zip(tensors, saved):
            t.copy_(s)


# name -> (pin, repeat window, int8 cache, slots that start active, prior runs, fed their fixed token)
MESH_CASES = {
    "free_early_stop": (False, WINDOW, False, [1, 1, 1, 1, 1, 1], [0, 1, 2, 3, 4, 0], [1, 1, 1, 1, 1, 0]),
    "pinned": (True, 0, False, [1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6),
    "all_stop_at_step_0": (False, 1, False, [1, 1, 0, 1, 1, 1], [0] * 6, [0] * 6),
}
MESH_RUNS = [(shape, case) for shape in ((2, 1), (1, 2), (2, 2)) for case in sorted(MESH_CASES)]
MESH_RUNS.append(((2, 2), "int8_cache"))
MESH_CASES["int8_cache"] = (False, WINDOW, True, [1, 1, 1, 1, 0, 1], [3, 0, 1, 4, 0, 2], [1, 1, 1, 1, 1, 1])


@pytest.mark.parametrize("shape,case", MESH_RUNS, ids=[f"{s[0]}x{s[1]}-{c}" for s, c in MESH_RUNS])
def test_meshed_chunk_loop_matches_jax_and_unsharded(rec_models, stand_in, monkeypatch, shape, case):
    params, jcfg, model, cfg = rec_models
    pin, window, quantize, active, run, fed = (np.asarray(x) if isinstance(x, list) else x for x in MESH_CASES[case])
    rng = np.random.default_rng(50 + sorted(MESH_CASES).index(case))
    arrays = _cache_arrays(cfg, rng, quantize)
    fixed = _fixed_tokens(params, jcfg, arrays)
    last = np.where(fed.astype(bool), fixed, rng.integers(300, 400, N_SLOTS)).astype(np.int32)
    active, run = active.astype(bool), run.astype(np.int32)
    jcache, jt, js, jb, jl, ja, jr = _jax_on_mesh(params, jcfg, arrays, last, active, run, window, pin, shape)
    steps = int((np.asarray(jcache["len"]) - arrays["len"]).max())  # the JAX loop's: the longest advance

    mesh = cpu_mesh(*shape)
    meshed = foundation.MeshedFoundation(model, mesh)
    store = graphs.LoopGraphs(ShardedCacheStandIn)
    results = []
    for loops in (store, graphs.EagerLoops()):
        cache = _sharded_cache(arrays, mesh)
        monkeypatch.setattr(ShardedCacheStandIn, "cache", cache)
        with torch.inference_mode():
            outs, ran = meshed.launch_chunk(cache, *_sharded_state(mesh, last, active), K,
                                            _sharded_state(mesh, run)[0], window, pin, loops)
        # each output and the cache, gathered as the predictor gathers them: data shard d's first model shard
        gathered = [torch.cat([o[d, 0] for d in range(shape[0])]) for o in outs]
        for m in range(shape[1]):  # every model shard keeps the same slot state
            for o, g in zip(outs[3:], gathered[3:]):
                assert torch.equal(torch.cat([o[d, m] for d in range(shape[0])]), g)
        results.append((gathered, {k: v.gather() for k, v in cache.items()}, ran.credit()))
    assert stand_in.captures == 1
    (g_out, g_cache, g_steps), (e_out, e_cache, e_steps) = results
    for a, b in zip(g_out, e_out):
        assert torch.equal(a, b)
    for key in g_cache:
        assert torch.equal(g_cache[key], e_cache[key]), key
    assert g_steps == e_steps == steps

    tt, ts, tb, tl, ta, tr = (x.numpy() for x in g_out)
    assert np.array_equal(tt, np.asarray(jt)) and np.array_equal(tb, np.asarray(jb))
    close(ts, np.asarray(js))
    for ours, ref in zip((tl, ta, tr, g_cache["len"].numpy()), (jl, ja, jr, jcache["len"])):
        assert np.array_equal(ours, np.asarray(ref))
    for key in g_cache:
        if key != "len":
            close(g_cache[key].float().numpy(), np.asarray(jcache[key], np.float32))
    if case == "all_stop_at_step_0":
        assert steps == 1
    elif case == "pinned":
        assert steps == K
    else:
        assert 0 < steps < K

    # the unsharded chunk on the same inputs
    ucache = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) if k.endswith("scale") else torch.from_numpy(v.copy())
              for k, v in arrays.items()}
    with torch.inference_mode():
        u_out, u_ran = model.launch_chunk(ucache, torch.from_numpy(last), torch.from_numpy(active), K,
                                          torch.from_numpy(run), window, pin, graphs.EagerLoops())
    assert u_ran.credit() == steps and torch.equal(u_out[0], g_out[0]) and torch.equal(ucache["len"], g_cache["len"])
    for a, b in zip(u_out[3:], g_out[3:]):
        assert torch.equal(a, b)


def test_meshed_predictor_captures_its_chunk_once(rec_models, stand_in, monkeypatch):
    """RecognitionPredictor on a 2x2 mesh of one device, its decode chunks
    through a stand-in store: the kept sharded slot-cache store gives a
    second call the first call's key (one capture), and both calls give the
    eager meshed predictor's and the unsharded predictor's token ids."""
    params, _, _, _ = rec_models
    np_params = jax.tree.map(np.asarray, params)
    ours = RecognitionPredictor(tiny=True, jax_params=np_params, mesh=cpu_mesh(2, 2))
    single = RecognitionPredictor(tiny=True, device="cpu", jax_params=np_params)
    assert isinstance(ours.loops, graphs.EagerLoops)  # the CPU: no graph unless given a store
    taken = []
    take = ours._take_cache
    monkeypatch.setattr(ours, "_take_cache", lambda *a: taken.append(take(*a)) or taken[-1])

    class StandInOnTaken(ShardedCacheStandIn):
        def capture(self, program):
            self.cache = taken[-1][0]
            super().capture(program)

    ours.loops = store = graphs.LoopGraphs(StandInOnTaken)
    for p in (ours, single):
        _record_tokens(p)
    page, bboxes = _line_page(), [[[5, 5, 200, 40], [5, 60, 300, 100], [5, 120, 400, 160]]]
    tokens = []
    for call in range(2):
        ours([page], bboxes=bboxes)
        tokens.append(ours.tokens)
    assert stand_in.captures == len(store.loops) == 1 and taken[0][1] is taken[1][1]
    assert all(k[0] == "meshed_decode_chunk" for k in store.loops)
    ours.loops = graphs.EagerLoops()
    ours([page], bboxes=bboxes)
    single([page], bboxes=bboxes)
    assert tokens[0] == tokens[1] == ours.tokens == single.tokens and len(single.tokens) == 3


# -- the stores ------------------------------------------------------------------------------

def test_failed_captures_raise_without_eager(layouts, tables, stand_in, monkeypatch):
    """Layout's generate graph and table rec's encode program: a failed
    capture raises, and neither the eager loop nor the eager program runs."""
    def eager(*a, **k):
        raise AssertionError("the eager version ran")

    monkeypatch.setattr(graphs, "run_eager", eager)
    monkeypatch.setattr(graphs, "run_program", eager)
    monkeypatch.setattr(StandInGraph, "fail", True)
    _, lay = layouts[False]
    _, tab = tables
    pixels = torch.from_numpy(tiles(np.random.default_rng(60), 2, True))
    saved = lay.loops, tab.programs
    try:
        lay.loops, tab.programs = graphs.LoopGraphs(stand_in), graphs.ProgramGraphs(stand_in)
        with torch.inference_mode():
            for call in (lambda: lay._generate(pixels), lambda: tab._encode(pixels)):
                with pytest.raises(RuntimeError, match="stand-in capture failed"):
                    call()
        assert stand_in.captures == 2 and not lay.loops.loops and not tab.programs.programs
    finally:
        lay.loops, tab.programs = saved


def test_cpu_predictors_build_no_encoder_graph(monkeypatch):
    def no_graph(*a, **k):
        raise AssertionError("a CPU predictor built a graph")

    monkeypatch.setattr(graphs.LoopGraphs, "run", no_graph)
    monkeypatch.setattr(graphs.ProgramGraphs, "run", no_graph)
    monkeypatch.setattr(graphs.CudaLoopGraph, "__init__", no_graph)
    lay = LayoutPredictor(tiny=True, device="cpu")
    tab = TableRecPredictor(tiny=True, device="cpu")
    err = OCRErrorPredictor(None, True, device="cpu")
    meshed = RecognitionPredictor(tiny=True, mesh=cpu_mesh(2, 1))
    assert isinstance(lay.loops, graphs.EagerLoops) and isinstance(meshed.loops, graphs.EagerLoops)
    assert isinstance(tab.programs, graphs.EagerPrograms) and isinstance(err.programs, graphs.EagerPrograms)
    page = Image.new("RGB", (240, 80), "white")
    ImageDraw.Draw(page).rectangle((10, 20, 200, 40), fill="black")
    assert len(lay([page])) == 1 and lay.last_run["rows"] == [1]
    assert len(tab([page])) == 1
    assert len(err(["a b c", "hello world"]).labels) == 2
    [res] = meshed([page], bboxes=[[[4, 4, 200, 40]]])
    assert len(res.text_lines) == 1 and meshed.last_decoded_tokens > 0


def test_one_card_mesh_takes_graphs_distinct_cards_eager():
    """The chunk and program stores of a predictor on a card: graphs where
    every shard of its mesh lies on that card, the eager loop and program
    over distinct cards (no graph spans several) and on the CPU. Building a
    store touches no card."""
    card, other = torch.device("cuda", 0), torch.device("cuda", 1)
    for stores, graphed, eager in ((graphs.loops_for, graphs.LoopGraphs, graphs.EagerLoops),
                                   (graphs.programs_for, graphs.ProgramGraphs, graphs.EagerPrograms)):
        assert isinstance(stores(card), graphed)
        assert isinstance(stores(card, make_mesh(2, 2, [card] * 4).distinct()), graphed)
        assert isinstance(stores(card, make_mesh(2, 1, [card, other]).distinct()), eager)
        assert isinstance(stores(CPU, cpu_mesh(2, 2).distinct()), eager)
