"""The port's AR loops as common/graphs.py runs them, on the CPU.

- The plain loops (``graphs.EagerLoops``: the step function, the JAX cond
  read on the host after each step) against the JAX package's
  ``while_loop``s on shared weights and numpy inputs, in float32:
  ``FoundationModel.decode_chunk`` free-running (slots stopping at different
  steps, a chunk where all stop before K, one that runs to K), pinned (and
  with no slot active), with a repeat window and with the int8 cache;
  ``LayoutModel.generate`` as called and cap-bound; ``TableRecModel
  .generate`` with a device ``category_script``. Token ids, classes and
  ``valid`` are equal, scores and boxes within 1e-4, the cache's bytes and
  lengths the same, and the steps run equal to the JAX loop's.
- The store of captured loops (``graphs.LoopGraphs``) through a CPU stand-in
  of the CUDA graph, which records its captures and replays the captured
  program on the host: one capture per key, inputs copied into the static
  buffers, a replay's outputs equal to the eager loop's, packed outputs that
  the next replay leaves alone, launch counts scaled by the steps that ran,
  and a failed capture that raises without running the eager loop.
- Predictors on the CPU take the eager loop and build no graph.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import layout_model as jax_layout
from surya_tpu.models import table_rec_model as jax_trm
from surya_tpu.recognition.loader import load_recognition_model as jax_load
from surya_tpu_torch.common import graphs
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.layout.loader import from_jax_params as layout_from_jax
from surya_tpu_torch.models import qwen_decoder
from surya_tpu_torch.recognition import RecognitionPredictor, _pack
from surya_tpu_torch.recognition.loader import load_recognition_model
from surya_tpu_torch.table_rec import TableRecPredictor
from surya_tpu_torch.table_rec.loader import from_jax_params as table_from_jax

from test_torch_layout import layout_configs, perturbed
from test_torch_table_rec import configs as table_configs
from test_torch_table_rec import prompt_vectors

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
N_SLOTS, CACHE_LEN, K, WINDOW = 6, 64, 10, 6


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


class StandInGraph:
    """A CUDA graph's stand-in on the CPU: capture runs the program once with
    every step's body (the launches it records are what a capture records),
    replay runs it again with each IF node decided on the host."""

    captures = 0
    fail = False

    def __init__(self, device):
        self.device = device
        self.capturing = False

    def warm_up(self, loop):
        loop.begin()
        if loop.max_steps:
            loop.step(0)

    def capture(self, program):
        StandInGraph.captures += 1
        if self.fail:
            raise RuntimeError("stand-in capture failed")
        self.program, self.capturing = program, True
        try:
            program(self)
        finally:
            self.capturing = False

    def when(self, pred, body):
        if self.capturing or bool(pred):
            body()

    def replay(self):
        self.program(self)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(StandInGraph, "captures", 0)
    return StandInGraph


# -- recognition's decode chunk --------------------------------------------------

@pytest.fixture(scope="module")
def rec_models():
    params, jcfg, _ = jax_load(checkpoint=os.devnull, tiny=True)
    model, cfg, _ = load_recognition_model(tiny=True, device="cpu", jax_params=jax.tree.map(np.asarray, params))
    return params, jcfg, model, cfg


def _cache_arrays(cfg, rng, quantize: bool) -> dict:
    """A slot cache of random rows as numpy arrays, in both packages' layout."""
    d = cfg.decoder
    shape = (d.num_hidden_layers, N_SLOTS, d.num_key_value_heads, CACHE_LEN, d.head_dim)
    lens = rng.integers(4, 24, N_SLOTS).astype(np.int32)
    if not quantize:
        return {"k": rng.standard_normal(shape).astype(np.float32), "v": rng.standard_normal(shape).astype(np.float32),
                "len": lens}
    return {"k": rng.integers(-127, 128, shape).astype(np.int8), "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
            "v_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32), "len": lens}


def _jax_cache(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16) if k.endswith("scale") else jnp.asarray(v) for k, v in arrays.items()}


def _torch_cache(arrays):
    return {k: torch.from_numpy(v.copy()).to(torch.bfloat16) if k.endswith("scale") else torch.from_numpy(v.copy())
            for k, v in arrays.items()}


_jax_decode = jax.jit(jax_foundation.decode_chunk, static_argnums=(1,),
                      static_argnames=("num_steps", "use_pallas", "repeat_window", "pin_decode"))


def _fixed_tokens(params, jcfg, arrays):
    """Each slot's token that the decoder emits again when it is fed back
    (random tiny weights settle at once): two free steps from arbitrary
    inputs, the second step's token."""
    start = jnp.arange(N_SLOTS, dtype=jnp.int32) * 7 + 300
    out = _jax_decode(params, jcfg, _jax_cache(arrays), start, jnp.ones(N_SLOTS, bool), num_steps=3,
                      use_pallas=False)
    toks = np.asarray(out[1])
    assert (toks[:, 1] == toks[:, 2]).all(), toks  # fed back, each emits itself
    return toks[:, 1].astype(np.int32)


# name -> (pin, repeat window, int8 cache, slots that start active, prior runs, fed their fixed token)
DECODE_CASES = {
    # the fixed token fed back with prior runs 0..4: slot s stops after
    # WINDOW - run steps; slot 5 starts from another token (WINDOW steps)
    "free_early_stop": (False, WINDOW, False, [1, 1, 1, 1, 1, 1], [0, 1, 2, 3, 4, 0], [1, 1, 1, 1, 1, 0]),
    "free_to_K": (False, 0, False, [1, 1, 0, 1, 1, 1], [0] * 6, [0] * 6),
    "pinned": (True, 0, False, [1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6),
    "pinned_none_active": (True, 0, False, [0] * 6, [0] * 6, [0] * 6),
    "repeat_window_3": (False, 3, False, [1, 1, 1, 0, 1, 1], [2, 1, 0, 0, 0, 2], [1, 1, 1, 1, 0, 0]),
    "int8_cache": (False, WINDOW, True, [1, 1, 1, 1, 0, 1], [3, 0, 1, 4, 0, 2], [1, 1, 1, 1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_chunk_plain_loop_matches_jax(rec_models, case):
    params, jcfg, model, cfg = rec_models
    pin, window, quantize, active, run, fed = (np.asarray(x) if isinstance(x, list) else x for x in DECODE_CASES[case])
    rng = np.random.default_rng(sorted(DECODE_CASES).index(case))
    arrays = _cache_arrays(cfg, rng, quantize)
    fixed = _fixed_tokens(params, jcfg, arrays)
    last = np.where(fed.astype(bool), fixed, rng.integers(300, 400, N_SLOTS)).astype(np.int32)
    active, run = active.astype(bool), run.astype(np.int32)

    jcache, jt, js, jb, jl, ja, jr = _jax_decode(
        params, jcfg, _jax_cache(arrays), jnp.asarray(last), jnp.asarray(active), num_steps=K, use_pallas=False,
        run=jnp.asarray(run), repeat_window=window, pin_decode=pin)
    tcache = _torch_cache(arrays)
    with torch.inference_mode():
        (tt, ts, tb, tl, ta, tr), ran = model.launch_chunk(
            tcache, torch.from_numpy(last), torch.from_numpy(active), K, torch.from_numpy(run), window, pin,
            graphs.EagerLoops())
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    close(ts.numpy(), np.asarray(js))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    for ours, ref in zip((tl, ta, tr, tcache["len"]), (jl, ja, jr, jcache["len"])):
        assert np.array_equal(ours.numpy(), np.asarray(ref))
    for key in tcache:
        if key != "len":
            close(tcache[key].float().numpy(), np.asarray(jcache[key], np.float32))

    # the JAX loop ran while some slot was active: the longest slot's advance
    advance = np.asarray(jcache["len"]) - arrays["len"]
    assert ran.credit() == advance.max()
    if case == "free_early_stop":
        assert advance.tolist() == [WINDOW - r for r in run[:5]] + [WINDOW] and advance.max() < K
    if case in ("free_to_K", "pinned"):
        assert advance.max() == K
    if case == "pinned_none_active":
        assert advance.max() == 0 and (tt.numpy() == cfg.pad_token_id).all()


def test_decode_chunk_stand_in_graph_matches_eager(rec_models, stand_in):
    """The real chunk loop through the store: captured once for both
    chunks, each replay equal to the eager loop on the same cache, and
    packed outputs that the next replay leaves alone."""
    params, jcfg, model, cfg = rec_models
    arrays = _cache_arrays(cfg, np.random.default_rng(7), False)
    fixed = _fixed_tokens(params, jcfg, arrays)
    gcache, ecache = _torch_cache(arrays), _torch_cache(arrays)

    class StandIn(stand_in):
        """A capture runs nothing on the card: the cache that the stand-in's
        capture run commits to is put back."""

        def capture(self, program):
            saved = {k: v.clone() for k, v in gcache.items()}
            super().capture(program)
            for k, v in saved.items():
                gcache[k].copy_(v)

    store = graphs.LoopGraphs(StandIn)
    states = [(fixed, np.ones(N_SLOTS, bool), np.array([0, 1, 2, 3, 4, 5], np.int32)),
              (fixed + 1, np.array([1, 1, 0, 1, 0, 1], bool), np.zeros(N_SLOTS, np.int32))]
    packed = []
    with torch.inference_mode():
        for last, active, run in states:
            args = (torch.from_numpy(last), torch.from_numpy(active), K, torch.from_numpy(run), WINDOW, False)
            g_out, g_ran = model.launch_chunk(gcache, *args, store)
            e_out, e_ran = model.launch_chunk(ecache, *args, graphs.EagerLoops())
            for a, b in zip(g_out, e_out):
                assert torch.equal(a, b)
            assert g_ran.credit() == e_ran.credit()
            packed.append((_pack(*g_out[:3]), _pack(*g_out[:3]).clone()))
            for key in gcache:
                assert torch.equal(gcache[key], ecache[key])
    assert stand_in.captures == 1 and len(store.loops) == 1
    # the second replay rewrote the graph's outputs, not the first call's pack
    assert torch.equal(packed[0][0], packed[0][1]) and not torch.equal(packed[0][0], packed[1][0])


# -- layout and table recognition ---------------------------------------------------

@pytest.mark.parametrize("cap_bound", [False, True], ids=["as_called", "cap_bound"])
def test_layout_plain_loop_matches_jax(cap_bound):
    jcfg, pcfg = layout_configs("gqa", max_boxes=10)
    if cap_bound:  # no class ends a row: every row decodes max_boxes steps
        jcfg = dataclasses.replace(jcfg, eos_token_id=-1, pad_token_id=-1)
        pcfg = dataclasses.replace(pcfg, eos_token_id=-1, pad_token_id=-1)
    params = perturbed(jax_layout.init_params(jcfg, jax.random.PRNGKey(7)), 8)
    model = layout_from_jax(params, pcfg, "cpu")
    x = np.random.default_rng(9).uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    boxes, logits, valid = (np.asarray(a) for a in jax.jit(jax_layout.generate, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x)))
    with torch.inference_mode():
        (pb, pl, pv), ran = model.launch_generate(torch.from_numpy(x), graphs.EagerLoops())
    assert np.array_equal(pv.numpy(), valid) and np.array_equal(pb.numpy()[..., 6], boxes[..., 6])
    close(pb.numpy(), boxes)
    close(pl.numpy(), logits)
    # a row is done at the step after its last recorded one; the loop stops
    # once every row is
    stop = min(jcfg.max_boxes, valid.sum(1).max() + 1)
    assert ran.credit() == stop
    assert stop == jcfg.max_boxes if cap_bound else stop < jcfg.max_boxes


def test_table_rec_plain_loop_matches_jax():
    jcfg, pcfg = table_configs(max_boxes=12)
    params = perturbed(jax_trm.init_params(jcfg, jax.random.PRNGKey(21)), 22)
    model = table_from_jax(params, pcfg, "cpu")
    rng = np.random.default_rng(24)
    vec, seq_lens = prompt_vectors(rng)
    enc = rng.standard_normal((3, 256, 32)).astype(np.float32)
    script = np.full((jcfg.max_boxes,), -1, np.int32)
    script[:6] = [6, 7, 6, 8, 6, 7]
    script[7] = 1  # EOS: every row stops there, before max_boxes
    ref = jax.jit(jax_trm.generate, static_argnums=(1, 5))(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(enc), jnp.asarray(vec), jnp.asarray(seq_lens),
        jcfg.max_boxes, jnp.asarray(script))
    with torch.inference_mode():
        out, ran = model.launch_generate(torch.from_numpy(enc), torch.arange(3), torch.from_numpy(vec),
                                         torch.from_numpy(seq_lens), jcfg.max_boxes,
                                         torch.from_numpy(script.astype(np.int64)), graphs.EagerLoops())
    for k, v in ref.items():
        if k == "bbox":
            close(out[k].numpy(), np.asarray(v))
        else:
            assert np.array_equal(out[k].numpy(), np.asarray(v)), k
    # step 0 from the prefill, then loop steps 1..7: step 7's EOS ends every row
    assert ran.credit() == 7 and not out["valid"][:, 7:].any()


# -- the store ----------------------------------------------------------------------

class Counted:
    launches = 0


def _toy_loop(max_steps=6):
    """Steps add one to x and launch twice; the cond: fewer steps than `limit`."""
    limit = torch.zeros((), dtype=torch.int32)
    x = torch.zeros(3)
    n = torch.zeros((), dtype=torch.int32)
    pred = torch.zeros((), dtype=torch.bool)

    def begin():
        x.zero_()
        n.zero_()
        pred.copy_(n < limit)

    def step(i):
        graphs.count(Counted)
        graphs.count(Counted)
        x.add_(i + 1)
        n.add_(1)
        pred.copy_(n < limit)

    return graphs.Loop(max_steps, {"limit": limit}, (x, n), pred, begin, step)


def test_store_captures_once_per_key(stand_in):
    store = graphs.LoopGraphs(stand_in)
    built = []

    def build():
        built.append(1)
        return _toy_loop()

    for key, limit in [("a", 3), ("a", 5), ("b", 2), ("a", 1), ("b", 6)]:
        (x, n), ran = store.run(key, build, {"limit": torch.tensor(limit, dtype=torch.int32)})
        assert ran.credit() == int(n) == limit and x.tolist() == [limit * (limit + 1) / 2] * 3
    assert stand_in.captures == len(built) == len(store.loops) == 2 and set(store.captures) == {"a", "b"}


def test_store_copies_inputs_into_static_buffers(stand_in):
    store = graphs.LoopGraphs(stand_in)
    given = torch.tensor(4, dtype=torch.int32)
    store.run("a", _toy_loop, {"limit": given})
    static = store.loops["a"].loop.inputs["limit"]
    assert static is not given and int(static) == 4
    given.fill_(1)  # the caller's tensor is not the graph's
    assert int(static) == 4
    store.run("a", _toy_loop, {"limit": given})
    assert int(static) == 1
    with pytest.raises(KeyError):
        store.run("a", _toy_loop, {"other": given})


@pytest.mark.parametrize("limits", [(6, 2, 0, 4), (1, 1)], ids=["varied", "repeated"])
def test_store_scales_launch_counts_by_steps_run(stand_in, monkeypatch, limits):
    monkeypatch.setattr(Counted, "launches", 0)
    store = graphs.LoopGraphs(stand_in)
    store.run("a", _toy_loop, {"limit": torch.tensor(limits[0], dtype=torch.int32)})[1].credit()
    assert Counted.launches == 2 + 2 * limits[0]  # the warm-up step's own two, then the replay's
    assert store.loops["a"].per_step == {(Counted, "launches"): 2}
    for limit in limits[1:]:
        before = Counted.launches
        ran = store.run("a", _toy_loop, {"limit": torch.tensor(limit, dtype=torch.int32)})[1]
        assert Counted.launches == before  # nothing is counted until the outputs are read
        assert ran.credit() == limit and Counted.launches == before + 2 * limit
        ran.credit()  # credited once
        assert Counted.launches == before + 2 * limit


def test_store_capture_failure_raises_without_eager(stand_in, monkeypatch):
    def eager(*a, **k):
        raise AssertionError("the eager loop ran")

    monkeypatch.setattr(graphs, "run_eager", eager)
    monkeypatch.setattr(stand_in, "fail", True)
    store = graphs.LoopGraphs(stand_in)
    for attempt in range(2):  # nothing is kept: the next call captures again, and fails again
        with pytest.raises(RuntimeError, match="stand-in capture failed"):
            store.run("a", _toy_loop, {"limit": torch.tensor(3, dtype=torch.int32)})
    assert stand_in.captures == 2 and not store.loops


def test_eager_store_builds_every_call():
    """The plain store runs a new loop each call, its outputs its own."""
    store = graphs.EagerLoops()
    (x1, _), r1 = store.run("a", _toy_loop, {"limit": torch.tensor(2, dtype=torch.int32)})
    (x2, _), r2 = store.run("a", _toy_loop, {"limit": torch.tensor(5, dtype=torch.int32)})
    assert (r1.credit(), r2.credit()) == (2, 5) and x1.tolist() == [3.0] * 3 and x2.tolist() == [15.0] * 3


def test_cpu_predictors_build_no_graph(monkeypatch):
    def no_graph(*a, **k):
        raise AssertionError("a CPU predictor built a graph")

    monkeypatch.setattr(graphs.LoopGraphs, "run", no_graph)
    monkeypatch.setattr(graphs.CudaLoopGraph, "__init__", no_graph)
    rec = RecognitionPredictor(tiny=True, device="cpu")
    lay = LayoutPredictor(tiny=True, device="cpu")
    tab = TableRecPredictor(tiny=True, device="cpu")
    assert all(isinstance(p.loops, graphs.EagerLoops) for p in (rec, lay, tab))
    assert isinstance(graphs.loops_for("cuda"), graphs.LoopGraphs)
    from PIL import Image

    page = Image.new("RGB", (240, 80), "white")
    [res] = rec([page], bboxes=[[[4, 4, 200, 40]]], recognition_batch_size=2)
    assert rec.last_decoded_tokens > 0 and len(res.text_lines) == 1
    assert len(lay([page])) == 1 and lay.last_run["steps"]
    assert len(tab([page])) == 1 and tab.last_run["passes"][0]["steps"] >= 1


def test_slot_cache_is_kept_between_runs(stand_in):
    """One slot-cache store (whose address a decode graph holds) is kept
    between runs, as long as the longest cache asked for: a shorter cache is
    a view of its first bytes, its lengths zeroed, and the graphs of every
    length stay; a run that starts while another holds it makes its own; a
    longer cache, or other slots or quantisation, replaces it, and the
    graphs that read it go with it."""
    rec = RecognitionPredictor(tiny=True, device="cpu")
    rec.loops = graphs.LoopGraphs(stand_in)

    def chunk(cache):
        with torch.inference_mode():
            rec.model.launch_chunk(cache, torch.zeros(5, dtype=torch.int32), torch.ones(5, dtype=torch.bool), 2,
                                   None, 0, True, rec.loops)

    cache, store = rec._take_cache(5, 512, False)
    assert cache["k"].shape[3] == 512 and cache["k"].data_ptr() == store["k"].data_ptr()
    cache["len"].fill_(7)
    chunk(cache)
    rec._keep_cache(store)
    short, again = rec._take_cache(5, 256, False)
    assert again is store and not short["len"].any() and short["k"].data_ptr() == store["k"].data_ptr()
    assert short["k"].shape == qwen_decoder.init_cache(rec.config.decoder, 5, 256, rec.dtype, "cpu")["k"].shape
    assert short["k"].is_contiguous() and short["k"].shape[3] == 256
    _, other = rec._take_cache(5, 256, False)  # held: a new one
    assert other is not store
    chunk(short)
    rec._keep_cache(store)
    rec._keep_cache(other)  # one was kept meanwhile: this one goes
    assert rec._kept_cache is store and len(rec.loops.loops) == 2 and stand_in.captures == 2
    rec._keep_cache(rec._take_cache(5, 768, False)[1])  # longer: a new store, the graphs of the old go
    assert rec._kept_cache["k"].shape[3] == 768 and not rec.loops.loops
    view, longer = rec._take_cache(5, 512, False)
    chunk(view)
    rec._keep_cache(longer)
    assert len(rec.loops.loops) == 1
    rec._keep_cache(rec._take_cache(5, 512, True)[1])  # quantised: replaced again
    assert "k_scale" in rec._kept_cache and rec._kept_cache["k_scale"].shape[3] == 512 and not rec.loops.loops


def test_alternating_cache_lengths_capture_once(monkeypatch, stand_in):
    """Whole calls whose cache lengths alternate (a line, a square and a
    wide line at a 16-token budget: 256, 512 and 768 rows): each length is
    captured once while the kept store is long enough; a longer one (a
    page-sized block, 1280 rows) replaces the store and its graphs once;
    a call's text does not depend on the calls before it."""
    from PIL import Image
    from surya_tpu_torch.settings import settings as port_settings

    monkeypatch.setattr(port_settings, "RECOGNITION_MAX_TOKENS", 16)
    rec = RecognitionPredictor(tiny=True, device="cpu")
    taken = []
    take = rec._take_cache

    def spy(*args):
        taken.append(take(*args))
        return taken[-1]

    monkeypatch.setattr(rec, "_take_cache", spy)

    class StandIn(stand_in):
        """A capture runs nothing on the card: the cache that the stand-in's
        capture run commits to is put back."""

        def capture(self, program):
            cache = taken[-1][0]
            saved = {k: v.clone() for k, v in cache.items()}
            super().capture(program)
            for k, v in saved.items():
                cache[k].copy_(v)

    rec.loops = graphs.LoopGraphs(StandIn)
    page = Image.new("RGB", (1200, 1200), "white")
    calls = {"line": ("ocr_with_boxes", [4, 4, 200, 40]), "square": ("ocr_with_boxes", [4, 4, 400, 400]),
             "wide line": ("ocr_with_boxes", [4, 4, 1000, 200]),
             "page block": ("block_without_boxes", [4, 4, 1100, 1100])}
    lengths, texts = {}, {}

    def call(name):
        task, box = calls[name]
        [res] = rec([page], bboxes=[[box]], task_names=[task], recognition_batch_size=2)
        lengths[name] = taken[-1][0]["k"].shape[3]
        text = [line.text for line in res.text_lines]
        assert texts.setdefault(name, text) == text, f"{name}: the text changed with the calls before it"

    for name in ("wide line", "line", "square") * 3:
        call(name)
    assert lengths == {"line": 256, "square": 512, "wide line": 768}
    assert stand_in.captures == 3 and len(rec.loops.loops) == 3 and rec._kept_cache["k"].shape[3] == 768
    call("page block")  # longer than the store: a new store, captured anew
    assert lengths["page block"] == 1280 and stand_in.captures == 4 and len(rec.loops.loops) == 1
    for name in ("line", "page block", "square", "wide line") * 2:
        call(name)
    assert stand_in.captures == 7 and len(rec.loops.loops) == 4
