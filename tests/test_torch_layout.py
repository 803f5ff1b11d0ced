"""The port's layout stack against the JAX package's, on the CPU in float32,
on shared weights (carried over with layout.loader.from_jax_params), with
the same numpy inputs from a seeded generator:

- ``DonutSwin`` against ``donut_swin.apply`` at depths (2, 2), so that the
  shifted-window blocks run, with full and with grouped kv heads (tiled);
- ``ADETRDecoder.prefill`` and ``step`` against ``adetr.prefill``/``step``
  with both residual flows, layers without a cross or a self block, and a
  right-padded prompt (prompt_len > seq_len) whose padded rows are masked;
- ``LayoutModel.generate`` against ``layout_model.generate``;
- ``LayoutPredictor`` against the JAX predictor on a page above 1500 px
  (the slicer) and a small page, and its pipelined batches against one
  dispatch.

Continuous values agree within atol 1e-4 + rtol 1e-4. Discrete outputs
(labels, the valid flags, positions) are equal; a step where they differ is
accepted only where the top-2 logit gap at that step is below 1e-4, and the
rest of that row is then not compared (the AR loop has forked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import surya_tpu.layout as jax_layout_pkg
from surya_tpu.models import adetr as jax_adetr
from surya_tpu.models import donut_swin as jax_swin
from surya_tpu.models import layout_model as jax_layout
from surya_tpu.settings import settings as jax_settings
from surya_tpu_torch import nn as pnn
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.layout.loader import from_jax_params
from surya_tpu_torch.models import adetr, donut_swin, layout_model
from surya_tpu_torch.settings import settings

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
GAP = 1e-4

SWIN = dict(image_size=(128, 128), embed_dim=16, depths=(2, 2), encoder_length=1024)
SWIN_HEADS = {"mha": dict(num_heads=(2, 4), num_kv_heads=(2, 4)), "gqa": dict(num_heads=(2, 4), num_kv_heads=(1, 2))}


def perturbed(params, seed):
    """numpy leaves with noise added, so that every leaf (zero-initialized
    tables and biases, unit norms) matters to the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.02, params)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0]


def compare_ar(rows, steps, same, gap, compare_step):
    """Walk each row's steps; where same(r, t) fails, require gap(r, t) < GAP
    and stop comparing that row, else compare_step(r, t). Returns the number
    of steps compared."""
    n = 0
    for r in range(rows):
        for t in range(steps):
            if not same(r, t):
                assert gap(r, t) < GAP, f"row {r} step {t} differs with a top-2 logit gap of {gap(r, t)}"
                break
            compare_step(r, t)
            n += 1
    return n


def layout_configs(heads="gqa", max_boxes=10):
    enc_kw = dict(SWIN, **SWIN_HEADS[heads])
    jenc, penc = jax_swin.DonutSwinConfig(**enc_kw), donut_swin.DonutSwinConfig(**enc_kw)
    dec_kw = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64, encoder_hidden_size=jenc.hidden_size,
                  num_attention_heads=4, num_key_value_heads=2, cross_attn_layers=(0, 1), self_attn_layers=(0, 1))
    jcfg = jax_layout.LayoutConfig(max_boxes=max_boxes, encoder=jenc, decoder=jax_adetr.ADETRConfig(**dec_kw))
    pcfg = layout_model.LayoutConfig(max_boxes=max_boxes, encoder=penc, decoder=adetr.ADETRConfig(**dec_kw))
    return jcfg, pcfg


@pytest.mark.parametrize("heads", sorted(SWIN_HEADS))
def test_donut_swin_matches_jax(heads):
    jcfg = jax_swin.DonutSwinConfig(**SWIN, **SWIN_HEADS[heads])
    params = perturbed(jax_swin.init_params(jcfg, jax.random.PRNGKey(1)), 2)
    model = donut_swin.DonutSwin(donut_swin.DonutSwinConfig(**SWIN, **SWIN_HEADS[heads]))
    pnn.load_jax_params(model, params)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_swin.apply, static_argnums=1)(params, jcfg, jnp.asarray(x)))
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 256, 32)
    close(out, ref)


def test_shift_and_tables_match_jax():
    """The static tables are the JAX package's, bit for bit."""
    np.testing.assert_array_equal(donut_swin._relative_position_index(8), jax_swin._relative_position_index(8))
    np.testing.assert_array_equal(donut_swin._shift_mask(32, 16, 8, 4), jax_swin._shift_mask(32, 16, 8, 4))
    np.testing.assert_array_equal(donut_swin._sincos_2d(16, 8, 32), jax_swin._sincos_2d(16, 8, 32))


ADETR_CASES = {
    "double_residual": dict(double_residual_flow=True, cross_attn_layers=(0, 1), self_attn_layers=(0, 1)),
    "single_residual_sparse": dict(double_residual_flow=False, cross_attn_layers=(0,), self_attn_layers=(1,)),
}


@pytest.mark.parametrize("case", sorted(ADETR_CASES))
def test_adetr_prefill_and_steps_match_jax(case):
    kw = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64, encoder_hidden_size=24,
              num_attention_heads=4, num_key_value_heads=2, **ADETR_CASES[case])
    jcfg = jax_adetr.ADETRConfig(**kw)
    params = perturbed(jax_adetr.init_params(jcfg, jax.random.PRNGKey(4)), 5)
    dec = adetr.ADETRDecoder(adetr.ADETRConfig(**kw))
    pnn.load_jax_params(dec, params)
    dec.eval()
    rng = np.random.default_rng(6)
    B, L, n_steps = 3, 6, 4
    enc = rng.standard_normal((B, 20, 24)).astype(np.float32)
    embeds = rng.standard_normal((B, L, 32)).astype(np.float32)
    seq_lens = np.array([6, 4, 2], np.int32)  # right-padded: prompt_len L > seq_len
    step_embeds = rng.standard_normal((n_steps, B, 32)).astype(np.float32)

    jp = jax.tree.map(jnp.asarray, params)
    ck, cv = jax_adetr.precompute_cross_kv(jp, jcfg, jnp.asarray(enc))
    cache = jax_adetr.init_cache(jcfg, B, L + n_steps + 1, jnp.float32)
    cache, last = jax_adetr.prefill(jp, jcfg, cache, ck, cv, jnp.asarray(embeds), jnp.asarray(seq_lens))
    ref_hidden = [np.asarray(last)]
    for i in range(n_steps):
        cache, h = jax_adetr.step(jp, jcfg, cache, ck, cv, jnp.asarray(step_embeds[i]),
                                  jnp.asarray(seq_lens + i), write_idx=jnp.full((B,), L + i, jnp.int32),
                                  seq_lens=jnp.asarray(seq_lens), prompt_len=L)
        ref_hidden.append(np.asarray(h))

    with torch.inference_mode():
        pck, pcv = dec.precompute_cross_kv(torch.from_numpy(enc))
        close(pck, ck)
        close(pcv, cv)
        pcache = dec.init_cache(B, L + n_steps + 1, torch.float32, "cpu")
        sl = torch.from_numpy(seq_lens)
        hidden = [dec.prefill(pcache, pck, pcv, torch.from_numpy(embeds), sl).numpy()]
        for i in range(n_steps):
            hidden.append(dec.step(pcache, pck, pcv, torch.from_numpy(step_embeds[i]), sl + i,
                                   write_idx=torch.full((B,), L + i, dtype=torch.int32), seq_lens=sl,
                                   prompt_len=L).numpy())
    for h, r in zip(hidden, ref_hidden):
        close(h, r)
    close(pcache["k"], cache["k"])
    close(pcache["v"], cache["v"])


def test_adetr_step_masks_padded_prompt_rows():
    """A step's output does not depend on what the padded prompt rows hold."""
    cfg = adetr.ADETRConfig(num_hidden_layers=1, hidden_size=16, intermediate_size=32, encoder_hidden_size=8,
                            num_attention_heads=2, num_key_value_heads=1, cross_attn_layers=(0,),
                            self_attn_layers=(0,))
    torch.manual_seed(0)
    dec = adetr.ADETRDecoder(cfg)
    with torch.inference_mode():
        ck, cv = dec.precompute_cross_kv(torch.randn(2, 5, 8))
        embeds = torch.randn(2, 4, 16)
        seq_lens = torch.tensor([2, 3], dtype=torch.int32)
        outs = []
        for fill in (0.0, 5.0):
            cache = dec.init_cache(2, 8, torch.float32, "cpu")
            e = embeds.clone()
            e[0, 2:] = fill
            e[1, 3:] = fill
            dec.prefill(cache, ck, cv, e, seq_lens)
            outs.append(dec.step(cache, ck, cv, torch.randn(2, 16, generator=torch.Generator().manual_seed(1)),
                                 seq_lens, write_idx=torch.full((2,), 4), seq_lens=seq_lens, prompt_len=4))
    torch.testing.assert_close(outs[0], outs[1])


@pytest.mark.parametrize("heads", sorted(SWIN_HEADS))
def test_layout_generate_matches_jax(heads):
    jcfg, pcfg = layout_configs(heads, max_boxes=10)
    params = perturbed(jax_layout.init_params(jcfg, jax.random.PRNGKey(7)), 8)
    model = from_jax_params(params, pcfg, "cpu")
    x = np.random.default_rng(9).uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    boxes, logits, valid = (np.asarray(a) for a in jax.jit(jax_layout.generate, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x)))
    with torch.inference_mode():
        pb, pl, pv = (a.numpy() for a in model.generate(torch.from_numpy(x)))
    assert pb.shape == boxes.shape and pl.shape == logits.shape and pv.shape == valid.shape

    def same(r, t):
        return valid[r, t] == pv[r, t] and boxes[r, t, 6] == pb[r, t, 6]

    def gap(r, t):
        return min(top2_gap(lg[r, t]) for lg in (logits, pl) if lg[r, t].any())

    def compare_step(r, t):
        close(pb[r, t], boxes[r, t])
        close(pl[r, t], logits[r, t])

    assert compare_ar(3, jcfg.max_boxes, same, gap, compare_step) > 0


def test_done_watch_stops_late_with_the_same_outputs():
    """A loop that polls every step stops at most 2 * every - 1 steps after
    every row is done; the steps past it record nothing."""
    watch = adetr.DoneWatch(torch.device("cpu"))
    done = torch.zeros(2, dtype=torch.bool)
    stopped = None
    for step in range(1, 100):
        if step == 5:
            done[:] = True
        if watch.poll(done):
            stopped = step
            break
    assert stopped is not None and 5 <= stopped < 5 + 2 * adetr.DoneWatch.every
    assert watch.steps == stopped and watch.syncs == 0


# -- predictors ------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    """The JAX and the port's LayoutPredictor on the same weights."""
    jcfg, pcfg = layout_configs("gqa", max_boxes=settings.LAYOUT_MAX_BOXES)
    params = perturbed(jax_layout.init_params(jcfg, jax.random.PRNGKey(11)), 12)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layout_pkg, "load_layout_model", lambda checkpoint=None, tiny=False: (
        jax.tree.map(jnp.asarray, params), jcfg))
    try:
        jax_pred = jax_layout_pkg.LayoutPredictor()
    finally:
        mp.undo()
    return jax_pred, LayoutPredictor(device="cpu", jax_params=params, config=pcfg)


def layout_pages():
    rng = np.random.default_rng(13)
    tall = Image.new("RGB", (700, 2600), "white")
    d = ImageDraw.Draw(tall)
    for k in range(12):
        y = 60 + 200 * k
        d.rectangle((40, y, 40 + int(rng.integers(200, 600)), y + 40), fill="black")
    small = Image.fromarray(rng.integers(0, 256, (300, 420, 3), dtype=np.uint8))
    gray = Image.new("RGB", (500, 500), "white")
    ImageDraw.Draw(gray).text((20, 30), "Title", fill="black", font_size=40)
    return [tall, small, gray]


def assert_same_layout(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.image_bbox == r.image_bbox and o.sliced == r.sliced
        assert [b.label for b in o.bboxes] == [b.label for b in r.bboxes]
        assert [b.position for b in o.bboxes] == [b.position for b in r.bboxes]
        for ob, rb in zip(o.bboxes, r.bboxes):
            close(ob.polygon, rb.polygon)
            assert ob.top_k.keys() == rb.top_k.keys()
            close(list(ob.top_k.values()), list(rb.top_k.values()))
            close(ob.confidence, rb.confidence)


def test_layout_predictor_matches_jax(predictors):
    jax_pred, pred = predictors
    pages = layout_pages()
    ref = jax_pred([p.copy() for p in pages])
    ours = pred([p.copy() for p in pages])
    assert ours[0].sliced and ours[0].image_bbox[3] == 2600
    assert pred.last_run["tiles"] == [4, 1] and sum(len(r.bboxes) for r in ours) > 0  # 3 + 1 tiles, then 1
    assert_same_layout(ours, ref)


def test_layout_pipelined_batches_match_one_dispatch(predictors, monkeypatch):
    _, pred = predictors
    pages = layout_pages()
    monkeypatch.setattr(settings, "LAYOUT_PIPELINE_BATCH", None)
    base = pred([p.copy() for p in pages], batch_size=8)
    assert pred.last_run["tiles"] == [5]
    monkeypatch.setattr(settings, "LAYOUT_PIPELINE_BATCH", 2)
    piped = pred([p.copy() for p in pages], batch_size=8)
    assert pred.last_run["tiles"] == [3, 2]  # the tall page's 3 tiles alone, then two pages
    assert_same_layout(piped, base)


def test_layout_predictor_settings(predictors):
    _, pred = predictors
    assert LayoutPredictor.default_batch_sizes == {"cpu": 4, "cuda": 16}
    assert pred.get_batch_size() == (settings.LAYOUT_BATCH_SIZE or 4)
    assert settings.LAYOUT_SLICE_MIN == jax_settings.LAYOUT_SLICE_MIN
    assert settings.LAYOUT_SLICE_SIZE == jax_settings.LAYOUT_SLICE_SIZE
    assert settings.LAYOUT_MAX_BOXES == jax_settings.LAYOUT_MAX_BOXES
