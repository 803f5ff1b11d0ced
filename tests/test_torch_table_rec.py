"""The port's table recognition against the JAX package's, on the CPU in
float32, on shared weights (carried over with table_rec.loader.
from_jax_params), with the same numpy inputs from a seeded generator:

- ``TableRecModel.embed_labels`` and ``generate`` against
  ``table_rec_model.embed_labels``/``generate`` at encoder depths (2, 2)
  with grouped kv heads, on right-padded prompts, with and without a
  ``category_script``;
- ``TableRecPredictor`` against the JAX predictor with
  ``install_synthetic_tables``, and on an empty list.

Continuous values agree within atol 1e-4 + rtol 1e-4. Discrete outputs (the
valid flags, categories, merges, colspans, header flags; row, column and
cell counts) are equal; a step where they differ is accepted only where the
port's top-2 logit gap of the property that differs (for colspan: the
distance of its value to the rounding boundary) is below 1e-4 at that step,
and the rest of that row is then not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import surya_tpu.table_rec as jax_table_pkg
from surya_tpu.models import adetr as jax_adetr
from surya_tpu.models import donut_swin as jax_swin
from surya_tpu.models import table_rec_model as jax_trm
from surya_tpu.table_rec import install_synthetic_tables as jax_install_synthetic_tables
from surya_tpu_torch.models import adetr, donut_swin, table_rec_model
from surya_tpu_torch.settings import settings
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables
from surya_tpu_torch.table_rec.loader import from_jax_params
from surya_tpu_torch.table_rec.shaper import LabelShaper

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
GAP = 1e-4
DISCRETE = ("valid", "category", "merges", "colspan", "is_header")


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.02, params)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def configs(max_boxes):
    enc_kw = dict(image_size=(128, 128), embed_dim=16, depths=(2, 2), num_heads=(2, 4), num_kv_heads=(1, 2),
                  encoder_length=1024)
    dec_kw = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64, encoder_hidden_size=32,
                  num_attention_heads=4, num_key_value_heads=2, double_residual_flow=False,
                  cross_attn_layers=(0, 1), self_attn_layers=(0, 1))
    kw = dict(box_embed_size=24, property_embed_size=8, max_boxes=max_boxes)
    jcfg = jax_trm.TableRecConfig(encoder=jax_swin.DonutSwinConfig(**enc_kw), decoder=jax_adetr.ADETRConfig(**dec_kw),
                                  **kw)
    pcfg = table_rec_model.TableRecConfig(encoder=donut_swin.DonutSwinConfig(**enc_kw),
                                          decoder=adetr.ADETRConfig(**dec_kw), **kw)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def shared():
    jcfg, pcfg = configs(max_boxes=12)
    params = perturbed(jax_trm.init_params(jcfg, jax.random.PRNGKey(21)), 22)
    return jcfg, params, from_jax_params(params, pcfg, "cpu")


def prompt_vectors(rng, B=3, L=8):
    """Right-padded prompts like the predictor's: bos row, a query label, the
    query-end row, then column labels; seq_lens below L."""
    vec = np.zeros((B, L, 10), np.int32)
    seq_lens = np.array([L, L - 2, 5], np.int32)[:B]
    for b in range(B):
        vec[b, 0] = 1
        vec[b, 1, :6] = rng.integers(0, 1025, 6)
        vec[b, 1, 6:] = [4 + 5, 5, 1, 5]
        vec[b, 2] = 4
        for t in range(3, seq_lens[b]):
            vec[b, t, :6] = rng.integers(0, 1025, 6)
            vec[b, t, 6:] = [2 + 5, 5, int(rng.integers(0, 3)), 5]
    return vec, seq_lens


def test_embed_labels_matches_jax(shared):
    jcfg, params, model = shared
    rng = np.random.default_rng(23)
    vec = rng.integers(-5, 1100, (4, 7, 10)).astype(np.int32)  # boxes out of range are clamped
    vec[..., 6] = rng.integers(0, 15, (4, 7))  # the category and merge tables' ids
    vec[..., 7] = rng.integers(0, 14, (4, 7))
    ref = np.asarray(jax_trm.embed_labels(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(vec)))
    with torch.inference_mode():
        out = model.embed_labels(torch.from_numpy(vec)).numpy()
    close(out, ref)


@pytest.mark.parametrize("scripted", [False, True], ids=["argmax", "category_script"])
def test_table_rec_generate_matches_jax(shared, scripted):
    jcfg, params, model = shared
    rng = np.random.default_rng(24)
    vec, seq_lens = prompt_vectors(rng)
    enc = rng.standard_normal((3, 256, 32)).astype(np.float32)
    max_steps = jcfg.max_boxes
    script = None
    if scripted:
        script = np.full((max_steps,), -1, np.int32)
        script[:7] = [6, 6, 7, 6, 8, 7, 6]  # raw ids: rows, columns, a cell; then the model's own argmax
        script[9] = 1  # EOS: every row stops there
    ref = jax.jit(jax_trm.generate, static_argnums=(1, 5))(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(enc), jnp.asarray(vec), jnp.asarray(seq_lens),
        max_steps, None if script is None else jnp.asarray(script))
    ref = {k: np.asarray(v) for k, v in ref.items()}

    heads = []
    record = model.head_outputs

    def recording(hidden):
        out = record(hidden)
        heads.append({k: v.numpy() for k, v in out.items()})
        return out

    model.head_outputs = recording
    try:
        with torch.inference_mode():
            out = model.generate(torch.from_numpy(enc), torch.from_numpy(vec), torch.from_numpy(seq_lens), max_steps,
                                 category_script=script)
    finally:
        del model.head_outputs
    out = {k: v.numpy() for k, v in out.items()}

    def gap(r, t):
        if t >= len(heads):
            return np.inf
        h = heads[t]
        gaps = [np.diff(np.sort(h[k][r].astype(np.float64))[-2:])[0] for k in ("category", "merges", "is_header")]
        x = max(float(h["colspan"][r, 0]), 1.0)
        gaps.append(abs(x - np.floor(x) - 0.5))
        return min(gaps)

    compared = 0
    for r in range(3):
        for t in range(max_steps):
            if any(ref[k][r, t] != out[k][r, t] for k in DISCRETE):
                assert gap(r, t) < GAP, f"row {r} step {t} differs with a gap of {gap(r, t)}"
                break
            close(out["bbox"][r, t], ref["bbox"][r, t])
            compared += 1
    assert compared > 3 * 2
    if scripted:
        assert not ref["valid"][:, 9:].any() and ref["valid"][:, :7].all()
        np.testing.assert_array_equal(out["category"][:, :7], np.tile(np.array([6, 6, 7, 6, 8, 7, 6]) - 5, (3, 1)))


# -- predictors ------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors(shared):
    jcfg, params, _ = shared
    pcfg = configs(max_boxes=settings.TABLE_REC_MAX_BOXES)[1]
    jcfg = configs(max_boxes=settings.TABLE_REC_MAX_BOXES)[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_table_pkg, "load_table_rec_model", lambda checkpoint=None, tiny=False: (
        jax.tree.map(jnp.asarray, params), jcfg))
    try:
        jax_pred = jax_table_pkg.TableRecPredictor()
    finally:
        mp.undo()
    return jax_pred, TableRecPredictor(device="cpu", jax_params=params, config=pcfg)


def table_images():
    images = []
    for k, (w, h) in enumerate([(512, 512), (640, 400), (300, 500)]):
        image = Image.new("RGB", (w, h), "white")
        draw = ImageDraw.Draw(image)
        for i in range(4):
            for j in range(3):
                x0, y0 = j * w // 3, i * h // 4
                draw.rectangle((x0 + 5, y0 + 5, x0 + w // 3 - 5, y0 + h // 4 - 5), outline="black")
                draw.text((x0 + 20, y0 + 20), f"t{k}r{i}c{j}", fill="black")
        images.append(image)
    return images


def test_table_rec_predictor_matches_jax(predictors):
    jax_pred, pred = predictors
    jax_install_synthetic_tables(jax_pred, n_rows=3, n_cols=2, n_cells=2)
    install_synthetic_tables(pred, n_rows=3, n_cols=2, n_cells=2)
    images = table_images()
    ref = jax_pred([im.copy() for im in images])
    # one batch of 3 crops on both sides: every row query takes every
    # column of its batch as context, so the batches must match
    ours = pred([im.copy() for im in images])
    assert len(ours) == len(ref) == 3
    assert [p["rows"] for p in pred.last_run["passes"]] == [3, 9] and pred.last_run["cell_batch"] == [16]
    for o, r in zip(ours, ref):
        assert len(o.rows) == len(r.rows) == 3 and len(o.cols) == len(r.cols) == 2
        assert o.image_bbox == r.image_bbox
        for name in ("rows", "cols", "cells", "unmerged_cells"):
            a, b = getattr(o, name), getattr(r, name)
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                close(x.polygon, y.polygon)
        for x, y in zip(o.cells, r.cells):
            assert (x.row_id, x.col_id, x.colspan, x.rowspan, x.is_header) == \
                (y.row_id, y.col_id, y.colspan, y.rowspan, y.is_header)


def test_table_rec_predictor_empty(predictors):
    jax_pred, pred = predictors
    assert pred([]) == [] == jax_pred([])


def test_cell_batch_doubles_to_the_cap(predictors, monkeypatch):
    _, pred = predictors
    install_synthetic_tables(pred, n_rows=5, n_cols=2, n_cells=1)
    monkeypatch.setattr(settings, "TABLE_REC_CELL_BATCH_MAX", 4)
    pred(table_images()[:2], batch_size=1)
    # batch 1 doubles to the cap 4 for 5 row queries: passes of 4 and 1 rows
    assert pred.last_run["cell_batch"] == [4, 4]
    assert [p["rows"] for p in pred.last_run["passes"]] == [1, 4, 1, 1, 4, 1]


def test_shaper_roundtrip():
    shaper = LabelShaper()
    comp = [{"polygon": [[10, 10], [500, 10], [500, 300], [10, 300]], "category": 4, "colspan": 0, "merges": 0,
             "is_header": 0}]
    out = shaper.convert_polygons_to_bboxes(comp)
    assert out[0]["bbox"] == pytest.approx([255.0, 155.0, 490.0, 290.0, 512.0, 512.0])
    np.testing.assert_allclose(shaper.convert_bbox_to_polygon(out[0]["bbox"]),
                               [[10, 10], [500, 10], [500, 300], [10, 300]])
    assert shaper.dict_to_labels(out)[0][6:] == [9, 5, 0, 5]
