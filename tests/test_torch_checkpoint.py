"""Checkpoint loading of the port against the JAX package's, on the CPU at
the JAX package's tiny widths in float32.

For each of the five models a port model built from a seed (every leaf
perturbed, so that zero tables and unit norms matter) is written as an
upstream checkpoint directory by ``chip_smoke.py``'s exporter: upstream's
torch key names and layouts in a safetensors file, a config.json and the
tokenizer files. Then:

- the JAX package's ``convert_torch``, given a ``TensorBag``, consumes every
  key of that state dict and gives back the source model's parameters
  exactly (the folded batch-norms: the fold of what was written);
- the port's ``convert_torch`` of the same tensors equals JAX's tree leaf
  for leaf, exactly;
- the JAX predictor and the port's predictor built from that directory give
  the same outputs: token ids on given lines and on a whole page, and
  detection, layout, table and OCR-error outputs within the tolerances of
  tests/test_torch_{detection,layout,table_rec,ocr_error}.py.

Also: a bf16 checkpoint loads in the port; the converted-weight cache is
read on the second load and converted again when unreadable; int8 decoder
weights after a checkpoint load equal the JAX loader's; the Qwen2 math
tokenizer's ids equal JAX's; the manifest fetch; no construction under the
test settings reaches for the network; and the stage timers.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import chip_smoke
from surya_tpu.common import profiling as jax_profiling
from surya_tpu.common.weights import TensorBag as JaxTensorBag
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.layout import LayoutPredictor as JaxLayoutPredictor
from surya_tpu.models import distilbert as jax_distilbert
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.models import foundation as jax_foundation
from surya_tpu.models import layout_model as jax_layout_model
from surya_tpu.models import table_rec_model as jax_table_model
from surya_tpu.ocr_error import OCRErrorPredictor as JaxOCRErrorPredictor
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.recognition.loader import load_recognition_model as jax_load_recognition
from surya_tpu.recognition.tokenizer import QwenMathTokenizer as JaxQwenMathTokenizer
from surya_tpu.settings import settings as jax_settings
from surya_tpu.table_rec import TableRecPredictor as JaxTableRecPredictor
from surya_tpu.table_rec import install_synthetic_tables as jax_install_synthetic_tables
from surya_tpu_torch.common import checkpoint, profiling, s3
from surya_tpu_torch.common.checkpoint import state_dict_from_jax
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models import distilbert, efficientvit, foundation, layout_model, table_rec_model
from surya_tpu_torch.models.distilbert import DistilBert
from surya_tpu_torch.models.efficientvit import EfficientViT
from surya_tpu_torch.models.foundation import FoundationModel
from surya_tpu_torch.models.layout_model import LayoutModel
from surya_tpu_torch.models.table_rec_model import TableRecModel
from surya_tpu_torch.nn import QuantLinear
from surya_tpu_torch.ocr_error import OCRErrorPredictor
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.recognition.tokenizer import QwenMathTokenizer
from surya_tpu_torch.settings import settings
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

torch.set_num_threads(1)

ATOL = RTOL = 1e-4  # tests/test_torch_{layout,table_rec}.py
# kind -> (port predictor, JAX predictor, port model, port convert_torch, JAX convert_torch)
KINDS = {
    "detection": (DetectionPredictor, JaxDetectionPredictor, EfficientViT, efficientvit.convert_torch,
                  jax_evit.convert_torch),
    "recognition": (RecognitionPredictor, JaxRecognitionPredictor, FoundationModel, foundation.convert_torch,
                    jax_foundation.convert_torch),
    "layout": (LayoutPredictor, JaxLayoutPredictor, LayoutModel, layout_model.convert_torch,
               jax_layout_model.convert_torch),
    "table_rec": (TableRecPredictor, JaxTableRecPredictor, TableRecModel, table_rec_model.convert_torch,
                  jax_table_model.convert_torch),
    "ocr_error": (OCRErrorPredictor, JaxOCRErrorPredictor, DistilBert, distilbert.convert_torch,
                  jax_distilbert.convert_torch),
}


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Predictors built with checkpoint=None resolve no s3:// default: every
    *_MODEL_CHECKPOINT setting names a path that does not exist."""
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(settings, name, os.devnull)
        yield


def source_predictor(kind, seed=0, dtype=None):
    """The port's tiny random predictor of `kind`, every parameter perturbed
    by N(0, 0.02^2) noise from `seed`."""
    cls = KINDS[kind][0]
    pred = cls(None, True, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pred.model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    if dtype is not None:
        pred.model.to(dtype)
    return pred


def write(kind, path, pred, seed=1):
    return chip_smoke.write_checkpoint(path, kind, pred.model, pred.config, torch.Generator().manual_seed(seed))


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, (*prefix, str(i)))
    else:
        yield "/".join(prefix), np.asarray(tree)


def tensors_of(path):
    from safetensors.numpy import load_file

    return load_file(str(path / "model.safetensors"))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """kind -> (source predictor, checkpoint dir, JAX predictor, port
    predictor), the JAX predictor built first (it reads every *.safetensors
    of the directory, and the port's cache is one)."""
    root = tmp_path_factory.mktemp("checkpoints")
    out = {}
    for i, (kind, (cls, jax_cls, *_)) in enumerate(KINDS.items()):
        src = source_predictor(kind, seed=10 + i)
        path = root / kind
        write(kind, path, src)
        out[kind] = (src, path, jax_cls(checkpoint=str(path)), cls(str(path), device="cpu"))
    return out


def bitwise_same(model, ref):
    got, want = model.state_dict(), ref.state_dict()
    assert list(got) == list(want)
    bad = [k for k in want if not chip_smoke.bitwise_equal(got[k], want[k])]
    assert not bad, bad[:5]


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_conversion_consumes_the_exported_keys(checkpoints, kind):
    src, path, jax_pred, _ = checkpoints[kind]
    tensors = tensors_of(path)
    bag = JaxTensorBag(tensors, jnp.float32)
    tree = jax.tree.map(np.asarray, KINDS[kind][4](bag, jax_pred.config))
    assert set(tensors) <= bag.used, sorted(set(tensors) - bag.used)[:5]
    make = KINDS[kind][2]
    model = make(src.config)
    model.load_state_dict(state_dict_from_jax(lambda: make(src.config), tree, torch.float32))
    bitwise_same(model, src.model)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_conversion_equals_jax(checkpoints, kind):
    src, path, jax_pred, pred = checkpoints[kind]
    tensors = tensors_of(path)
    ours = dict(flat(KINDS[kind][3](dict(tensors), pred.config)))
    ref = dict(flat(KINDS[kind][4](JaxTensorBag(dict(tensors), jnp.float32), jax_pred.config)))
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], ref[k]), k
    assert pred.config == src.config
    bitwise_same(pred.model, src.model)


def assert_same_detection(ours, ref):  # tests/test_torch_detection.py's rule
    assert len(ours) == len(ref)
    for page, ref_page in zip(ours, ref):
        assert page.image_bbox == ref_page.image_bbox
        assert len(page.bboxes) == len(ref_page.bboxes)
        for box, ref_box in zip(page.bboxes, ref_page.bboxes):
            assert np.abs(np.asarray(box.polygon) - np.asarray(ref_box.polygon)).max() < 1e-3
            assert abs(box.confidence - ref_box.confidence) < 1e-4


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=ATOL, rtol=RTOL)


def text_page(lines=3):
    img = Image.new("RGB", (640, 480), "white")
    d = ImageDraw.Draw(img)
    for i in range(lines):
        d.text((20, 30 + i * 60), f"line {i} of sample text", fill="black", font_size=26)
    return img


def tokens_of(pred, call):
    """call() with pred's prediction loop recorded; (its result, the token
    ids of every line)."""
    loop, runs = pred.prediction_loop, []

    def recording(*args, **kwargs):
        runs.append(loop(*args, **kwargs))
        return runs[-1]

    pred.prediction_loop = recording
    try:
        result = call()
    finally:
        del pred.prediction_loop
    return result, [list(map(int, t)) for run in runs for t in run[0]]


@pytest.fixture
def native_postprocess(monkeypatch):
    monkeypatch.setattr(jax_settings, "USE_NATIVE_POSTPROCESS", True)
    monkeypatch.setattr(settings, "USE_NATIVE_POSTPROCESS", True)


def test_detection_from_one_directory_agrees(checkpoints, native_postprocess):
    _, _, jdet, det = checkpoints["detection"]
    jax_evit.install_blob_detector(jdet)  # random weights find no lines: both see dark pixels
    efficientvit.install_blob_detector(det)
    pages = [text_page(3), text_page(5)]
    got, want = det([p.copy() for p in pages]), jdet([p.copy() for p in pages])
    assert [len(r.bboxes) for r in got] == [3, 5]
    assert_same_detection(got, want)


def test_recognition_from_one_directory_agrees(checkpoints, native_postprocess, monkeypatch):
    _, _, jrec, rec = checkpoints["recognition"]
    assert len(rec.processor.tokenizer.math_tokenizer) == 256  # the exporter's Qwen2 BPE
    page = text_page(3)
    bboxes = [[[10, 20, 400, 70], [10, 90, 300, 140], [10, 150, 500, 200]]]
    got, ids = tokens_of(rec, lambda: rec([page.copy()], bboxes=bboxes))
    want, ref_ids = tokens_of(jrec, lambda: jrec([page.copy()], bboxes=bboxes))
    assert ids == ref_ids and sum(map(len, ids)) > 0
    assert [ln.text for ln in got[0].text_lines] == [ln.text for ln in want[0].text_lines]
    # one whole page, detected by the detection checkpoint's predictors
    _, _, jdet, det = checkpoints["detection"]
    jax_evit.install_blob_detector(jdet)
    efficientvit.install_blob_detector(det)
    got, ids = tokens_of(rec, lambda: rec([page.copy()], det_predictor=det))
    want, ref_ids = tokens_of(jrec, lambda: jrec([page.copy()], det_predictor=jdet))
    assert len(ids) == 3 and ids == ref_ids
    assert [ln.polygon for ln in got[0].text_lines] == [ln.polygon for ln in want[0].text_lines]


def test_layout_from_one_directory_agrees(checkpoints):
    _, _, jlay, lay = checkpoints["layout"]
    pages = [text_page(4), Image.new("RGB", (700, 1800), "white")]
    got, want = lay([p.copy() for p in pages]), jlay([p.copy() for p in pages])
    assert len(got) == len(want) == 2 and got[1].sliced
    for o, r in zip(got, want):
        assert o.image_bbox == r.image_bbox and o.sliced == r.sliced
        assert [(b.label, b.position) for b in o.bboxes] == [(b.label, b.position) for b in r.bboxes]
        for ob, rb in zip(o.bboxes, r.bboxes):
            close(ob.polygon, rb.polygon)
            close(ob.confidence, rb.confidence)


def test_table_rec_from_one_directory_agrees(checkpoints):
    _, _, jtab, tab = checkpoints["table_rec"]
    jax_install_synthetic_tables(jtab, n_rows=3, n_cols=2, n_cells=2)
    install_synthetic_tables(tab, n_rows=3, n_cols=2, n_cells=2)
    images = [text_page(4), text_page(2).resize((400, 300))]
    got, want = tab([im.copy() for im in images]), jtab([im.copy() for im in images])
    assert len(got) == len(want) == 2
    for o, r in zip(got, want):
        assert len(o.rows) == len(r.rows) == 3 and len(o.cols) == len(r.cols) == 2
        for name in ("rows", "cols", "cells", "unmerged_cells"):
            a, b = getattr(o, name), getattr(r, name)
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                close(x.polygon, y.polygon)
        for x, y in zip(o.cells, r.cells):
            assert (x.row_id, x.col_id, x.colspan, x.rowspan, x.is_header) == \
                (y.row_id, y.col_id, y.colspan, y.rowspan, y.is_header)


def test_ocr_error_from_one_directory_agrees(checkpoints):
    _, path, jerr, err = checkpoints["ocr_error"]
    texts = ["hello world.", "h3ll0 w0rld", "ok", "the quick brown fox jumps over the lazy dog", "x" * 40]
    assert err.processor.vocab is not None and len(err.processor.vocab) == err.config.vocab_size
    assert err.processor(texts) == jerr.processor(texts)  # vocab.txt read on both sides
    got, want = err(texts, batch_size=4), jerr(texts, batch_size=4)
    assert got.labels == want.labels and len(got.labels) == len(texts)


def test_a_bf16_checkpoint_loads(tmp_path):
    """Upstream ships bfloat16: the port reads it (framework="pt") and holds
    exactly the stored values, in float32 on the CPU."""
    src = source_predictor("layout", seed=3, dtype=torch.bfloat16)
    write("layout", tmp_path, src)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        assert f.get_tensor("decoder.lm_head.weight").dtype == torch.bfloat16
    pred = LayoutPredictor(str(tmp_path), device="cpu")
    assert pred.model.lm_head.weight.dtype == torch.float32
    want = {k: v.float() for k, v in src.model.state_dict().items()}
    got = pred.model.state_dict()
    assert all(chip_smoke.bitwise_equal(got[k], want[k]) for k in want)


def test_the_second_load_reads_the_cache(tmp_path, monkeypatch):
    src = source_predictor("detection", seed=4)
    write("detection", tmp_path, src)
    first = DetectionPredictor(str(tmp_path), device="cpu")
    cache = checkpoint.cache_path(str(tmp_path), "detection", torch.float32)
    assert cache.name == ".torch_cache_detection_float32_v1.safetensors" and cache.exists()

    def no_conversion(*args, **kwargs):
        raise AssertionError("converted again although the cache is there")

    monkeypatch.setattr(checkpoint, "load_safetensors_dir", no_conversion)
    second = DetectionPredictor(str(tmp_path), device="cpu")
    bitwise_same(second.model, first.model)
    bitwise_same(second.model, src.model)


def test_an_unreadable_cache_is_converted_again(tmp_path, caplog):
    src = source_predictor("ocr_error", seed=5)
    write("ocr_error", tmp_path, src)
    cache = checkpoint.cache_path(str(tmp_path), "ocr_error", torch.float32)
    cache.write_bytes(b"not a safetensors file")
    with caplog.at_level(logging.WARNING, logger="surya_tpu_torch"):
        pred = OCRErrorPredictor(str(tmp_path), device="cpu")
    assert "cache unreadable" in caplog.text
    bitwise_same(pred.model, src.model)
    assert checkpoint.load_converted(str(tmp_path), "ocr_error", torch.float32) is not None  # written anew


def test_a_failed_cache_write_warns_and_goes_on(tmp_path, monkeypatch, caplog):
    import safetensors.torch

    src = source_predictor("table_rec", seed=6)
    write("table_rec", tmp_path, src)

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(safetensors.torch, "save_file", full_disk)
    with caplog.at_level(logging.WARNING, logger="surya_tpu_torch"):
        pred = TableRecPredictor(str(tmp_path), device="cpu")
    assert "could not cache converted weights" in caplog.text
    assert not checkpoint.cache_path(str(tmp_path), "table_rec", torch.float32).exists()
    bitwise_same(pred.model, src.model)


def test_weight_quantize_after_a_checkpoint_load_equals_jax(checkpoints, monkeypatch):
    _, path, _, _ = checkpoints["recognition"]
    monkeypatch.setattr(jax_settings, "RECOGNITION_WEIGHT_QUANTIZE", True)
    monkeypatch.setattr(settings, "RECOGNITION_WEIGHT_QUANTIZE", True)
    params, _, _ = jax_load_recognition(checkpoint=str(path))
    pred = RecognitionPredictor(str(path), device="cpu")
    for layer, jlayer in zip(pred.model.decoder.layers, params["decoder"]["layers"]):
        for block, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                q, ref = getattr(getattr(layer, block), name), jlayer[block][name]
                assert isinstance(q, QuantLinear)
                assert np.array_equal(q.weight_q.numpy(), np.asarray(ref["kernel_q"]).T)
                assert np.array_equal(q.scale.numpy(), np.asarray(ref["scale"]))


def test_qwen_math_tokenizer_ids_equal_jax(tmp_path):
    chip_smoke.write_qwen2_tokenizer(tmp_path)
    ours, ref = QwenMathTokenizer(str(tmp_path)), JaxQwenMathTokenizer(str(tmp_path))
    assert len(ours) == len(ref) == 256
    for text in ["the cat in the hat", "x^2 + y_1 = \\frac{a}{b}", "é ∑ 漢字", ""]:
        assert ours.encode(text) == ref.encode(text)
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text)) == text


def test_download_directory_fetches_a_manifest(tmp_path, monkeypatch):
    """s3://<path> -> {S3_BASE_URL}/<path>: manifest.json, then every file it
    lists, in parallel workers, and the .download_complete marker; a second
    call fetches nothing."""
    remote = tmp_path / "remote" / "layout" / "2025_02_18"
    remote.mkdir(parents=True)
    files = {"config.json": "{}", "model.safetensors": "weights", "extra.txt": "x"}
    for name, body in files.items():
        (remote / name).write_text(body)
    (remote / "manifest.json").write_text(json.dumps({"files": sorted(files)}))
    base = "http://models.invalid"
    fetched = []

    def copy(url, dest, retries=3, backoff=2.0):
        assert url.startswith(base + "/")
        fetched.append(url)
        dest.write_bytes((tmp_path / "remote" / url[len(base) + 1:]).read_bytes())

    monkeypatch.setattr(s3, "_download_file", copy)
    monkeypatch.setattr(settings, "S3_BASE_URL", base)
    monkeypatch.setattr(settings, "MODEL_CACHE_DIR", str(tmp_path / "cache"))
    local = s3.download_directory("s3://layout/2025_02_18")
    assert local == str(tmp_path / "cache" / "layout" / "2025_02_18")
    for name, body in files.items():
        assert (tmp_path / "cache" / "layout" / "2025_02_18" / name).read_text() == body
    assert (tmp_path / "cache" / "layout" / "2025_02_18" / ".download_complete").exists()
    assert len(fetched) == 1 + len(files)
    assert s3.download_directory("s3://layout/2025_02_18") == local and len(fetched) == 1 + len(files)
    assert s3.resolve_checkpoint("s3://layout/2025_02_18") == local  # in the cache: no fetch
    assert len(fetched) == 1 + len(files)


def test_construction_under_the_test_settings_never_downloads(monkeypatch):
    """With the *_MODEL_CHECKPOINT settings pinned to a path that does not
    exist, as in every port test, building the predictors never tries a
    download; under ALLOW_RANDOM_WEIGHTS=false the JAX message is raised."""
    def no_network(*args, **kwargs):
        raise AssertionError("a predictor tried to download a checkpoint")

    monkeypatch.setattr(s3, "_download_file", no_network)
    for kind, (cls, *_) in KINDS.items():
        assert cls(None, True, device="cpu").model is not None
    monkeypatch.setattr(settings, "ALLOW_RANDOM_WEIGHTS", False)
    with pytest.raises(FileNotFoundError, match="not found locally and not downloadable"):
        LayoutPredictor(None, True, device="cpu")


def test_stages_nest_count_and_report_as_jax():
    jax_profiling.report()
    profiling.report()
    for mod in (jax_profiling, profiling):
        with mod.stage("outer"):
            for _ in range(3):
                with mod.stage("inner"):
                    pass
        with mod.stage("outer"):
            pass
    ref, got = jax_profiling.report(), profiling.report()
    assert {k: v["calls"] for k, v in got.items()} == {k: v["calls"] for k, v in ref.items()} == \
        {"outer": 2, "inner": 3}
    assert set(got["outer"]) == {"total_s", "calls", "mean_s"}
    assert got["outer"]["total_s"] >= got["inner"]["total_s"] >= 0
    assert profiling.report() == {}  # report() cleared it
    profiling.report(reset=False)


# the port's spans and counters of a sequential whole-page OCR call beyond
# the JAX package's stages (common/profiling.py; README, "Stage timers")
PORT_ONLY_NAMES = {
    "recognition.call", "recognition.loop", "recognition.add_prompts", "recognition.build_wait",
    "recognition.wave_select", "recognition.seed_prefill", "recognition.process_decode",
    "recognition.assemble", "recognition.detokenize",
    "recognition.wave_patches", "recognition.wave_patch_cap", "recognition.decode_row_steps",
    "recognition.decode_tokens_kept", "recognition.assemble_chars", "recognition.assemble_runs",
}


def test_whole_page_ocr_reports_the_jax_stage_names(checkpoints, native_postprocess):
    """A whole-page OCR on the CPU times the stages the JAX package times
    (its 17 sites: detection's prepare, forward, device_get, stitch and
    postprocess_wait; recognition's detect, slice, prefill_build, prefill,
    decode and the two drains), and beside them the port's own spans and
    counters of the scheduler and assembly."""
    _, _, jdet, det = checkpoints["detection"]
    _, _, jrec, rec = checkpoints["recognition"]
    jax_evit.install_blob_detector(jdet)
    efficientvit.install_blob_detector(det)
    pages = [text_page(3)]
    jax_profiling.report()
    jrec([p.copy() for p in pages], det_predictor=jdet)
    ref = jax_profiling.report()
    profiling.report()
    rec([p.copy() for p in pages], det_predictor=det)
    got = profiling.report()
    assert set(ref) <= set(got)
    assert set(got) - set(ref) == PORT_ONLY_NAMES
    assert {"detection.prepare", "detection.forward", "detection.device_get", "detection.stitch",
            "detection.postprocess_wait", "recognition.detect", "recognition.slice",
            "recognition.prefill_build", "recognition.prefill", "recognition.drain_prefill"} <= set(got)



def test_the_outermost_stage_writes_a_trace(tmp_path, monkeypatch):
    """With SURYA_PROFILE_DIR set, the outermost stage writes one Chrome
    trace that holds the stages inside it; a stage entered meanwhile in
    another thread (as the recognition builder's is) is timed and starts no
    second trace."""
    import threading

    def builder():
        with profiling.stage("builder"):
            torch.ones(8).sum()

    monkeypatch.setenv("SURYA_PROFILE_DIR", str(tmp_path))
    profiling.report()
    with profiling.stage("outer"):
        with profiling.stage("inner"):
            torch.ones(8).sum()
        thread = threading.Thread(target=builder)
        thread.start()
        thread.join()
    [trace] = list(tmp_path.glob("outer_*.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"outer", "inner"} <= names
    assert {k: v["calls"] for k, v in profiling.report().items()} == {"outer": 1, "inner": 1, "builder": 1}
