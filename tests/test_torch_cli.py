"""The port's five CLIs against the JAX package's, on the CPU in float32, on
a folder of two page images, with tiny predictors on shared weights
monkeypatched in (the port's built from the JAX predictors' pytrees; the
detectors with ``install_blob_detector``, the table recognizers with
``install_synthetic_tables`` under ``--skip_table_detection``): each
``results.json`` has the JAX CLI's keys, page numbers and text, its
polygons and boxes within 1 px and its confidences within 1e-3. Also the
shared plumbing (``parse_range_str``, folder loading, ``write_results_json``),
the debug images of ``--images`` (and ``-d``), each CLI's ``--help``
listing the JAX CLI's options, and a PDF without pypdfium2 raising its
ImportError."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image, ImageDraw

import surya_tpu.scripts.detect_layout as jax_detect_layout
import surya_tpu.scripts.detect_text as jax_detect_text
import surya_tpu.scripts.ocr_latex as jax_ocr_latex
import surya_tpu.scripts.ocr_text as jax_ocr_text
import surya_tpu.scripts.table_recognition as jax_table_recognition
import surya_tpu_torch.scripts.detect_layout as detect_layout
import surya_tpu_torch.scripts.detect_text as detect_text
import surya_tpu_torch.scripts.ocr_latex as ocr_latex
import surya_tpu_torch.scripts.ocr_text as ocr_text
import surya_tpu_torch.scripts.table_recognition as table_recognition
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.layout import LayoutPredictor as JaxLayoutPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.table_rec import TableRecPredictor as JaxTableRecPredictor
from surya_tpu.table_rec import install_synthetic_tables as jax_install_synthetic_tables
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.input.load import load_from_file, load_from_folder
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.scripts.config import CLILoader, parse_range_str, write_results_json
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_default_checkpoints():
    """Port predictors built with checkpoint=None resolve no s3:// default
    (no download): every *_MODEL_CHECKPOINT setting names a path that does
    not exist."""
    from surya_tpu_torch.settings import settings as port_settings

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        yield


PIXEL_KEYS = {"polygon", "bbox", "image_bbox"}  # within 1 px
SCORE_KEYS = {"confidence", "top_k"}  # within 1e-3
# module name -> (the JAX CLI's module, its click command, the predictors it builds, extra arguments)
CLIS = {
    "detect_text": (detect_text, jax_detect_text, "detect_text_cli", ("DetectionPredictor",), []),
    "ocr_text": (ocr_text, jax_ocr_text, "ocr_text_cli", ("DetectionPredictor", "RecognitionPredictor"), []),
    "ocr_latex": (ocr_latex, jax_ocr_latex, "ocr_latex_cli", ("RecognitionPredictor",), []),
    "detect_layout": (detect_layout, jax_detect_layout, "detect_layout_cli", ("LayoutPredictor",), []),
    "table_recognition": (table_recognition, jax_table_recognition, "table_recognition_cli",
                          ("LayoutPredictor", "TableRecPredictor"), ["--skip_table_detection"]),
}


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cli") / "pages"
    folder.mkdir()
    for p in range(2):
        img = Image.new("RGB", (640, 480), "white")
        d = ImageDraw.Draw(img)
        for i in range(3 + p):
            d.text((20, 30 + i * 60), f"page {p} line {i} sample text", fill="black", font_size=22 + 4 * i)
        img.save(folder / f"page_{p}.png")
    return folder


def _tree(pred):
    return jax.tree.map(np.asarray, pred.params)


@pytest.fixture(scope="module")
def predictors():
    """name -> (JAX predictor, the port's on its weights), tiny, random init
    (a local checkpoint path that does not exist: no download)."""
    jdet = JaxDetectionPredictor(checkpoint=os.devnull, tiny=True)
    jax_evit.install_blob_detector(jdet)
    det = DetectionPredictor(None, True, device="cpu", jax_params=_tree(jdet))
    efficientvit.install_blob_detector(det)
    jrec = JaxRecognitionPredictor(checkpoint=os.devnull, tiny=True)
    jlay = JaxLayoutPredictor(checkpoint=os.devnull, tiny=True)
    jtab = JaxTableRecPredictor(checkpoint=os.devnull, tiny=True)
    jax_install_synthetic_tables(jtab, n_rows=2, n_cols=2, n_cells=1)
    tab = TableRecPredictor(None, True, device="cpu", jax_params=_tree(jtab))
    install_synthetic_tables(tab, n_rows=2, n_cols=2, n_cells=1)
    return {
        "DetectionPredictor": (jdet, det),
        "RecognitionPredictor": (jrec, RecognitionPredictor(None, True, device="cpu", jax_params=_tree(jrec))),
        "LayoutPredictor": (jlay, LayoutPredictor(None, True, device="cpu", jax_params=_tree(jlay))),
        "TableRecPredictor": (jtab, tab),
    }


def _same(got, ref, key=None, path="results"):
    """got equals ref key for key; pixel values within 1, scores within 1e-3."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), f"{path}: keys {sorted(got)} vs {sorted(ref)}"
        for k in ref:
            _same(got[k], ref[k], "top_k" if key == "top_k" else k, f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), f"{path}: {got} vs {ref}"
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, key, f"{path}/{i}")
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool) and key in PIXEL_KEYS | SCORE_KEYS:
        tol = 1.0 if key in PIXEL_KEYS else 1e-3
        assert isinstance(got, (int, float)) and abs(got - ref) <= tol, f"{path}: {got} vs {ref}"
    else:
        assert got == ref, f"{path}: {got!r} vs {ref!r}"


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_results_match_jax(name, image_folder, predictors, tmp_path, monkeypatch):
    module, jax_module, command, built, extra = CLIS[name]
    for cls in built:
        jax_pred, pred = predictors[cls]
        monkeypatch.setattr(jax_module, cls, lambda *a, _p=jax_pred, **k: _p)
        monkeypatch.setattr(module, cls, lambda *a, _p=pred, **k: _p)
    ref_dir, out_dir = tmp_path / "jax", tmp_path / "torch"
    result = CliRunner().invoke(getattr(jax_module, command), [str(image_folder), "--output_dir", str(ref_dir),
                                                               *extra], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    module.main([str(image_folder), "--output_dir", str(out_dir), *extra])
    ref = json.loads((ref_dir / "pages" / "results.json").read_text())
    got = json.loads((out_dir / "pages" / "results.json").read_text())
    assert list(got) == ["page_0", "page_1"] and [[row["page"] for row in got[k]] for k in got] == [[1], [1]]
    _same(got, ref)
    if name == "ocr_text":
        assert [len(got[k][0]["text_lines"]) for k in got] == [3, 4]
    if name == "ocr_latex":
        assert set(got["page_0"][0]) == {"equation", "page"}
    if name == "table_recognition":
        assert got["page_0"][0]["table_idx"] == 0 and len(got["page_0"][0]["rows"]) == 2


@pytest.mark.parametrize("name, extra, artifacts", [
    ("detect_text", ["--images", "-d"], {"page_0_0_bbox.png", "page_0_0_heat.png", "page_1_1_bbox.png",
                                         "page_1_1_heat.png"}),
    ("detect_layout", ["--images"], {"page_0_0_layout.png", "page_1_1_layout.png"}),
    ("table_recognition", ["--skip_table_detection", "--images"],
     {f"page_{p}_page1_table0_{kind}.png" for p in (0, 1) for kind in ("rc", "cells")}),
])
def test_cli_images_write_the_debug_artifacts(name, extra, artifacts, image_folder, predictors, tmp_path,
                                              monkeypatch):
    module, _, _, built, _ = CLIS[name]
    for cls in built:
        monkeypatch.setattr(module, cls, lambda *a, _p=predictors[cls][1], **k: _p)
    module.main([str(image_folder), "--output_dir", str(tmp_path), *extra])
    assert {p.name for p in (tmp_path / "pages").iterdir() if p.suffix == ".png"} == artifacts


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_help_lists_the_jax_options(name, capsys):
    module, jax_module, command, _, _ = CLIS[name]
    with pytest.raises(SystemExit) as exit_info:
        module.main(["--help"])
    assert exit_info.value.code == 0
    text = capsys.readouterr().out
    options = [opt for param in getattr(jax_module, command).params for opt in param.opts]
    assert "input_path" in options and "--output_dir" in options and "-d" in options
    for opt in options:
        assert opt in text, f"{name} --help lacks {opt}"


def test_cli_options_reach_the_loader(image_folder, tmp_path):
    loader = CLILoader(str(image_folder), {"output_dir": str(tmp_path), "page_range": "0", "images": True,
                                           "debug": False}, highres=True)
    assert loader.page_range == [0] and loader.save_images and not loader.debug
    assert loader.names == ["page_0", "page_1"] and len(loader.highres_images) == 2
    assert loader.result_path == str((tmp_path / "pages").absolute()) and os.path.isdir(loader.result_path)


def test_parse_range_str():
    assert parse_range_str("0,5-7,20") == [0, 5, 6, 7, 20]
    assert parse_range_str("3,3,1") == [1, 3]
    assert CLILoader.parse_range_str("2-3") == [2, 3]


def test_folder_loading(image_folder):
    images, names = load_from_folder(str(image_folder))
    assert len(images) == 2 and names == ["page_0", "page_1"]
    assert all(im.mode == "RGB" and im.size == (640, 480) for im in images)


def test_write_results_json(tmp_path):
    class Row:
        def __init__(self, v):
            self.v = v

        def model_dump(self, exclude=None):
            return {"v": self.v, "heatmap": 1} if not exclude else {"v": self.v}

    path = write_results_json(str(tmp_path), ["a", "a", "b"], [Row(1), Row(2), Row(3)], exclude=["heatmap"])
    assert json.loads(open(path).read()) == {"a": [{"v": 1, "page": 1}, {"v": 2, "page": 2}],
                                             "b": [{"v": 3, "page": 1}]}


def test_pdf_without_pypdfium2_raises(tmp_path, monkeypatch):
    pdf = tmp_path / "doc.pdf"
    pdf.write_bytes(b"%PDF-1.4\n%%EOF\n")
    monkeypatch.setitem(__import__("sys").modules, "pypdfium2", None)  # import pypdfium2 now raises
    with pytest.raises(ImportError, match="PDF input requires pypdfium2"):
        load_from_file(str(pdf))
    with pytest.raises(ImportError, match="PDF input requires pypdfium2"):
        detect_text.main([str(pdf), "--output_dir", str(tmp_path / "out")])
