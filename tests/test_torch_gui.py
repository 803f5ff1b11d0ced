"""The port's GUI apps and their helpers on the CPU:

- the six tests of tests/test_gui_smoke.py on the port's streamlit apps
  (surya_tpu_torch/scripts/{streamlit_app,texify_app}.py) under the same
  stub ``streamlit`` module, with fake predictors that return the port's
  schema objects;
- ``classify_pdf_text_quality``, ``sample_pdf_text`` (a stub pdftext),
  ``render_text_html`` (seeded boxes and texts, with math and HTML
  escapes), ``render_html_to_image`` without playwright, the language
  tables and ``truncate_repetitions`` (a seeded corpus with repeated
  tails), each equal to the JAX package's;
- ``hf_to_s3`` with a stub boto3 and a stub ``snapshot_download``: the
  same uploaded keys and ``manifest.json`` as the JAX package's;
- ``run_streamlit_app`` without streamlit: the JAX package's SystemExit.

The OCR panel's font download goes to a refused loopback port."""

import io
import json
import sys
import types
from unittest import mock

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image, ImageDraw

import surya_tpu.debug.render_html as jax_render_html
import surya_tpu.recognition.languages as jax_languages
import surya_tpu.scripts.hf_to_s3 as jax_hf_to_s3
import surya_tpu.scripts.run_streamlit_app as jax_run_streamlit_app
import surya_tpu.scripts.streamlit_app as jax_streamlit_app
from surya_tpu.recognition.postprocessing import truncate_repetitions as jax_truncate_repetitions
from surya_tpu_torch.debug import render_html
from surya_tpu_torch.recognition import languages
from surya_tpu_torch.recognition.postprocessing import truncate_repetitions
from surya_tpu_torch.scripts import hf_to_s3, run_streamlit_app, streamlit_app
from surya_tpu_torch.settings import settings as port_settings


@pytest.fixture(scope="module", autouse=True)
def no_font_download(tmp_path_factory):
    """The OCR panel's text render looks its font up in an empty directory
    and fetches it from a refused loopback port (nothing is downloaded; the
    render falls back to PIL's font)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_settings, "FONT_DIR", str(tmp_path_factory.mktemp("fonts")))
        mp.setattr(port_settings, "RECOGNITION_FONT_DL_BASE", "http://127.0.0.1:9")
        yield


# -- the streamlit stub (as tests/test_gui_smoke.py) --------------------------------

class _Ctx:
    """Stands in for any streamlit object: attribute access yields callables,
    context-manager use is a no-op."""

    def __getattr__(self, name):
        return _flexible

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _flexible(*args, **kwargs):
    return _Ctx()


class _Stop(Exception):
    pass


def _make_streamlit(file_uploader_result, buttons=False):
    st = types.ModuleType("streamlit")

    def passthrough_decorator(*a, **k):
        def deco(fn):
            return fn

        return deco

    for name in ("set_page_config", "markdown", "image", "json", "text", "code", "write", "error"):
        setattr(st, name, _flexible)
    st.cache_resource = passthrough_decorator
    st.cache_data = passthrough_decorator
    st.columns = lambda spec: tuple(_Ctx() for _ in spec)
    st.tabs = lambda names: tuple(_Ctx() for _ in names)

    def stop():
        raise _Stop()

    st.stop = stop
    sidebar = types.SimpleNamespace(
        file_uploader=lambda *a, **k: file_uploader_result,
        button=lambda *a, **k: buttons,
        checkbox=lambda *a, value=False, **k: value,
        number_input=lambda *a, value=1, **k: value,
    )
    st.sidebar = sidebar
    st.file_uploader = sidebar.file_uploader
    return st


class _Upload(io.BytesIO):
    """Fake st.file_uploader return: BytesIO + .type like UploadedFile."""

    type = "image/png"


def _page_image():
    img = Image.new("RGB", (640, 480), "white")
    d = ImageDraw.Draw(img)
    d.text((40, 40), "Hello GUI", fill="black")
    d.rectangle((40, 120, 400, 160), outline="black")
    buf = _Upload()
    img.save(buf, format="PNG")
    buf.seek(0)
    return buf


def _fake_predictors(calls=None):
    """Predictors returning the port's pydantic schema objects, so that all
    of the GUI's drawing, model_dump and rescale glue runs on real shapes;
    each call is recorded in `calls`."""
    from surya_tpu_torch.common.polygon import PolygonBox
    from surya_tpu_torch.detection.schema import TextDetectionResult
    from surya_tpu_torch.layout.schema import LayoutBox, LayoutResult
    from surya_tpu_torch.ocr_error.schema import OCRErrorDetectionResult
    from surya_tpu_torch.recognition.schema import OCRResult, TextChar, TextLine, TextWord
    from surya_tpu_torch.table_rec.schema import TableCell, TableResult

    calls = [] if calls is None else calls
    poly = [[10, 10], [200, 10], [200, 40], [10, 40]]

    def detection(images, **k):
        calls.append("detection")
        return [
            TextDetectionResult(bboxes=[PolygonBox(polygon=poly)], vertical_lines=[],
                                image_bbox=[0, 0, im.size[0], im.size[1]])
            for im in images
        ]

    def recognition(images, **k):
        calls.append("recognition")
        char = TextChar(text="H", polygon=poly, confidence=0.9, bbox_valid=True)
        word = TextWord(text="H", polygon=poly, confidence=0.9, bbox_valid=True)
        line = TextLine(text="Hello", polygon=poly, chars=[char], confidence=0.9, words=[word])
        return [OCRResult(text_lines=[line], image_bbox=[0, 0, im.size[0], im.size[1]]) for im in images]

    def layout(images, **k):
        calls.append("layout")
        return [
            LayoutResult(
                bboxes=[
                    LayoutBox(polygon=poly, label="Table", position=0, top_k={"Table": 0.9}),
                    LayoutBox(polygon=poly, label="Text", position=1, top_k={"Text": 0.8}),
                ],
                image_bbox=[0, 0, im.size[0], im.size[1]],
                sliced=False,
            )
            for im in images
        ]

    def table_rec(images, **k):
        calls.append("table_rec")
        cell = TableCell(
            polygon=poly, row_id=0, col_id=0, colspan=1, within_row_id=0,
            cell_id=0, is_header=False, rowspan=1, merge_up=False, merge_down=False,
            text_lines=None,
        )
        return [
            TableResult(cells=[cell], unmerged_cells=[cell], rows=[], cols=[],
                        image_bbox=[0, 0, im.size[0], im.size[1]])
            for im in images
        ]

    def ocr_error(texts, **k):
        calls.append("ocr_error")
        return OCRErrorDetectionResult(texts=texts, labels=["good"] * len(texts))

    return {
        "detection": detection, "recognition": recognition, "layout": layout,
        "table_rec": table_rec, "ocr_error": ocr_error,
    }


def test_streamlit_app_imports_without_streamlit():
    import surya_tpu_torch.scripts.texify_app as tex

    assert callable(streamlit_app.main) and callable(tex.run)


def test_classify_pdf_text_quality():
    classify = streamlit_app.classify_pdf_text_quality
    assert "no text" in classify([])
    assert "good" in classify(["good"] * 9 + ["bad"])
    assert "garbled" in classify(["bad"] * 5 + ["good"] * 5)


def test_streamlit_app_stops_without_upload():
    st = _make_streamlit(file_uploader_result=None)
    with mock.patch.dict(sys.modules, {"streamlit": st}):
        with mock.patch("surya_tpu_torch.models_registry.load_predictors", _fake_predictors):
            with pytest.raises(_Stop):
                streamlit_app.main()


def test_streamlit_app_full_wiring_with_image():
    """All five action paths run against fake predictors: detection draw,
    OCR text render + word boxes, layout draw, table crop + cell adjust (the
    bad-text panel answers that it needs a PDF)."""
    calls = []
    st = _make_streamlit(file_uploader_result=_page_image(), buttons=True)
    with mock.patch.dict(sys.modules, {"streamlit": st}):
        with mock.patch("surya_tpu_torch.models_registry.load_predictors", lambda: _fake_predictors(calls)):
            streamlit_app.main()  # must run to completion without error
    assert calls == ["detection", "layout", "recognition", "layout", "table_rec"]


def test_texify_app_wiring():
    calls = []
    st = _make_streamlit(file_uploader_result=_page_image())
    fake_rec = _fake_predictors(calls)["recognition"]
    with mock.patch.dict(sys.modules, {"streamlit": st}):
        with mock.patch("surya_tpu_torch.recognition.RecognitionPredictor", lambda *a, **k: fake_rec):
            from surya_tpu_torch.scripts import texify_app

            texify_app.run()
    assert calls == ["recognition"]


def test_pdf_input_path():
    """PDF load via pypdfium2 (the import gate where the renderer isn't
    installed; tests/_stubs ships an import-only stub that counts as absent)."""
    from surya_tpu_torch.input import load as input_load

    try:
        import pypdfium2  # noqa: F401

        real = "_stubs" not in (getattr(pypdfium2, "__file__", "") or "")
    except ImportError:
        real = False
    if not real:
        with pytest.raises(ImportError, match="pypdfium2"):
            input_load.open_pdf("/tmp/nonexistent.pdf")
        return
    pdf = (
        b"%PDF-1.1\n1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n"
        b"2 0 obj<</Type/Pages/Kids[3 0 R]/Count 1>>endobj\n"
        b"3 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 200 200]>>endobj\n"
        b"trailer<</Root 1 0 R>>\n%%EOF\n"
    )
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".pdf", delete=False) as f:
        f.write(pdf)
        path = f.name
    images, names = input_load.load_from_file(path)
    assert len(images) == 1


# -- the helpers, against the JAX package's ------------------------------------------

def test_classify_pdf_text_quality_matches_jax():
    rng = np.random.default_rng(0)
    for n in [0, 1, 4, 5, 10, 37]:
        for bad in sorted({0, n // 5, n // 5 + 1, n // 2, n} & set(range(n + 1))):
            labels = ["bad"] * bad + ["good"] * (n - bad)
            rng.shuffle(labels)
            for ratio in (0.2, 0.5):
                assert streamlit_app.classify_pdf_text_quality(labels, ratio) == \
                    jax_streamlit_app.classify_pdf_text_quality(labels, ratio)


@pytest.mark.parametrize("length", [0, 100, 5000, 20000])
def test_sample_pdf_text_matches_jax(length, monkeypatch):
    """The samples of a stub pdftext's text, and the page range it is asked
    for, equal the JAX package's."""
    rng = np.random.default_rng(length)
    text = "".join(rng.choice(list("abc de\nfg"), size=length))
    asked = []
    extraction = types.ModuleType("pdftext.extraction")

    def plain_text_output(path, page_range):
        asked.append(list(page_range))
        return text

    extraction.plain_text_output = plain_text_output
    monkeypatch.setitem(sys.modules, "pdftext", types.ModuleType("pdftext"))
    monkeypatch.setitem(sys.modules, "pdftext.extraction", extraction)
    for pages in (1, 7, 40):
        got = streamlit_app.sample_pdf_text(b"%PDF-1.4\n", pages)
        ref = jax_streamlit_app.sample_pdf_text(b"%PDF-1.4\n", pages)
        assert got == ref and asked[-1] == asked[-2]
    assert got == [] if length < 10 else len(got) >= 1


def test_sample_pdf_text_without_pdftext(monkeypatch):
    monkeypatch.setitem(sys.modules, "pdftext", None)
    with pytest.raises(ImportError):
        streamlit_app.sample_pdf_text(b"%PDF-1.4\n", 1)


def test_render_text_html_matches_jax():
    rng = np.random.default_rng(0)
    pieces = ["Hello", "a < b & c > d", '"quoted" \'single\'', "<math>x^2 + y_1</math>",
              'sum <math display="block">\\frac{1}{2}</math>', "", "<b>bold</b>", "naïve café", "{braces}"]
    bboxes, texts = [], []
    for _ in range(40):
        x0, y0 = rng.uniform(0, 600, size=2)
        w, h = rng.uniform(1, 300), rng.uniform(1, 60)
        bboxes.append([float(x0), float(y0), float(x0 + w), float(y0 + h)] if rng.random() < 0.5
                      else [int(x0), int(y0), int(x0 + w), int(y0 + h)])
        texts.append(" ".join(rng.choice(pieces, size=rng.integers(1, 4))))
    for size in [(640, 480), (1240, 1754)]:
        got = render_html.render_text_html(bboxes, texts, size)
        assert got == jax_render_html.render_text_html(bboxes, texts, size)
        assert "&lt;" in got and "<math>" in got and f"width: {size[0]}px" in got


def test_render_html_to_image_without_playwright(monkeypatch):
    monkeypatch.setitem(sys.modules, "playwright", None)
    monkeypatch.setitem(sys.modules, "playwright.sync_api", None)
    html = render_html.render_text_html([[0, 0, 10, 10]], ["x"], (20, 20))
    assert render_html.render_html_to_image(html, (20, 20)) is None
    assert jax_render_html.render_html_to_image(html, (20, 20)) is None


def test_language_tables_match_jax():
    assert languages.CODE_TO_LANGUAGE == jax_languages.CODE_TO_LANGUAGE
    assert languages.LANGUAGE_TO_CODE == jax_languages.LANGUAGE_TO_CODE
    assert len(languages.CODE_TO_LANGUAGE) == 94 and languages.LANGUAGE_TO_CODE["Math"] == "_math"


def test_truncate_repetitions_matches_jax():
    rng = np.random.default_rng(0)
    alphabet = list("abcdefgh ijk.,")
    corpus = ["", "short", "x" * 29, "x" * 30, "abc" * 40, "the end " * 20]
    for _ in range(120):
        head = "".join(rng.choice(alphabet, size=rng.integers(0, 40)))
        unit = "".join(rng.choice(alphabet, size=rng.integers(1, 25)))
        tail = unit * int(rng.integers(1, 8)) + unit[: rng.integers(0, len(unit) + 1)]
        corpus.append(head + tail)
    changed = 0
    for text in corpus:
        for min_len in (15, 5):
            got = truncate_repetitions(text, min_len)
            assert got == jax_truncate_repetitions(text, min_len), (text, min_len)
            changed += got != text
    assert truncate_repetitions("abc" * 40) != "abc" * 40 and changed > 20


# -- hf_to_s3 ------------------------------------------------------------------------

def _stub_uploads(monkeypatch, snapshot):
    """A stub boto3 recording each upload (its key and bytes) and a stub
    huggingface_hub whose snapshot_download returns `snapshot`."""
    uploads = {}
    clients = []

    class Client:
        def upload_file(self, path, bucket, key):
            with open(path, "rb") as f:
                uploads[(bucket, key)] = f.read()

    def client(**kwargs):
        clients.append(kwargs)
        return Client()

    boto3 = types.ModuleType("boto3")
    boto3.client = client
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = lambda repo_id: str(snapshot)
    monkeypatch.setitem(sys.modules, "boto3", boto3)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    return uploads, clients


def test_hf_to_s3_uploads_what_jax_uploads(tmp_path, monkeypatch, capsys):
    snapshot = tmp_path / "snapshot"
    snapshot.mkdir()
    (snapshot / "config.json").write_text('{"a": 1}')
    (snapshot / "model.safetensors").write_bytes(bytes(range(256)) * 4)
    (snapshot / "subdir").mkdir()  # only files are copied
    args = ["org/model", "models/rec", "--bucket_name", "b", "--suffix", "v2", "--access_key_id", "k"]
    uploads, clients = _stub_uploads(monkeypatch, snapshot)
    result = CliRunner().invoke(jax_hf_to_s3.main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    ref_uploads, ref_clients = dict(uploads), list(clients)
    uploads.clear()
    clients.clear()
    hf_to_s3.main(args)
    assert uploads == ref_uploads and clients == ref_clients
    keys = sorted(key for _, key in uploads)
    assert [k.rsplit("/", 1)[1] for k in keys] == ["config.json", "manifest.json", "model.safetensors"]
    assert keys[0].startswith("models/rec/") and keys[0].split("/")[2].endswith("_v2")
    manifest = json.loads(uploads[("b", keys[1])])
    assert sorted(manifest["files"]) == ["config.json", "model.safetensors"]
    assert clients[0]["aws_access_key_id"] == "k" and clients[0]["endpoint_url"] == jax_hf_to_s3.S3_API_URL
    assert capsys.readouterr().out.strip().endswith(f"Uploaded files to {keys[0].rsplit('/', 1)[0]}")


def test_hf_to_s3_arguments_match_jax(capsys):
    with pytest.raises(SystemExit) as exit_info:
        hf_to_s3.main(["--help"])
    assert exit_info.value.code == 0
    text = capsys.readouterr().out
    for param in jax_hf_to_s3.main.params:
        for opt in param.opts:
            assert opt in text, opt
    assert "click" not in hf_to_s3.__dict__


# -- run_streamlit_app -------------------------------------------------------------

@pytest.mark.parametrize("cli", ["streamlit_app_cli", "texify_app_cli"])
def test_run_streamlit_app_without_streamlit(cli, monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)  # import streamlit now raises
    with pytest.raises(SystemExit) as got:
        getattr(run_streamlit_app, cli)()
    with pytest.raises(SystemExit) as ref:
        getattr(jax_run_streamlit_app, cli)()
    assert str(got.value) == str(ref.value) and "streamlit" in str(got.value)


@pytest.mark.parametrize("cli, app", [("streamlit_app_cli", "streamlit_app.py"), ("texify_app_cli", "texify_app.py")])
def test_run_streamlit_app_runs_the_port_app(cli, app, monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", types.ModuleType("streamlit"))
    ran = []
    monkeypatch.setattr(run_streamlit_app.subprocess, "run", lambda cmd, check: ran.append(cmd))
    getattr(run_streamlit_app, cli)()
    [cmd] = ran
    assert cmd[1:4] == ["-m", "streamlit", "run"]
    assert cmd[4] == str(__import__("pathlib").Path(run_streamlit_app.__file__).parent / app)
