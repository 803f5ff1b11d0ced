"""The port's web GUI server (surya_tpu_torch/scripts/web_app.py) on the CPU:

- the nine tests of tests/test_web_app.py against the port's server, whose
  tiny predictors are built lazily inside the requests (TORCH_DEVICE=cpu);
- the port's ``run_action`` against the JAX package's on tiny predictors on
  shared weights (built as tests/test_torch_cli.py builds them: the
  detectors with ``install_blob_detector``, the table recognizers with
  ``install_synthetic_tables``): detect, ocr with and without detection,
  layout, and table over the whole image give the same keys, texts equal,
  pixels within 1 px, scores within 1e-3 and images of the same size;
- a request served on a thread other than the one that built the
  predictors, on models whose parameters require grad, records no autograd
  graph and returns no tensor.

The OCR render's font download goes to a refused loopback port (no font is
fetched; both packages fall back to PIL's font), and every checkpoint
setting names a path that does not exist (no download)."""

import base64
import http.client
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import surya_tpu.scripts.web_app as jax_web_app
from surya_tpu.detection import DetectionPredictor as JaxDetectionPredictor
from surya_tpu.layout import LayoutPredictor as JaxLayoutPredictor
from surya_tpu.models import efficientvit as jax_evit
from surya_tpu.recognition import RecognitionPredictor as JaxRecognitionPredictor
from surya_tpu.settings import settings as jax_settings
from surya_tpu.table_rec import TableRecPredictor as JaxTableRecPredictor
from surya_tpu.table_rec import install_synthetic_tables as jax_install_synthetic_tables
from surya_tpu_torch.detection import DetectionPredictor
from surya_tpu_torch.layout import LayoutPredictor
from surya_tpu_torch.models import efficientvit
from surya_tpu_torch.recognition import RecognitionPredictor
from surya_tpu_torch.scripts import web_app
from surya_tpu_torch.settings import settings as port_settings
from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

torch.set_num_threads(1)

REFUSED = "http://127.0.0.1:9"  # nothing listens there: the font fetch fails at once


@pytest.fixture(scope="module", autouse=True)
def offline_settings(tmp_path_factory):
    """Port predictors built with checkpoint=None resolve no s3:// default,
    and build on the CPU (TORCH_DEVICE); the render font of both packages
    is looked up in an empty directory and fetched from a refused port."""
    fonts = tmp_path_factory.mktemp("fonts")
    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in vars(port_settings) if n.endswith("_MODEL_CHECKPOINT")]:
            mp.setattr(port_settings, name, os.devnull)
        mp.setattr(port_settings, "TORCH_DEVICE", "cpu")
        for s in (port_settings, jax_settings):
            mp.setattr(s, "FONT_DIR", str(fonts))
            mp.setattr(s, "RECOGNITION_FONT_DL_BASE", REFUSED)
        yield


# -- the JAX server's nine tests, against the port's server ---------------------

@pytest.fixture(scope="module")
def server():
    srv = web_app.make_server(port=0, tiny=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _post(server, action, req):
    data = json.dumps(req).encode()
    r = urllib.request.Request(
        _url(server, f"/api/{action}"), data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _image_req(**extra):
    img = Image.new("RGB", (400, 300), "white")
    ImageDraw.Draw(img).text((20, 20), "hello web", fill="black", font_size=28)
    return {"file_b64": _png_b64(img), "filename": "page.png", **extra}


def test_index_and_health(server):
    with urllib.request.urlopen(_url(server, "/")) as resp:
        assert resp.status == 200
        assert b"surya-tpu" in resp.read()
    with urllib.request.urlopen(_url(server, "/healthz")) as resp:
        assert json.loads(resp.read()) == {"ok": True}


def test_detect_action(server):
    status, out = _post(server, "detect", _image_req())
    assert status == 200
    assert out["image_b64"]
    assert "bboxes" in out["result"]
    img = Image.open(io.BytesIO(base64.b64decode(out["image_b64"])))
    assert img.size == (400, 300)
    assert server.predictors["detection"].device == torch.device("cpu")


def test_layout_action(server):
    status, out = _post(server, "layout", _image_req())
    assert status == 200
    assert "bboxes" in out["result"]
    for box in out["result"]["bboxes"]:
        assert {"label", "position", "top_k"} <= set(box)


def test_ocr_action_skip_detection(server):
    status, out = _post(server, "ocr", _image_req(skip_text_detection=True))
    assert status == 200
    assert "text_lines" in out["result"]
    assert isinstance(out["text"], str)
    assert out["word_boxes_b64"]


def test_table_action_whole_image(server):
    status, out = _post(server, "table", _image_req(skip_table_detection=True))
    assert status == 200
    assert out["n_tables"] == 1
    assert isinstance(out["result"], list) and "cells" in out["result"][0]


def test_ocr_error_requires_pdf(server):
    status, out = _post(server, "ocr_error", _image_req())
    assert status == 400
    assert "PDF" in out["error"]


def test_unknown_action_404(server):
    status, out = _post(server, "nonsense", _image_req())
    assert status == 404


def test_malformed_request_answers_500(server):
    status, out = _post(server, "detect", {"file_b64": "!!!not-base64!!!"})
    assert status == 500
    assert "error" in out


def test_bad_content_length_rejected(server):
    """Negative or non-numeric Content-Length answers 400 before any body
    read, an oversized declared length 413 without allocating."""
    host, port = server.server_address[:2]
    for value, expect in (("-1", 400), ("nonsense", 400), (str(200 * 1024 * 1024), 413)):
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            conn.putrequest("POST", "/api/detect")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", value)
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == expect, (value, resp.status)
        finally:
            conn.close()


def test_main_binds_loopback_only(capsys):
    with pytest.raises(SystemExit, match="127.0.0.1 only"):
        web_app.main(["--host", "0.0.0.0", "--port", "0"])


# -- run_action against the JAX package's, on shared weights ----------------------

PIXEL_KEYS = {"polygon", "bbox", "image_bbox"}  # within 1 px
SCORE_KEYS = {"confidence", "top_k"}  # within 1e-3
IMAGE_KEYS = {"image_b64", "word_boxes_b64"}  # PNGs of the same size


def _same(got, ref, key=None, path="payload"):
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


def _tree(pred):
    return jax.tree.map(np.asarray, pred.params)


@pytest.fixture(scope="module")
def shared():
    """(JAX predictors, the port's on their weights), under the registry's
    keys; tiny, random init."""
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
    jax_preds = {"detection": jdet, "recognition": jrec, "layout": jlay, "table_rec": jtab}
    port_preds = {
        "detection": det,
        "recognition": RecognitionPredictor(None, True, device="cpu", jax_params=_tree(jrec)),
        "layout": LayoutPredictor(None, True, device="cpu", jax_params=_tree(jlay)),
        "table_rec": tab,
    }
    return jax_preds, port_preds


def _page_req(**extra):
    img = Image.new("RGB", (640, 480), "white")
    d = ImageDraw.Draw(img)
    for i in range(3):
        d.text((20, 30 + i * 60), f"web line {i} sample text", fill="black", font_size=22 + 4 * i)
    return {"file_b64": _png_b64(img), "filename": "page.png", **extra}


@pytest.mark.parametrize("action, extra", [
    ("detect", {}),
    ("ocr", {}),
    ("ocr", {"skip_text_detection": True}),
    ("ocr", {"ocr_with_boxes": False, "recognize_math": False}),
    ("layout", {}),
    ("table", {"skip_table_detection": True}),
])
def test_run_action_matches_jax(action, extra, shared):
    jax_preds, port_preds = shared
    req = _page_req(**extra)
    ref = json.loads(json.dumps(jax_web_app.run_action(jax_preds, action, dict(req))))
    got = json.loads(json.dumps(web_app.run_action(port_preds, action, dict(req))))
    for key in IMAGE_KEYS & set(ref):
        sizes = [Image.open(io.BytesIO(base64.b64decode(p[key]))).size for p in (got, ref)]
        assert sizes[0] == sizes[1], (key, sizes)
        got[key] = ref[key]
    _same(got, ref)
    if action == "ocr" and not extra:
        assert len(got["result"]["text_lines"]) == 3 and got["text"].count("\n") == 2
    if action == "table":
        assert got["n_tables"] == 1 and len(got["result"][0]["rows"]) == 2


# -- a request on another thread than the one that built the predictors --------

def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def test_request_thread_builds_no_autograd_graph(shared):
    """Every parameter made to require grad: the forward outputs of every
    module, in requests served on fresh threads (as ThreadingHTTPServer
    serves them), carry no grad_fn, and the payloads hold no tensor."""
    _, port_preds = shared
    models = [p.model for p in port_preds.values()]
    flags = [(q, q.requires_grad) for m in models for q in m.parameters()]
    graphs, calls = [], []

    def hook(module, args, out):
        calls.append(type(module).__name__)
        graphs.extend(type(module).__name__ for t in _tensors(out) if t.grad_fn is not None)

    handles = [mod.register_forward_hook(hook) for m in models for mod in m.modules()]
    payloads = {}
    try:
        for q, _ in flags:
            q.requires_grad_(True)
        for action, extra in [("detect", {}), ("ocr", {}), ("layout", {}), ("table", {"skip_table_detection": True})]:
            t = threading.Thread(target=lambda a=action, e=extra: payloads.__setitem__(
                a, web_app.run_action(port_preds, a, _page_req(**e))))
            t.start()
            t.join(timeout=300)
            assert not t.is_alive() and action in payloads
    finally:
        for h in handles:
            h.remove()
        for q, flag in flags:
            q.requires_grad_(flag)
    assert calls and not graphs, f"{len(graphs)} module outputs with a grad_fn: {sorted(set(graphs))}"
    assert not list(_tensors(payloads))
    json.dumps(payloads)  # plain JSON, as the handler sends it
