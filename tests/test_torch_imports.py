"""The port imports and runs with JAX and the JAX package unavailable, as on
the GPU machine: in a subprocess where ``import jax`` and ``import
surya_tpu`` fail, the port's modules import, tiny predictors recognize given
lines and run a whole-page OCR (detection, then recognition with the int8
KV cache) on the CPU, then the streaming path (more pages than
RECOGNITION_DET_PIPELINE_PAGES) and ``stream()`` with detection's device
resize, device stats and C++ CRAFT op, then layout analysis (a page above
1500 px, so the slicer runs) and table recognition (with synthetic tables),
OCR error detection, recognition with int8 decoder weights, recognition on
a 2x2 mesh of the CPU, the LaTeX CLI's ``main()``, the web server
(detect and ocr requests), the GUI apps' modules, and a recognition
predictor loaded from a checkpoint
directory (upstream key names, config.json, Qwen2 tokenizer files, the
converted-weight cache); no module of either is loaded afterwards, nor
click. The checkpoint settings name a path that does not exist, so nothing
is downloaded."""

import os
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["surya_tpu"] = None  # and so does any import of the JAX package

    import torch
    torch.set_num_threads(1)
    from PIL import Image, ImageDraw

    import surya_tpu_torch.ops.decode_attn
    import surya_tpu_torch.ops.flash
    import surya_tpu_torch.models.foundation
    from surya_tpu_torch.detection import DetectionPredictor
    from surya_tpu_torch.models.efficientvit import install_blob_detector
    from surya_tpu_torch.recognition import RecognitionPredictor
    from surya_tpu_torch.settings import settings

    img = Image.new("RGB", (512, 256), "white")
    ImageDraw.Draw(img).text((10, 10), "Hello", fill="black", font_size=40)
    pred = RecognitionPredictor(tiny=True, device="cpu")
    [page] = pred([img], bboxes=[[[0, 0, 300, 60], [0, 100, 200, 140]]])
    assert len(page.text_lines) == 2
    assert pred.last_decoded_tokens > 0

    det = DetectionPredictor(tiny=True, device="cpu")
    install_blob_detector(det)
    settings.RECOGNITION_MODEL_QUANTIZE = True
    [page] = pred([img], det_predictor=det)
    assert len(page.text_lines) == 1 and pred.last_decoded_tokens > 0

    # the streaming det->rec path (a detection worker and a builder thread),
    # stream(), and detection's device paths, here on the CPU
    settings.RECOGNITION_DET_PIPELINE_PAGES = 1
    settings.DETECTOR_DEVICE_RESIZE = settings.DETECTOR_ON_DEVICE_POSTPROCESS = True
    pages = [img, img.copy(), img.copy()]
    results = pred([p.copy() for p in pages], det_predictor=det)
    assert [len(r.text_lines) for r in results] == [1, 1, 1] and det.stats_batches == 3
    streamed = list(pred.stream(iter(pages), det, group_pages=2))
    assert [i for i, _ in streamed] == [0, 1, 2]
    assert [r.text_lines[0].text for _, r in streamed] == [r.text_lines[0].text for r in results]

    from surya_tpu_torch.layout import LayoutPredictor
    from surya_tpu_torch.table_rec import TableRecPredictor, install_synthetic_tables

    [layout] = LayoutPredictor(device="cpu", tiny=True)([Image.new("RGB", (600, 1800), "white")])
    assert layout.sliced and layout.image_bbox == [0, 0, 600, 1800]
    tables = TableRecPredictor(device="cpu", tiny=True)
    install_synthetic_tables(tables, n_rows=2, n_cols=2, n_cells=1)
    [table] = tables([img])
    assert len(table.rows) == 2 and len(table.cols) == 2 and table.cells

    # OCR error detection, int8 decoder weights, and one CLI end to end
    from surya_tpu_torch.nn import QuantLinear
    from surya_tpu_torch.ocr_error import OCRErrorPredictor

    result = OCRErrorPredictor(None, True, device="cpu")(["Hello world.", "H3ll0 w0rld", "ok"])
    assert len(result.labels) == 3 and set(result.labels) <= {"good", "bad"}
    settings.RECOGNITION_WEIGHT_QUANTIZE = True
    qpred = RecognitionPredictor(None, True, device="cpu")
    settings.RECOGNITION_WEIGHT_QUANTIZE = False
    assert isinstance(qpred.model.decoder.layers[0].self_attn.q_proj, QuantLinear)
    [page] = qpred([img], bboxes=[[[0, 0, 300, 60]]])
    assert len(page.text_lines) == 1 and qpred.last_decoded_tokens > 0

    # recognition on a 2x2 mesh of the CPU (int8 KV cache): the unsharded text
    from surya_tpu_torch.parallel.mesh import make_mesh
    meshed = RecognitionPredictor(None, True, mesh=make_mesh(2, 2, ["cpu"] * 4))
    lines = [[[0, 0, 300, 60], [0, 100, 200, 140]]]
    [page_m], [page_s] = meshed([img], bboxes=lines), pred([img], bboxes=lines)
    assert [l.text for l in page_m.text_lines] == [l.text for l in page_s.text_lines]
    assert meshed.last_decoded_tokens > 0 and meshed.mesh.shape == {"data": 2, "model": 2}

    import json, pathlib, tempfile
    import surya_tpu_torch.scripts.ocr_latex as ocr_latex
    ocr_latex.RecognitionPredictor = lambda *args, **kwargs: qpred  # the tiny int8-weight model
    with tempfile.TemporaryDirectory() as tmp:
        folder = pathlib.Path(tmp) / "pages"
        folder.mkdir()
        img.save(folder / "a.png")
        ocr_latex.main([str(folder), "--output_dir", str(pathlib.Path(tmp) / "out")])
        rows = json.loads((pathlib.Path(tmp) / "out" / "pages" / "results.json").read_text())
        assert list(rows) == ["a"] and set(rows["a"][0]) == {"equation", "page"}

    # the web server on the tiny predictors, each request on a handler
    # thread, and the GUI apps' and checkpoint upload's modules
    import base64, io, threading, urllib.request
    import surya_tpu_torch.debug.render_html
    import surya_tpu_torch.recognition.languages
    import surya_tpu_torch.scripts.hf_to_s3
    import surya_tpu_torch.scripts.run_streamlit_app
    import surya_tpu_torch.scripts.streamlit_app
    import surya_tpu_torch.scripts.texify_app
    from surya_tpu_torch.scripts.web_app import make_server
    server = make_server(0)
    server.predictors["detection"], server.predictors["recognition"] = det, pred
    serving = threading.Thread(target=server.serve_forever)
    serving.start()
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    body = json.dumps({"file_b64": base64.b64encode(buf.getvalue()).decode(), "filename": "a.png"}).encode()
    for action in ("detect", "ocr"):
        url = f"http://127.0.0.1:{server.server_address[1]}/api/{action}"
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as resp:
            assert resp.status == 200 and json.loads(resp.read())["result"]
    server.shutdown()
    server.server_close()
    serving.join(timeout=30)
    assert not serving.is_alive()
    assert "click" not in sys.modules and "streamlit" not in sys.modules

    # a recognition predictor from a checkpoint directory, as upstream ships one
    import chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_checkpoint(pathlib.Path(tmp), "recognition", pred.model, pred.config,
                                    torch.Generator().manual_seed(0))
        loaded = RecognitionPredictor(tmp, device="cpu")
        assert (pathlib.Path(tmp) / ".torch_cache_recognition_float32_v1.safetensors").exists()
        assert all(torch.equal(a, b) for a, b in zip(loaded.model.state_dict().values(),
                                                     pred.model.state_dict().values()))
        [page] = loaded([img], bboxes=[[[0, 0, 300, 60]]])
        assert len(page.text_lines) == 1 and loaded.last_decoded_tokens > 0

    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert jax_like == ["jax"], jax_like  # only the blocking sentinel
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "surya_tpu")
    assert jax_package == ["surya_tpu"], jax_package  # only the blocking sentinel
    print("OK")
    """
)


def test_port_runs_without_jax():
    env = dict(os.environ, ALLOW_RANDOM_WEIGHTS="true", RECOGNITION_MAX_TOKENS="8", DISABLE_TQDM="true")
    env["RECOGNITION_FONT_DL_BASE"] = "http://127.0.0.1:9"  # the OCR render's font fetch fails at once
    for name in ("DETECTOR", "RECOGNITION", "LAYOUT", "TABLE_REC", "OCR_ERROR"):
        env[f"{name}_MODEL_CHECKPOINT"] = os.devnull  # no default s3:// checkpoint is fetched
    env.pop("TORCH_DEVICE", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


VALIDATE_SCRIPT = textwrap.dedent(
    """
    import importlib, json, pathlib, pkgutil, sys, tempfile
    BLOCKED = ("jax", "surya_tpu", "benchmark", "click", "rapidfuzz", "tabulate", "datasets")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of it now raises ImportError

    import torch
    torch.set_num_threads(1)
    import surya_tpu_torch
    # every module of the port imports with all of them blocked
    for info in pkgutil.walk_packages(surya_tpu_torch.__path__, "surya_tpu_torch."):
        importlib.import_module(info.name)

    import surya_tpu_torch.benchmark.detection as detection
    import surya_tpu_torch.benchmark.recognition as recognition
    import surya_tpu_torch.benchmark.table_recognition as table_recognition
    from surya_tpu_torch.benchmark.utils.data import load_hf_dataset
    from surya_tpu_torch.detection import DetectionPredictor
    from surya_tpu_torch.recognition import RecognitionPredictor
    from surya_tpu_torch.scripts.validate_checkpoints import main
    from surya_tpu_torch.table_rec import TableRecPredictor

    detection.DetectionPredictor = lambda *a, **k: DetectionPredictor(None, True)
    recognition.RecognitionPredictor = lambda *a, **k: RecognitionPredictor(None, True)
    table_recognition.TableRecPredictor = lambda *a, **k: TableRecPredictor(None, True)
    with tempfile.TemporaryDirectory() as tmp:
        main(["--smoke", "--max_rows", "1", "--results_dir", tmp])
        summary = json.loads((pathlib.Path(tmp) / "validation_summary.json").read_text())
    assert [g for g, s in summary.items() if s["status"] in ("pass", "below threshold")] == [
        "detection", "recognition", "table_recognition"], summary
    try:  # the datasets package is imported at the call, and only there
        load_hf_dataset("vikp/rec_bench", 1)
        raise AssertionError("load_hf_dataset ran without the datasets package")
    except ImportError:
        pass
    for name in BLOCKED:
        loaded = sorted(m for m in sys.modules if m.split(".")[0] == name)
        assert loaded == [name], loaded  # only the blocking sentinel
    print("OK")
    """
)


def test_validation_command_runs_without_jax_or_the_benchmark_dependencies():
    """The port's validate_checkpoints --smoke at tiny width in a subprocess
    where jax, the JAX package, the repo's benchmark/, click, rapidfuzz,
    tabulate and datasets cannot be imported; every module of the port
    imports there, and none of those is loaded afterwards."""
    env = dict(os.environ, ALLOW_RANDOM_WEIGHTS="true", TORCH_DEVICE="cpu", RECOGNITION_MAX_TOKENS="8",
               DISABLE_TQDM="true")
    for name in ("DETECTOR", "RECOGNITION", "LAYOUT", "TABLE_REC", "OCR_ERROR"):
        env[f"{name}_MODEL_CHECKPOINT"] = os.devnull  # no default s3:// checkpoint is fetched
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", VALIDATE_SCRIPT], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("smoke run complete\nOK")
