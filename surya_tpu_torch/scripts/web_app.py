"""Zero-dependency web GUI of the port (counterpart of
surya_tpu/scripts/web_app.py): the same five-predictor wiring as the
streamlit app (reference surya/scripts/streamlit_app.py), served by the
stdlib `http.server` so it runs in ANY environment — including ones where
streamlit cannot be installed. Run with:

    surya_torch_web [--port 8866] [--tiny]
    python -m surya_tpu_torch.scripts.web_app [--port 8866] [--tiny]

The predictors run on the card; TORCH_DEVICE=cpu runs them on the CPU.

Feature parity with the reference GUI actions: text detection, OCR (with
word boxes / math / skip-detection modes), layout analysis, table recognition
(layout-driven table crops or whole-image), and bad-PDF-text detection. PDF
upload + page selection works when pypdfium2 is available (the bad-text
detector also needs pdftext); plain images work everywhere. Results render
as an annotated image plus the raw schema JSON — the same two artifacts the
streamlit panels show. The OCR render resolves its font through
debug/fonts.py, which tries a download whenever none is cached.

Predictors live in a process-wide registry behind a lock: each is built on
first use, inside the request that needs it (the kernels' and the C++ CRAFT
op's first load happen there too), and then serves every request. Requests
arrive on a fresh thread each (ThreadingHTTPServer) and run one at a time
under the lock. Nothing of the building thread is needed: every predictor
call enters torch.inference_mode() and makes its predictor's CUDA stream the
current one itself, and both are per thread. The HTTP layer is a thin JSON
API (`POST /api/<action>`) and the page is a static HTML shell — so the same
API also serves programmatic clients, not just the browser form.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from surya_tpu_torch.logging import get_logger

logger = get_logger()

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>surya-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;display:flex;min-height:100vh}
 #side{width:300px;padding:16px;background:#f4f4f6;border-right:1px solid #ddd}
 #main{flex:1;padding:16px}
 button{display:block;width:100%;margin:6px 0;padding:8px;cursor:pointer}
 label{display:block;margin:4px 0;font-size:13px}
 img{max-width:100%;border:1px solid #ccc;margin-top:8px}
 pre{background:#f8f8f8;border:1px solid #ddd;padding:8px;overflow:auto;max-height:320px;font-size:11px}
 #status{color:#666;font-size:13px;min-height:1.2em}
 h1{font-size:18px}
</style></head><body>
<div id="side">
 <h1>surya-tpu</h1>
 <input type="file" id="file" accept=".png,.jpg,.jpeg,.gif,.webp,.pdf">
 <label id="pagerow" style="display:none">PDF page: <input type="number" id="page" value="1" min="1" style="width:60px"></label>
 <button data-action="detect">Run Text Detection</button>
 <button data-action="ocr">Run OCR</button>
 <button data-action="layout">Run Layout Analysis</button>
 <button data-action="table">Run Table Rec</button>
 <button data-action="ocr_error">Run bad PDF text detection</button>
 <label><input type="checkbox" id="skip_table_detection"> Skip table detection</label>
 <label><input type="checkbox" id="skip_text_detection"> Skip text detection</label>
 <label><input type="checkbox" id="recognize_math" checked> Recognize math in OCR</label>
 <label><input type="checkbox" id="ocr_with_boxes" checked> OCR with boxes</label>
 <div id="status"></div>
</div>
<div id="main">
 <div id="verdict"></div>
 <img id="result" style="display:none">
 <pre id="json" style="display:none"></pre>
 <img id="preview" style="display:none">
</div>
<script>
const file = document.getElementById('file');
file.addEventListener('change', () => {
  const f = file.files[0];
  document.getElementById('pagerow').style.display =
    f && f.name.toLowerCase().endsWith('.pdf') ? 'block' : 'none';
  if (f && !f.name.toLowerCase().endsWith('.pdf')) {
    const r = new FileReader();
    r.onload = () => { const p = document.getElementById('preview'); p.src = r.result; p.style.display='block'; };
    r.readAsDataURL(f);
  }
});
document.querySelectorAll('button').forEach(btn => btn.addEventListener('click', async () => {
  const f = file.files[0];
  const status = document.getElementById('status');
  if (!f) { status.textContent = 'choose a file first'; return; }
  status.textContent = 'running ' + btn.dataset.action + '…';
  // FileReader gives base64 natively (data:...;base64,XXXX) — a JS
  // reduce-concat loop is O(n^2) and freezes the tab on multi-MB PDFs
  const b64 = await new Promise((res, rej) => {
    const r = new FileReader();
    r.onload = () => res(r.result.slice(r.result.indexOf(',') + 1));
    r.onerror = rej;
    r.readAsDataURL(f);
  });
  const body = {
    file_b64: b64, filename: f.name,
    page: parseInt(document.getElementById('page').value || '1'),
  };
  for (const id of ['skip_table_detection','skip_text_detection','recognize_math','ocr_with_boxes'])
    body[id] = document.getElementById(id).checked;
  const resp = await fetch('/api/' + btn.dataset.action, {
    method: 'POST', headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
  const out = await resp.json();
  status.textContent = resp.ok ? 'done (' + btn.dataset.action + ')' : 'error';
  document.getElementById('verdict').textContent = out.verdict || '';
  const img = document.getElementById('result');
  if (out.image_b64) { img.src = 'data:image/png;base64,' + out.image_b64; img.style.display = 'block'; }
  else img.style.display = 'none';
  const pre = document.getElementById('json');
  pre.textContent = JSON.stringify(out.result !== undefined ? out.result : out, null, 1);
  pre.style.display = 'block';
}));
</script></body></html>"""


class PredictorRegistry:
    """Process-wide lazy predictor store. Each predictor loads on first use
    through its constructor's (checkpoint=None, tiny) on TORCH_DEVICE (the
    card by default); a lock serializes loads and pipeline runs."""

    def __init__(self, tiny: bool = False):
        self._tiny = tiny
        self._preds = {}
        self.lock = threading.Lock()

    def __getitem__(self, name: str):
        if name not in self._preds:
            from surya_tpu_torch.detection import DetectionPredictor
            from surya_tpu_torch.layout import LayoutPredictor
            from surya_tpu_torch.ocr_error import OCRErrorPredictor
            from surya_tpu_torch.recognition import RecognitionPredictor
            from surya_tpu_torch.table_rec import TableRecPredictor

            cls = {
                "detection": DetectionPredictor,
                "recognition": RecognitionPredictor,
                "layout": LayoutPredictor,
                "table_rec": TableRecPredictor,
                "ocr_error": OCRErrorPredictor,
            }[name]
            logger.info("web_app: loading %s predictor", name)
            self._preds[name] = cls(None, self._tiny)
        return self._preds[name]

    def __setitem__(self, name: str, predictor):
        """Seed a predictor that was built elsewhere (tests, the smoke run)."""
        self._preds[name] = predictor


def _img_b64(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# per-action image needs: PDF rendering at IMAGE_DPI_HIGHRES is ~4x the pixels
# of the lowres render, so actions that never touch the highres image
# (detect/layout) skip it; ocr_error only needs the raw bytes + page count
_ACTION_NEEDS = {
    "detect": ("low",),
    "layout": ("low",),
    "ocr": ("low", "high"),
    "table": ("low", "high"),
    "ocr_error": (),
}


def _load_input(req: dict, needs=("low", "high")):
    """Decode the uploaded file into (lowres PIL image, highres PIL image,
    pdf page count or None, raw bytes). The PDF document is parsed ONCE per
    request and only the resolutions in `needs` are rendered."""
    from PIL import Image

    from surya_tpu_torch.settings import settings

    raw = base64.b64decode(req["file_b64"])
    name = (req.get("filename") or "").lower()
    if name.endswith(".pdf"):
        from surya_tpu_torch.input.load import get_page_images, open_pdf

        doc = open_pdf(raw)
        try:
            n_pages = len(doc)
            page = max(1, min(int(req.get("page", 1)), n_pages))
            low = high = None
            if "low" in needs:
                low = get_page_images(doc, [page - 1], dpi=settings.IMAGE_DPI)[0]
            if "high" in needs:
                high = get_page_images(doc, [page - 1], dpi=settings.IMAGE_DPI_HIGHRES)[0]
        finally:
            doc.close()
        return low, high, n_pages, raw
    img = Image.open(io.BytesIO(raw)).convert("RGB")
    return img, img, None, raw


def run_action(preds: PredictorRegistry, action: str, req: dict) -> dict:
    """Execute one GUI action and return the JSON payload. Mirrors the
    streamlit panels (reference surya/scripts/streamlit_app.py:119-232);
    exposed as a function so tests and API clients skip HTTP."""
    from PIL import ImageDraw

    from surya_tpu_torch.common.util import expand_bbox, rescale_bbox
    from surya_tpu_torch.debug.draw import (
        draw_bboxes_on_image,
        draw_polys_on_image,
        draw_text_on_image,
    )
    from surya_tpu_torch.recognition.tokenizer import TaskNames
    from surya_tpu_torch.scripts.streamlit_app import classify_pdf_text_quality, sample_pdf_text

    image, highres, n_pages, raw = _load_input(req, _ACTION_NEEDS.get(action, ("low", "high")))

    if action == "detect":
        det = preds["detection"]([image])[0]
        polys = [b.polygon for b in det.bboxes]
        return {
            "image_b64": _img_b64(draw_polys_on_image(polys, image.copy())),
            "result": det.model_dump(exclude={"heatmap", "affinity_map"}),
        }

    if action == "layout":
        pred = preds["layout"]([image])[0]
        polys = [p.polygon for p in pred.bboxes]
        labels = [f"{p.label}-{p.position}-{round(p.top_k[p.label], 2)}" for p in pred.bboxes]
        img = draw_polys_on_image(polys, image.copy(), labels=labels, label_font_size=18)
        return {"image_b64": _img_b64(img), "result": pred.model_dump()}

    if action == "ocr":
        if req.get("skip_text_detection"):
            ocr_img, bboxes, det_kw = highres, [[[0, 0, highres.width, highres.height]]], {}
        else:
            ocr_img, bboxes, det_kw = image, None, {"det_predictor": preds["detection"]}
        task = TaskNames.ocr_with_boxes if req.get("ocr_with_boxes", True) else TaskNames.ocr_without_boxes
        result = preds["recognition"](
            [ocr_img], task_names=[task], bboxes=bboxes,
            highres_images=[highres], math_mode=bool(req.get("recognize_math", True)),
            return_words=True, **det_kw,
        )[0]
        lines = result.text_lines
        rendered = draw_text_on_image([l.bbox for l in lines], [l.text for l in lines], ocr_img.size)
        boxed = ocr_img.copy()
        draw = ImageDraw.Draw(boxed)
        for line in lines:
            for w in line.words or []:
                draw.rectangle(w.bbox, outline="red", width=2)
        return {
            "image_b64": _img_b64(rendered),
            "word_boxes_b64": _img_b64(boxed),
            "text": "\n".join(l.text for l in lines),
            "result": result.model_dump(),
        }

    if action == "table":
        if req.get("skip_table_detection"):
            table_imgs, table_bboxes = [highres], [[0, 0, highres.width, highres.height]]
        else:
            layout_pred = preds["layout"]([image])[0]
            table_imgs, table_bboxes = [], []
            for box in layout_pred.bboxes:
                if box.label not in ("Table", "TableOfContents"):
                    continue
                hb = expand_bbox(rescale_bbox(box.bbox, image.size, highres.size))
                table_imgs.append(highres.crop(hb))
                table_bboxes.append(hb)
        table_preds = preds["table_rec"](table_imgs)
        out_img = highres.copy()
        for results, tb in zip(table_preds, table_bboxes):
            boxes = [[c.bbox[0] + tb[0], c.bbox[1] + tb[1], c.bbox[2] + tb[0], c.bbox[3] + tb[1]]
                     for c in results.cells]
            labels = [c.label for c in results.cells]
            colors = ["blue" if "Row" in c.label else "red" for c in results.cells]
            out_img = draw_bboxes_on_image(boxes, out_img, labels=labels, label_font_size=18, color=colors)
        return {
            "image_b64": _img_b64(out_img),
            "result": [p.model_dump() for p in table_preds],
            "n_tables": len(table_imgs),
        }

    if action == "ocr_error":
        if n_pages is None:
            return {"error": "This feature only works with PDFs.", "status": 400}
        try:
            samples = sample_pdf_text(raw, n_pages)
        except ImportError:
            return {"error": "Bad-text detection needs the pdftext package.", "status": 400}
        labels = preds["ocr_error"](samples).labels if samples else []
        return {"verdict": classify_pdf_text_quality(labels), "result": labels or ["no text"]}

    return {"error": f"unknown action {action!r}", "status": 404}


def make_server(port: int = 0, tiny: bool = False) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks a free port."""
    preds = PredictorRegistry(tiny=tiny)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route access logs to our logger
            logger.debug("web_app: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/healthz":
                self._send(200, b'{"ok": true}', "application/json")
            else:
                self._send(404, b'{"error": "not found"}', "application/json")

        MAX_BODY_BYTES = 64 * 1024 * 1024  # uploads are base64 JSON; 64 MB is generous

        def do_POST(self):
            if not self.path.startswith("/api/"):
                self._send(404, b'{"error": "not found"}', "application/json")
                return
            action = self.path[len("/api/"):]
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, b'{"error": "bad Content-Length"}', "application/json")
                return
            if length < 0:
                # rfile.read(-1) would block until the client closes the
                # socket, pinning the handler thread
                self._send(400, b'{"error": "bad Content-Length"}', "application/json")
                return
            if length > self.MAX_BODY_BYTES:
                # reject BEFORE reading: a huge declared length must not
                # allocate unboundedly
                self._send(413, b'{"error": "request body too large"}', "application/json")
                return
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                with preds.lock:
                    out = run_action(preds, action, req)
                code = int(out.pop("status", 200))
            except Exception as e:  # noqa: BLE001 — every request must answer
                logger.exception("web_app: %s failed", action)
                out, code = {"error": f"{type(e).__name__}: {e}"}, 500
            self._send(code, json.dumps(out).encode(), "application/json")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.predictors = preds  # callers may seed predictors built elsewhere
    return server


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description="surya-tpu web GUI (stdlib, no streamlit)")
    ap.add_argument("--port", type=int, default=8866)
    ap.add_argument(
        "--host", default="127.0.0.1",
        help="must be 127.0.0.1 (loopback-only policy); put a reverse proxy "
        "in front for remote access",
    )
    ap.add_argument("--tiny", action="store_true", help="tiny random models (demo/CI)")
    args = ap.parse_args(argv)
    # validate BEFORE binding the port — a rejected host must not waste a bind
    if args.host != "127.0.0.1":
        raise SystemExit("web_app binds 127.0.0.1 only; put a reverse proxy in front for remote access")
    server = make_server(args.port, tiny=args.tiny)
    print(f"surya-tpu web GUI: http://127.0.0.1:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
