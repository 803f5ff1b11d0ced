"""HTML rendering of OCR results with KaTeX math (the port's copy of
surya_tpu/debug/render_html.py; reference: surya/debug/render_html.py,
debug/text.py). Produces a standalone HTML page; optional pixel rendering
via playwright when installed."""

from __future__ import annotations

import html as html_lib
from typing import List, Optional

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<link rel="stylesheet" href="https://cdn.jsdelivr.net/npm/katex@0.16.9/dist/katex.min.css">
<script defer src="https://cdn.jsdelivr.net/npm/katex@0.16.9/dist/katex.min.js"></script>
<script defer src="https://cdn.jsdelivr.net/npm/katex@0.16.9/dist/contrib/auto-render.min.js"
  onload="renderMathInElement(document.body, {{delimiters: [
    {{left: '<math display=\\"block\\">', right: '</math>', display: true}},
    {{left: '<math>', right: '</math>', display: false}}]}});"></script>
<style>
  body {{ position: relative; width: {width}px; height: {height}px;
          font-family: 'Noto Sans', sans-serif; }}
  .line {{ position: absolute; white-space: nowrap; overflow: hidden; }}
</style>
</head>
<body>
{lines}
</body>
</html>
"""


def render_text_html(bboxes: List[List[float]], texts: List[str], image_size) -> str:
    """Absolutely-positioned line spans sized to their boxes."""
    spans = []
    for bbox, text in zip(bboxes, texts):
        if not text:
            continue
        height = max(6, int((bbox[3] - bbox[1]) * 0.75))
        # math segments pass through for KaTeX auto-render; plain text escapes
        safe = text if "<math" in text else html_lib.escape(text)
        spans.append(
            f'<div class="line" style="left:{bbox[0]}px; top:{bbox[1]}px; '
            f"width:{bbox[2] - bbox[0]}px; height:{bbox[3] - bbox[1]}px; "
            f'font-size:{height}px">{safe}</div>'
        )
    return _PAGE.format(width=image_size[0], height=image_size[1], lines="\n".join(spans))


def render_html_to_image(html: str, image_size) -> Optional["Image.Image"]:  # noqa: F821
    """Rasterize with playwright+chromium when available; None otherwise."""
    try:
        from playwright.sync_api import sync_playwright
    except ImportError:
        return None
    import io

    from PIL import Image

    with sync_playwright() as p:
        browser = p.chromium.launch()
        page = browser.new_page(viewport={"width": image_size[0], "height": image_size[1]})
        page.set_content(html)
        page.wait_for_timeout(500)
        png = page.screenshot()
        browser.close()
    return Image.open(io.BytesIO(png))
