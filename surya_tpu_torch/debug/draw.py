"""Debug drawing helpers (the port's copy of surya_tpu/debug/draw.py)."""

from __future__ import annotations

import re
from typing import List, Optional

from PIL import Image, ImageDraw, ImageFont

_TAG_RE = re.compile(r"<[\w/][^>]*>")


def strip_html_tags(html_text: str) -> str:
    return _TAG_RE.sub("", html_text)


def _font(size: int, font_path: Optional[str] = None):
    if font_path:
        try:
            return ImageFont.truetype(font_path, size)
        except Exception:
            pass
    try:
        return ImageFont.truetype(ImageFont.load_default().path, size)  # pragma: no cover
    except Exception:
        try:
            return ImageFont.load_default(size=size)
        except TypeError:
            return ImageFont.load_default()


def draw_bboxes_on_image(bboxes, image, labels=None, label_font_size=10, color="red"):
    polys = [[[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]] for b in bboxes]
    return draw_polys_on_image(polys, image, labels, label_font_size=label_font_size, color=color)


def draw_polys_on_image(corners, image, labels=None, label_offset=1, label_font_size=10, color="red"):
    draw = ImageDraw.Draw(image)
    font = _font(label_font_size)
    for i, poly in enumerate(corners):
        pts = [(int(p[0]), int(p[1])) for p in poly]
        c = color[i] if isinstance(color, list) else color
        draw.polygon(pts, outline=c, width=1)
        if labels is not None:
            x = min(p[0] for p in pts) + label_offset
            y = min(p[1] for p in pts) + label_offset
            bbox = draw.textbbox((x, y), labels[i], font=font)
            draw.rectangle(bbox, fill="white")
            draw.text((x, y), labels[i], fill=c, font=font)
    return image


def _text_size(draw, text, font):
    _, _, w, h = draw.textbbox((0, 0), text=text, font=font)
    return w, h


def draw_text_on_image(
    bboxes,
    texts: List[str],
    image_size,
    font_path: Optional[str] = None,
    langs: Optional[List[str]] = None,
    max_font_size: int = 60,
    res_upscale: int = 2,
) -> Image.Image:
    """Re-render recognized text into an empty page (reference debug/
    text.py:71-100): strip markup, place each line in its box at an
    upscaled resolution, shrinking the font until it fits."""
    if font_path is None:
        from surya_tpu_torch.debug.fonts import get_font_path

        font_path = get_font_path(langs)
    size = (image_size[0] * res_upscale, image_size[1] * res_upscale)
    image = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(image)
    for bbox, text in zip(bboxes, texts):
        text = strip_html_tags(text)
        if not text:
            continue
        s_bbox = [int(c * res_upscale) for c in bbox]
        box_w, box_h = s_bbox[2] - s_bbox[0], s_bbox[3] - s_bbox[1]
        font_size = max(6, min(int(0.75 * box_h), max_font_size))
        font = _font(font_size, font_path)
        w, h = _text_size(draw, text, font)
        while (w > box_w or h > box_h) and font_size > 6:
            font_size -= 1
            font = _font(font_size, font_path)
            w, h = _text_size(draw, text, font)
        draw.text((s_bbox[0], s_bbox[1] + (box_h - h) / 2), text, fill="black", font=font)
    return image
