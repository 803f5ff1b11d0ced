"""The one traffic generator: a mix is a JSON file of parameters under
``perfbench/traffic/<name>.json``, and this module turns it and a seed into
the pages that the calls of a run send.

A page is laid out as ``bench.py`` draws its page: ``lines`` lines of text
at ``font_size`` in PIL's default font, black on white, at ``x0`` and
``y0 + i * pitch``. Each line has as
many characters as the ``text`` template has for its index, drawn from the
seed out of a fixed alphabet, so every seed sends the same number of lines
and characters, in other glyphs. A run cycles through a pool of
``page_pool`` distinct pages, ``pages_per_call`` at a time.
"""

from __future__ import annotations

import json
import string
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
from PIL import Image, ImageDraw, ImageFont

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
ALPHABET = string.ascii_letters + string.digits + ".,:;'()-"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


@dataclass
class Page:
    image: Image.Image
    lines: List[List[int]]  # the ink box of each drawn line, [x0, y0, x1, y1]
    texts: List[str]


class Glyphs:
    """The alphabet's glyphs at one font size, each rendered once by
    FreeType (PIL's default font; Pillow >= 10.1 with FreeType, or this
    raises): a line is their masks set side by side at their advances,
    without kerning, many times faster than drawing it through PIL."""

    def __init__(self, size: int):
        font = ImageFont.load_default(size=size)
        self.masks, self.boxes, self.advance = {}, {}, {}
        for c in ALPHABET + " ":
            x0, y0, x1, y1 = font.getbbox(c)
            mask = Image.new("L", (max(1, x1 - x0), max(1, y1 - y0)), 0)
            ImageDraw.Draw(mask).text((-x0, -y0), c, fill=255, font=font)
            self.masks[c] = np.asarray(mask)
            self.boxes[c] = (x0, y0, x1, y1)
            self.advance[c] = font.getlength(c)

    def draw(self, page: np.ndarray, x: float, y: int, text: str) -> List[int]:
        """Darkens `text` into page (uint8 [H, W]) at (x, y); returns its ink box."""
        ink = [None, None, None, None]
        for c in text:
            x0, y0, x1, y1 = self.boxes[c]
            if c != " ":
                m = self.masks[c]
                px, py = int(round(x)) + x0, y + y0
                region = page[py : py + m.shape[0], px : px + m.shape[1]]
                np.minimum(region, 255 - m, out=region)
                box = (px, py, px + m.shape[1], py + m.shape[0])
                ink = [box[0] if ink[0] is None else min(ink[0], box[0]), box[1] if ink[1] is None else min(ink[1], box[1]),
                       max(ink[2] or 0, box[2]), max(ink[3] or 0, box[3])]
            x += self.advance[c]
        return ink


def draw_page(spec: dict, rng: np.random.Generator, glyphs: Glyphs) -> Page:
    """One page of `spec` (a mix's "page" entry)."""
    page = np.full((spec["height"], spec["width"]), 255, np.uint8)
    lines, texts = [], []
    for i in range(spec["lines"]):
        n = len(spec["text"].format(i=i))
        # about one character in five a space, as between words; never at an end
        chars = rng.choice(list(ALPHABET), size=n)
        spaces = rng.random(n) < 0.2
        spaces[0] = spaces[-1] = False
        text = "".join(" " if s else str(c) for c, s in zip(chars, spaces))
        lines.append(glyphs.draw(page, spec["x0"], spec["y0"] + i * spec["pitch"], text))
        texts.append(text)
    return Page(Image.fromarray(page).convert("RGB"), lines, texts)


def page_pool(mix: dict, seed: int) -> List[Page]:
    rng = np.random.default_rng(seed)
    glyphs = Glyphs(mix["page"]["font_size"])
    return [draw_page(mix["page"], rng, glyphs) for _ in range(mix["page_pool"])]


def call_pages(mix: dict, pool: List[Page], k: int) -> List[Page]:
    """The pages of call k of a run: the pool's next pages_per_call, cycling."""
    n = mix["pages_per_call"]
    return [pool[(k * n + j) % len(pool)] for j in range(n)]
