"""Data of the port's accuracy stages (the port's copy of
benchmark/utils/data.py): Hugging Face datasets where they can be reached,
and synthetic pages with exact ground truth offline. The synthetic pages are
pixel for pixel the JAX stages'. They draw text with ``font_size=``, which
needs Pillow 10.1 or later with FreeType; where Pillow cannot draw at a size
they raise rather than fall back to another font."""

from __future__ import annotations

from typing import List, Tuple

from PIL import Image, ImageDraw


def load_hf_dataset(name: str, max_rows: int):
    """The first ``max_rows`` rows of the dataset's train split (the
    ``datasets`` package is imported here, at the call)."""
    import datasets

    return datasets.load_dataset(name, split=f"train[:{max_rows}]")


def _sized_text(draw: ImageDraw.ImageDraw, xy, text: str, font_size: int) -> None:
    try:
        draw.text(xy, text, fill="black", font_size=font_size)
    except (TypeError, ImportError, OSError) as e:
        raise RuntimeError(f"the synthetic pages draw text at font_size={font_size}, which needs Pillow >= 10.1 "
                           f"with FreeType; this Pillow cannot: {type(e).__name__}: {e}") from e


def synthetic_text_pages(n: int, lines: int = 12, size=(1024, 1024)) -> Tuple[
        List[Image.Image], List[List[List[int]]], List[List[str]]]:
    """Pages of horizontal text lines with exact line bboxes and strings."""
    images, all_boxes, all_texts = [], [], []
    for p in range(n):
        img = Image.new("RGB", size, "white")
        draw = ImageDraw.Draw(img)
        boxes, texts = [], []
        for i in range(lines):
            text = f"Synthetic page {p} line {i} of benchmark text."
            y = 40 + i * 70
            _sized_text(draw, (50, y), text, 28)
            boxes.append([int(v) for v in draw.textbbox((50, y), text, font_size=28)])
            texts.append(text)
        images.append(img)
        all_boxes.append(boxes)
        all_texts.append(texts)
    return images, all_boxes, all_texts


def synthetic_table_pages(n: int, rows: int = 4, cols: int = 3, size=(800, 600)):
    """Grid tables with exact row and column bboxes."""
    images, all_rows, all_cols = [], [], []
    cell_w, cell_h = size[0] // cols, size[1] // rows
    for _ in range(n):
        img = Image.new("RGB", size, "white")
        draw = ImageDraw.Draw(img)
        for r in range(rows):
            for c in range(cols):
                draw.rectangle(
                    (c * cell_w + 4, r * cell_h + 4, (c + 1) * cell_w - 4, (r + 1) * cell_h - 4),
                    outline="black",
                )
                _sized_text(draw, (c * cell_w + 14, r * cell_h + 16), f"r{r}c{c}", 20)
        images.append(img)
        all_rows.append([[0, r * cell_h, size[0], (r + 1) * cell_h] for r in range(rows)])
        all_cols.append([[c * cell_w, 0, (c + 1) * cell_w, size[1]] for c in range(cols)])
    return images, all_rows, all_cols
