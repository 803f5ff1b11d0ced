"""File and folder input loading (the port's copy of surya_tpu/input/load.py).

PDF rasterization needs pypdfium2, imported at first use; without it a PDF
raises an ImportError while image files and folders, which need only PIL,
keep working. Pages are rasterized at IMAGE_DPI (IMAGE_DPI_HIGHRES for the
slices of OCR and table recognition).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from PIL import Image

from surya_tpu_torch.settings import settings

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".tiff", ".tif", ".bmp", ".webp", ".gif"}


def get_name_from_path(path: str) -> str:
    return os.path.basename(path).split(".")[0]


def _is_pdf(path: str) -> bool:
    if path.lower().endswith(".pdf"):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(5) == b"%PDF-"
    except OSError:
        return False


def open_pdf(pdf: "str | bytes"):
    """Open a PDF document from a filesystem path or in-memory bytes.

    pypdfium2's PdfDocument accepts both input kinds natively; the web upload
    path passes raw request bytes, the CLI path passes file paths."""
    try:
        import pypdfium2
    except ImportError as e:
        raise ImportError(
            "PDF input requires pypdfium2, which is not installed in this "
            "environment. Rasterize the PDF to images first."
        ) from e
    return pypdfium2.PdfDocument(pdf)


def load_pdf_page_count(pdf_bytes: bytes) -> int:
    """Page count of an in-memory PDF (web upload path; pypdfium2-gated)."""
    doc = open_pdf(pdf_bytes)
    try:
        return len(doc)
    finally:
        doc.close()


def render_pdf_page(pdf_bytes: bytes, index: int, dpi: int = settings.IMAGE_DPI):
    """Rasterize one page of an in-memory PDF to a PIL RGB image."""
    doc = open_pdf(pdf_bytes)
    try:
        return get_page_images(doc, [index], dpi=dpi)[0]
    finally:
        doc.close()


def get_page_images(doc, indices: List[int], dpi: int = settings.IMAGE_DPI):
    images = [doc[i].render(scale=dpi / 72, draw_annots=False).to_pil() for i in indices]
    return [image.convert("RGB") for image in images]


def load_pdf(pdf_path: str, page_range: Optional[List[int]] = None, dpi: int = settings.IMAGE_DPI):
    doc = open_pdf(pdf_path)
    last_page = len(doc)
    if page_range:
        assert all(0 <= p < last_page for p in page_range), f"invalid page range {page_range}"
    else:
        page_range = list(range(last_page))
    images = get_page_images(doc, page_range, dpi=dpi)
    doc.close()
    return images, [get_name_from_path(pdf_path)] * len(page_range)


def load_image(image_path: str):
    image = Image.open(image_path).convert("RGB")
    return [image], [get_name_from_path(image_path)]


def load_from_file(input_path: str, page_range: Optional[List[int]] = None, dpi: int = settings.IMAGE_DPI):
    if _is_pdf(input_path):
        return load_pdf(input_path, page_range, dpi=dpi)
    return load_image(input_path)


def load_from_folder(folder_path: str, page_range: Optional[List[int]] = None, dpi: int = settings.IMAGE_DPI):
    paths = sorted(
        os.path.join(folder_path, name)
        for name in os.listdir(folder_path)
        if not name.startswith(".") and not os.path.isdir(os.path.join(folder_path, name))
    )
    images, names = [], []
    for path in paths:
        try:
            imgs, nms = load_from_file(path, page_range, dpi)
            images.extend(imgs)
            names.extend(nms)
        except Exception as e:
            logger.warning("could not load %s: %s", path, e)
    return images, names
