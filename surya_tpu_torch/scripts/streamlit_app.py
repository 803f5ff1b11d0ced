"""Interactive GUI wiring all five of the port's predictors (counterpart of
surya_tpu/scripts/streamlit_app.py; feature parity with the
reference surya/scripts/streamlit_app.py: PDF upload + page selection at
low/high DPI, text detection, OCR with word boxes / math / no-boxes modes,
layout, table rec with layout-driven table crops, and OCR-error sampling of
the PDF's embedded text). Run with:

    surya_torch_gui  # wraps `streamlit run` on this file

Requires streamlit (not installed in every environment; the CLI surfaces a
clear error if missing). PDF features additionally need pypdfium2, and the
bad-text detector needs pdftext.
"""

from __future__ import annotations

import io
import tempfile
from typing import List, Tuple


def classify_pdf_text_quality(labels: List[str], bad_ratio: float = 0.2) -> str:
    """Aggregate per-sample OCR-error labels into a verdict (reference
    surya/scripts/streamlit_app.py:54-58)."""
    if not labels:
        return "This PDF has no text or very little text"
    if labels.count("bad") / len(labels) > bad_ratio:
        return "This PDF may have garbled or bad OCR text."
    return "This PDF has good text."


def sample_pdf_text(pdf_bytes: bytes, page_count: int, sample_len=512, max_samples=10, max_pages=15) -> List[str]:
    """Sample embedded text from the middle of a PDF for the OCR-error model
    (reference :28-52; needs pdftext)."""
    from pdftext.extraction import plain_text_output

    with tempfile.NamedTemporaryFile(suffix=".pdf") as f:
        f.write(pdf_bytes)
        f.seek(0)
        page_middle = page_count // 2
        page_range = range(max(page_middle - max_pages, 0), min(page_middle + max_pages, page_count))
        text = plain_text_output(f.name, page_range=page_range)

    sample_gap = len(text) // max_samples
    if len(text) == 0 or sample_gap == 0:
        return []
    sample_gap = max(sample_gap, sample_len)
    return [text[i : i + sample_len] for i in range(0, len(text), sample_gap)]


def main():
    import streamlit as st
    from PIL import Image, ImageDraw

    from surya_tpu_torch.common.util import expand_bbox, rescale_bbox
    from surya_tpu_torch.debug.draw import draw_bboxes_on_image, draw_polys_on_image, draw_text_on_image
    from surya_tpu_torch.models_registry import load_predictors
    from surya_tpu_torch.recognition.tokenizer import TaskNames
    from surya_tpu_torch.settings import settings

    st.set_page_config(layout="wide")
    col1, col2 = st.columns([0.5, 0.5])

    @st.cache_resource()
    def predictors():
        return load_predictors()

    preds = predictors()

    st.markdown(
        """
# Surya-TPU OCR Demo

This app will let you try surya-tpu, a multilingual OCR toolkit.

Notes:
- This works best on documents with printed text.
- For OCR, formatting (math, italics, etc) will not show in the image preview, but it is in the returned text lines.
- If OCR doesn't work, try changing the resolution of your image (increase if below 2048px width, otherwise decrease).
"""
    )

    def open_pdf(pdf_file):
        import pypdfium2

        return pypdfium2.PdfDocument(io.BytesIO(pdf_file.getvalue()))

    @st.cache_data()
    def get_page_image(pdf_file, page_num, dpi=settings.IMAGE_DPI):
        doc = open_pdf(pdf_file)
        png = doc[page_num - 1].render(scale=dpi / 72, draw_annots=False).to_pil().convert("RGB")
        doc.close()
        return png

    @st.cache_data()
    def page_counter(pdf_file):
        doc = open_pdf(pdf_file)
        n = len(doc)
        doc.close()
        return n

    in_file = st.sidebar.file_uploader(
        "PDF file or image:", type=["pdf", "png", "jpg", "jpeg", "gif", "webp"]
    )
    if in_file is None:
        st.stop()

    page_count = None
    if "pdf" in in_file.type:
        page_count = page_counter(in_file)
        page_number = st.sidebar.number_input(
            f"Page number out of {page_count}:", min_value=1, value=1, max_value=page_count
        )
        pil_image = get_page_image(in_file, page_number, settings.IMAGE_DPI)
        pil_image_highres = get_page_image(in_file, page_number, settings.IMAGE_DPI_HIGHRES)
    else:
        pil_image = Image.open(in_file).convert("RGB")
        pil_image_highres = pil_image

    run_text_det = st.sidebar.button("Run Text Detection")
    run_text_rec = st.sidebar.button("Run OCR")
    run_layout_det = st.sidebar.button("Run Layout Analysis")
    run_table_rec = st.sidebar.button("Run Table Rec")
    run_ocr_errors = st.sidebar.button("Run bad PDF text detection")
    skip_table_detection = st.sidebar.checkbox(
        "Skip table detection", value=False,
        help="Table recognition only: treat the whole image/page as a table.",
    )
    skip_text_detection = st.sidebar.checkbox(
        "Skip text detection", value=False,
        help="OCR only: treat the whole image as a single line.",
    )
    recognize_math = st.sidebar.checkbox("Recognize math in OCR", value=True)
    ocr_with_boxes = st.sidebar.checkbox(
        "OCR with boxes", value=True, help="Predict character-level boxes during OCR."
    )

    def layout_detection(img) -> Tuple[Image.Image, object]:
        pred = preds["layout"]([img])[0]
        polys = [p.polygon for p in pred.bboxes]
        labels = [f"{p.label}-{p.position}-{round(p.top_k[p.label], 2)}" for p in pred.bboxes]
        return draw_polys_on_image(polys, img.copy(), labels=labels, label_font_size=18), pred

    if run_text_det:
        det = preds["detection"]([pil_image])[0]
        polys = [b.polygon for b in det.bboxes]
        with col1:
            st.image(draw_polys_on_image(polys, pil_image.copy()), caption="Detected Text", use_container_width=True)
            st.json(det.model_dump(exclude=["heatmap", "affinity_map"]), expanded=True)

    if run_layout_det:
        layout_img, pred = layout_detection(pil_image)
        with col1:
            st.image(layout_img, caption="Detected Layout", use_container_width=True)
            st.json(pred.model_dump(), expanded=True)

    if run_text_rec:
        if skip_text_detection:
            ocr_img = pil_image_highres
            bboxes = [[[0, 0, ocr_img.width, ocr_img.height]]]
        else:
            ocr_img = pil_image
            bboxes = None
        task = TaskNames.ocr_with_boxes if ocr_with_boxes else TaskNames.ocr_without_boxes
        result = preds["recognition"](
            [ocr_img],
            task_names=[task],
            bboxes=bboxes,
            det_predictor=preds["detection"],
            highres_images=[pil_image_highres],
            math_mode=recognize_math,
            return_words=True,
        )[0]
        line_bboxes = [line.bbox for line in result.text_lines]
        texts = [line.text for line in result.text_lines]
        word_boxes = [w.bbox for line in result.text_lines for w in (line.words or [])]
        box_img = ocr_img.copy()
        draw = ImageDraw.Draw(box_img)
        for wb in word_boxes:
            draw.rectangle(wb, outline="red", width=2)
        with col1:
            st.image(draw_text_on_image(line_bboxes, texts, ocr_img.size), caption="OCR Result", use_container_width=True)
            json_tab, text_tab = st.tabs(["JSON", "Text Lines (for debugging)"])
            with json_tab:
                st.json(result.model_dump(), expanded=False)
            with text_tab:
                st.text("\n".join(texts))
            st.image(box_img, caption="OCR with Word Boxes (for debugging)", use_container_width=True)

    if run_table_rec:
        if skip_table_detection:
            table_bboxes = [[0, 0, pil_image_highres.size[0], pil_image_highres.size[1]]]
            table_imgs = [pil_image_highres]
        else:
            _, layout_pred = layout_detection(pil_image)
            table_imgs, table_bboxes = [], []
            for line in layout_pred.bboxes:
                if line.label not in ("Table", "TableOfContents"):
                    continue
                highres_bbox = expand_bbox(rescale_bbox(line.bbox, pil_image.size, pil_image_highres.size))
                table_imgs.append(pil_image_highres.crop(highres_bbox))
                table_bboxes.append(highres_bbox)
        table_preds = preds["table_rec"](table_imgs)
        table_img = pil_image_highres.copy()
        for results, table_bbox in zip(table_preds, table_bboxes):
            adjusted, labels, colors = [], [], []
            for item in results.cells:
                adjusted.append(
                    [item.bbox[0] + table_bbox[0], item.bbox[1] + table_bbox[1],
                     item.bbox[2] + table_bbox[0], item.bbox[3] + table_bbox[1]]
                )
                labels.append(item.label)
                colors.append("blue" if "Row" in item.label else "red")
            table_img = draw_bboxes_on_image(adjusted, table_img, labels=labels, label_font_size=18, color=colors)
        with col1:
            st.image(table_img, caption="Table Recognition", use_container_width=True)
            st.json([p.model_dump() for p in table_preds], expanded=True)

    if run_ocr_errors:
        if page_count is None:
            st.error("This feature only works with PDFs.")
        else:
            try:
                samples = sample_pdf_text(in_file.getvalue(), page_count)
            except ImportError:
                st.error("Bad-text detection needs the pdftext package.")
                samples = None
            if samples is not None:
                labels = preds["ocr_error"](samples).labels if samples else []
                with col1:
                    st.write(classify_pdf_text_quality(labels))
                    st.json(labels if labels else ["no text"])

    with col2:
        st.image(pil_image, caption="Uploaded Image", use_container_width=True)


if __name__ == "__main__":
    main()
