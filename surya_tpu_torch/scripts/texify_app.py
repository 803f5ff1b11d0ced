"""LaTeX OCR snipping GUI on the port's RecognitionPredictor (counterpart of
surya_tpu/scripts/texify_app.py; reference: surya/scripts/texify_app.py).
Run via `texify_torch_gui` (wraps streamlit)."""

from __future__ import annotations

import io


def run():
    import streamlit as st
    from PIL import Image

    from surya_tpu_torch.recognition import RecognitionPredictor
    from surya_tpu_torch.recognition.tokenizer import TaskNames

    st.set_page_config(layout="wide")
    st.markdown("# Texify — LaTeX OCR")

    @st.cache_resource()
    def predictor():
        return RecognitionPredictor()

    rec = predictor()

    uploaded = st.file_uploader("Equation image:", type=["png", "jpg", "jpeg", "webp"])
    if uploaded is None:
        st.stop()

    image = Image.open(io.BytesIO(uploaded.getvalue())).convert("RGB")
    st.image(image)
    result = rec(
        [image],
        task_names=[TaskNames.block_without_boxes],
        bboxes=[[[0, 0, image.width, image.height]]],
    )[0]
    latex = result.text_lines[0].text
    st.code(latex, language="latex")
    st.markdown(f"$$ {latex} $$")


if __name__ == "__main__":
    run()
