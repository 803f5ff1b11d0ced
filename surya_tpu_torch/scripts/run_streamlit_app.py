"""`surya_torch_gui` / `texify_torch_gui` console entry points: exec
streamlit on the port's app files (counterpart of
surya_tpu/scripts/run_streamlit_app.py; reference:
surya/scripts/run_streamlit_app.py)."""

from __future__ import annotations

import os
import subprocess
import sys


def _run(app_file: str):
    try:
        import streamlit  # noqa: F401
    except ImportError:
        raise SystemExit(
            "The GUI requires streamlit, which is not installed in this "
            "environment (pip install streamlit)."
        )
    path = os.path.join(os.path.dirname(__file__), app_file)
    subprocess.run([sys.executable, "-m", "streamlit", "run", path], check=True)


def streamlit_app_cli():
    _run("streamlit_app.py")


def texify_app_cli():
    _run("texify_app.py")
