"""The C++ CRAFT host op of the port (its own copy of surya_tpu/native).

``craft_ops.cpp`` does a page's whole box extraction in one call: threshold,
4-connected components (union-find), per-component rectangular dilation,
the minimum-area rectangle, the near-square snap and the corner order. At
first use it is built with ``g++`` into the user's cache directory
(``platformdirs.user_cache_dir("surya_tpu_torch")/native``, so an installed,
read-only package builds too; ``SURYA_TORCH_NATIVE_DIR`` overrides it) and
loaded with ctypes; the library's name carries a hash of the source, so an
edited source is rebuilt. A build or load failure raises: the OpenCV path orders
components differently, so it runs only where ``USE_NATIVE_POSTPROCESS`` is
off, never in place of a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
from platformdirs import user_cache_dir

_SRC = Path(__file__).resolve().parent / "craft_ops.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def default_build_dir() -> Path:
    """Where the library is built when SURYA_TORCH_NATIVE_DIR is unset."""
    return Path(user_cache_dir("surya_tpu_torch")) / "native"


def _load() -> ctypes.CDLL:
    build_dir = Path(os.environ.get("SURYA_TORCH_NATIVE_DIR") or default_build_dir())
    build_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = build_dir / f"libcraft_ops_{digest}.so"
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        out = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
        if out.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SRC.name} ({out.returncode}):\n{out.stdout}{out.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent builder never loads a partial file
    lib = ctypes.CDLL(str(so))
    for name, pixel in (("craft_extract_boxes", ctypes.c_float), ("craft_extract_boxes_u8", ctypes.c_uint8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(pixel), ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
    return lib


def craft_ops() -> ctypes.CDLL:
    """The compiled library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
    return _lib


def extract_boxes(linemap: np.ndarray, text_threshold: float, low_text: float, max_boxes: int = 1024):
    """CRAFT box extraction from a float32 [0, 1] or uint8 (value * 255)
    heatmap [h, w]; thresholds and confidences are in [0, 1]. Returns
    (quads [n, 4, 2] float32, confidences [n])."""
    if linemap.ndim != 2:
        raise ValueError(f"extract_boxes takes one [h, w] map, got {linemap.shape}")
    lib = craft_ops()
    quads = np.zeros((max_boxes, 8), np.float32)
    confs = np.zeros((max_boxes,), np.float32)
    if linemap.dtype == np.uint8:
        linemap = np.ascontiguousarray(linemap)
        fn, ptr = lib.craft_extract_boxes_u8, ctypes.POINTER(ctypes.c_uint8)
    else:
        linemap = np.ascontiguousarray(linemap, np.float32)
        fn, ptr = lib.craft_extract_boxes, ctypes.POINTER(ctypes.c_float)
    h, w = linemap.shape
    n = fn(
        linemap.ctypes.data_as(ptr), h, w, ctypes.c_float(text_threshold), ctypes.c_float(low_text),
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        confs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_boxes,
    )
    return quads[:n].reshape(n, 4, 2), confs[:n]
