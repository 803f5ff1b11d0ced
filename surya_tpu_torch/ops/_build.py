"""Build and load the hand-written CUDA kernels in ``surya_tpu_torch/csrc``.

The kernels are plain CUDA C++ with a C interface. At first use, nvcc compiles
every ``csrc/*.cu`` for Hopper (``sm_90a``), one process per source, all
started together, and links the objects into one shared library, which
ctypes then loads. The library's name carries a hash of the sources, so an
edited kernel is rebuilt and a built one is reused. The build directory is
the user's cache directory, ``platformdirs.user_cache_dir("surya_tpu_torch")
/kernels``, so an installed, read-only package builds too
(``SURYA_TORCH_BUILD_DIR`` overrides it).

Nothing here runs at import, so the package imports where there is no nvcc
and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

from platformdirs import user_cache_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "surya_segmented_attention": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "surya_causal_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "surya_gqa_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "surya_gqa_decode_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "surya_decode_config": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "surya_causal_config": [_I, _I, _I, ctypes.POINTER(_I)],
    "surya_segmented_config": [_I, _I, ctypes.POINTER(_I)],
    "surya_graph_if_begin": [_P, _P, _P],
    "surya_graph_if_end": [_P],
    "surya_graph_while_begin": [_P, _P, _P, ctypes.POINTER(ctypes.c_ulonglong)],
    "surya_graph_while_end": [_P, _P, ctypes.c_ulonglong],
    "surya_moe_route": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "surya_moe_permute": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "surya_moe_swiglu": [_P, _P, _P, _I, _I, _I, _P],
    "surya_moe_combine": [_P, _P, _P, _P, _P, _I, _I, _P],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    build_log: str  # nvcc/ptxas output (registers, shared memory, spills)
    # seconds of each nvcc process (one per source, then "link"); their sum
    # is what the same build takes one process after another
    step_seconds: dict


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def default_build_dir() -> Path:
    """Where the kernels are built when SURYA_TORCH_BUILD_DIR is unset."""
    return Path(user_cache_dir("surya_tpu_torch")) / "kernels"


@functools.cache
def library() -> KernelLibrary:
    """Compile (once per source hash) and load the kernel library."""
    sources, headers = _sources()
    digest = hashlib.sha256()
    for f in (*sources, *headers):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    build_dir = Path(os.environ.get("SURYA_TORCH_BUILD_DIR") or default_build_dir())
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / f"libsurya_kernels_{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")

    seconds, step_seconds = 0.0, {}
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()

        def run(name, cmd):
            t = time.perf_counter()
            out = subprocess.run(cmd, capture_output=True, text=True)
            return name, out.returncode, out.stdout + out.stderr, time.perf_counter() - t

        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        with ThreadPoolExecutor(len(sources)) as pool:
            steps = list(pool.map(run, [s.name for s in sources],
                                  [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objs)]))
        if not any(rc for _, rc, _, _ in steps):
            steps.append(run("link", [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        failed = [(n, rc, log) for n, rc, log, _ in steps if rc]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n} ({rc}):\n{log}" for n, rc, log in failed))
        log_path.write_text("".join(log for _, _, log, _ in steps))
        step_seconds = {n: s for n, _, _, s in steps}
        os.replace(tmp, so)  # atomic: a concurrent builder never loads a partial file

    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=so, build_seconds=seconds, build_log=log, step_seconds=step_seconds)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
