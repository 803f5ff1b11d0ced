"""surya-tpu-torch: whole-page OCR of surya_tpu (text-line detection, then
recognition) ported to PyTorch and hand-written CUDA kernels for one NVIDIA
H100 (sm_90a).

The JAX package ``surya_tpu`` stays the reference this port is held against;
this package imports ``torch`` and never ``jax`` or anything of ``surya_tpu``.
"""

__version__ = "0.1.0"
