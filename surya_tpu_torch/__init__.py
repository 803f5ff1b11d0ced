"""surya-tpu-torch: the recognition path of surya_tpu ported to PyTorch and
hand-written CUDA kernels for one NVIDIA H100 (sm_90a).

The JAX package ``surya_tpu`` stays the reference this port is held against;
this package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
