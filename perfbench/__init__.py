"""The benchmark of surya_tpu_torch on the GPU: see README.md."""
