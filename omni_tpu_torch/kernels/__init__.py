"""Kernels and plain tensor ops of the port (counterpart of
omni_tpu/kernels). CUDA sources live in `omni_tpu_torch/csrc/`."""
