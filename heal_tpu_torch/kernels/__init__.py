"""Build + ctypes binding of the CUDA kernels in ``heal_tpu_torch/csrc``."""
