"""The benchmark of the PyTorch and CUDA port (hymls_tpu_torch)."""
