"""The benchmark of the PyTorch and CUDA port, mfvit_tpu_torch."""
