"""MF-ViT CA in PyTorch with hand-written Hopper (sm_90a) kernels.

The port of ``mfvit_tpu`` (JAX/XLA/Pallas on TPU) to PyTorch and CUDA on an
NVIDIA H100. It mirrors the JAX package's module names; ``mfvit_tpu`` stays
the reference the port is held against in the tests. This package imports
torch and never jax.
"""
