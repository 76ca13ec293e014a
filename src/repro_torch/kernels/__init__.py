"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions and wrappers.  Nothing here builds or imports a compiler at import
time: a kernel is compiled at its first launch on the card."""
