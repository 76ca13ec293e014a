"""PyTorch/CUDA port of the ISO serving stack (``src/repro`` is the JAX
reference it is held against).  Imports ``torch`` and ``numpy`` only."""
