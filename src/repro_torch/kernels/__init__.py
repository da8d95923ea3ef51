"""FantastIC4 serving kernels: hand-written CUDA for Hopper (``csrc/``),
their ctypes wrappers and plain PyTorch versions, and the dispatch in
``ops``.  Importing this package builds nothing."""
