"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with its
wrapper, its plain PyTorch version and its launch counter."""
