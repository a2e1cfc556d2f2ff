"""Plain PyTorch ops and the wrappers of the CUDA kernels."""
