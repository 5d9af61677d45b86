"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the nvcc/ctypes loader that builds them."""
