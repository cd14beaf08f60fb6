"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; ``_build`` compiles them with nvcc on first use."""
