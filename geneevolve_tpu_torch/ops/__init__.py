"""Hand-written CUDA kernels of the segment engine, each beside its plain
PyTorch version (used for CPU tensors and as the kernel's oracle)."""
