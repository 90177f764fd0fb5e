"""geneevolve-tpu-torch: the segment engine of geneevolve-tpu on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package `geneevolve_tpu` beside it is the reference this port is
held against. This package imports `torch` and never `jax`; it reuses the
JAX package's JAX-free modules (`config`, `io`, `core.mating`, `native`).
"""

__version__ = "0.1.0"
