"""geneevolve-tpu-torch: the engines of geneevolve-tpu on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package `geneevolve_tpu` beside it is the reference this port is
held against. This package imports `torch`, never `jax`, and nothing of
the JAX package: it keeps its own copies of the host modules it needs
(`config`, `io`, `core.mating`, `native`), under the same module names.
"""

__version__ = "0.1.0"
