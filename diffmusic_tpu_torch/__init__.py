"""DiffMusic on PyTorch and CUDA: the port of `diffmusic_tpu` to one NVIDIA H100.

The JAX package `diffmusic_tpu` is the reference; this package computes the same
functions with PyTorch modules and plain functions on tensors. Its layout mirrors
the reference: DSP in `ops/`, degradation operators in `inverse_problem/`,
`nn.Module` models in `models/`, the DDIM/DPS steps in `samplers/`, the guided
denoise loop in `pipelines/`, and the hand-written Hopper kernels (the
counterparts of the Pallas kernels) in `kernels/`.

Importing this package imports neither `jax` nor `diffmusic_tpu`.
"""

__version__ = "0.1.0"
