"""PyTorch/CUDA port of ProteinReDiff-TPU for NVIDIA Hopper.

The JAX package ``protein_redesign_tpu`` stays the reference; this package
mirrors its module names (``ops/``, ``models/``, ``utils/``, ``cli/``) and adds
``kernels/``, the hand-written CUDA kernels and their nvcc/ctypes loader.
Framework-free code (config, chem, featurization, collation, weight
conversion, ESM, TM-align) is imported from the JAX package, never copied.
This package imports torch and never jax.
"""

__version__ = "0.1.0"
