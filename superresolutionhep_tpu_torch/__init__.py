"""PyTorch/CUDA port of the JAX package beside it (stage-1 SR serving and training so far).

The JAX package beside this one is the reference; this package imports torch,
numpy and the standard library only.  See README.md ("PyTorch/CUDA port").
"""

__version__ = "0.1.0"
