"""wseg_tpu_torch — the PyTorch/CUDA port of ``wseg_tpu``.

Same file layout and names as the JAX package, which stays the
reference; this package imports torch and never jax, flax or wseg_tpu.
Hand-written CUDA kernels live in ``csrc/`` and build on first use
into ``build/kernels/`` at the repository root.
"""

__version__ = "0.1.0"
