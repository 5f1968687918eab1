"""PS³ offline plane on PyTorch and hand-written CUDA kernels for Hopper.

A second package beside the JAX reference `repro`: same module layout,
same semantics, no import of `jax` or `repro` at run time.
"""
