"""PyTorch + CUDA port of the device plane, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports neither
``jax`` nor anything of ``repro`` and keeps its own copies of what it needs.
Its layout follows ``repro`` so a module's counterpart is easy to find.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""
