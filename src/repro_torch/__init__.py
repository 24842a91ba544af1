"""PyTorch + CUDA port of the GCV-Turbo reproduction (``src/repro``).

Mirrors the JAX package module by module; each file's docstring names the
reference file it stands for.  Imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
