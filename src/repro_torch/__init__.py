"""POLCA on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout as ``repro``; each module names its counterpart. The
port imports neither JAX nor anything of ``repro``: where it needs a module
of the JAX package it keeps its own copy. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
