"""PyTorch + CUDA port of the split-inference feature codec.

Mirrors the JAX package ``repro`` module for module: ``obs``, ``core``,
``kernels`` (hand-written CUDA kernels for Hopper, sources in ``csrc``),
``configs``, ``models``, ``data``, ``serving`` and ``launch``.  Entry
points run on the CUDA device unless the caller asks for the CPU.
"""
