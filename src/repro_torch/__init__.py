"""PyTorch/CUDA port of the EliteKV serving system.

Mirrors the layout of the JAX package (``configs/``, ``core/``, ``kernels/``,
``models/``, ``runtime/``, ``launch/``) so each module's counterpart is easy
to find.  It imports torch and numpy only; the hot attention kernels are CUDA
C++ for Hopper under ``kernels/csrc/``, built at first use.
"""
