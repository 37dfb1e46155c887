"""PyTorch/CUDA port of the EliteKV system: serving, conversion and
(up)training.

Mirrors the layout of the JAX package (``configs/``, ``core/``, ``kernels/``,
``models/``, ``runtime/``, ``launch/``, ``optim/``, ``data/``,
``checkpoint/``) so each module's counterpart is easy to find.  It imports
torch and numpy only; the hot attention kernels are CUDA C++ for Hopper
under ``kernels/csrc/``, built at first use.
"""
