"""Symmetric int8 quantization for the paged latent pool.

Counterpart of the JAX package's ``core/quant.py``.  One f32 scale per pool
slot per stream, absmax over every trailing dim of the token's row, so a
token's codes depend on its own values only: chunked, one-shot and
preempted write orders land the same pages.  ``scale = max(absmax, eps) /
127`` and ``q = round(x / scale)`` in f32, in that order; ``torch.round``
rounds half to even like ``jnp.round``, so codes and scales equal the
reference's bit for bit on the same f32 rows.  Dequantization is the one
multiply ``q.float() * scale``, which the q8 decode kernels repeat while
they stage a block.
"""
from __future__ import annotations

import torch

#: symmetric int8 range: q in [-127, 127] (the -128 code is never produced)
INT8_MAX = 127
#: absmax floor, so an all-zero row still gets a strictly positive scale
SCALE_EPS = 1e-8


def quantize_rows(x: torch.Tensor):
    """``x [N, ...]`` → ``(q int8 [N, ...], scale f32 [N])``, one scale per
    leading-axis row over all its trailing dims."""
    xf = x.float()
    trailing = tuple(range(1, xf.dim()))
    absmax = xf.abs().amax(dim=trailing) if trailing else xf.abs()
    scale = torch.clamp(absmax, min=SCALE_EPS) / INT8_MAX
    s = scale.reshape(scale.shape + (1,) * len(trailing))
    q = torch.clamp(torch.round(xf / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q int8 [N, ...] * scale [N]`` → f32; ``scale`` broadcasts over the
    trailing dims of ``q`` (``scale.shape == q.shape[:scale.dim()]``)."""
    s = scale.float()
    return q.float() * s.reshape(s.shape + (1,) * (q.dim() - s.dim()))


def roundtrip_rows(x: torch.Tensor, batch_dims: int = 1) -> torch.Tensor:
    """Quantize then dequantize each token row of ``x`` (its leading
    ``batch_dims`` axes index rows); returns ``x``'s shape and dtype.  A
    fresh prefill attends over this, so it sees what later pool reads will."""
    flat = x.reshape((-1,) + tuple(x.shape[batch_dims:]))
    q, s = quantize_rows(flat)
    return dequantize(q, s).reshape(x.shape).to(x.dtype)


def is_int8(dtype) -> bool:
    """True when ``dtype`` names the quantized pool (``"int8"`` or
    ``torch.int8``)."""
    return dtype in ("int8", torch.int8)
