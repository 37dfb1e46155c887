"""Per-head rotary embedding of the packed elite dims: the CUDA kernel.

Port of the JAX package's ``kernels/rope_elite.py::rope_elite``: x
``[B, S, H, 2r]`` is rotated pair by pair at angle ``pos · freqs[h, c]``,
with cos/sin computed in the kernel.  Beyond the TPU contract, positions
may be ``[S]`` or per lane ``[B, S]`` (int32 or int64), x may be a strided
view with a unit last stride (the ``q[..., :2r]`` slice of a projection),
and ``freqs`` may broadcast over the heads (head stride 0: the full RoPE's
``chunk_freqs``).  The kernel source, with what bounds it, is
``csrc/rope_elite.cu``; the plain version is ``ref.rope_elite_ref``.
``kernels.ops`` picks between them by the device of ``x``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_long] * 5
             + [ctypes.c_void_p])


def rope_elite(x, positions, freqs) -> torch.Tensor:
    """Launch the CUDA kernel.

    x [B,S,H,2r] f32 with ``x.stride(-1) == 1``; positions [S] or [B,S]
    int32/int64, contiguous; freqs [H,r] f32 with a unit last stride (head
    stride 0 broadcasts one row); all on one CUDA device.
    → contiguous [B,S,H,2r] f32.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rope_elite kernel needs CUDA tensors, got {dev}")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [B, S, H, 2r]")
    B, S, H, r2 = x.shape
    r = r2 // 2
    if x.dtype != torch.float32 or freqs.dtype != torch.float32:
        raise TypeError(f"x {x.dtype}, freqs {freqs.dtype}: expected float32")
    if x.stride(-1) != 1:
        raise ValueError("x: the last axis must have unit stride")
    if tuple(freqs.shape) != (H, r) or freqs.stride(-1) != 1:
        raise ValueError(f"freqs: shape {tuple(freqs.shape)} stride {freqs.stride()}, "
                         f"expected ({H}, {r}) with a unit last stride")
    if positions.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"positions: dtype {positions.dtype}, expected int32 or int64")
    if tuple(positions.shape) not in ((S,), (B, S)) or not positions.is_contiguous():
        raise ValueError(f"positions: shape {tuple(positions.shape)}, expected "
                         f"contiguous ({S},) or ({B}, {S})")
    for name, t in (("positions", positions), ("freqs", freqs)):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
    out = torch.empty((B, S, H, r2), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = build.load("rope_elite", _ARGTYPES)
    err = fn(x.data_ptr(), positions.data_ptr(), int(positions.dtype == torch.int64),
             freqs.data_ptr(), out.data_ptr(), B, S, H, r,
             x.stride(0), x.stride(1), x.stride(2),
             S if positions.dim() == 2 else 0, freqs.stride(0),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rope_elite launch failed: CUDA error {err}")
    rope_elite.launches += 1
    return out


rope_elite.launches = 0
