"""Causal GQA flash attention with per-lane offsets: the CUDA kernel.

Port of the JAX package's ``kernels/flash_prefill.py::flash_prefill``.  Key
``j`` is visible to query ``i`` of lane ``b`` iff ``j <= i + q_offsets[b]``
and ``j < kv_lens[b]``; query head ``h`` reads kv head ``h // G``.  Unlike
the TPU version, ``Sq`` and ``Sk`` need not be multiples of the tiles.  The
kernel source, with what bounds it and its design, is
``csrc/flash_prefill.cu``; the plain version is ``ref.flash_prefill_ref``.
``kernels.ops`` picks between them by the device of the inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)          # the instantiations in csrc/flash_prefill.cu
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                           ctypes.c_void_p]


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Launch the CUDA kernel.

    q [B,Sq,nh,dh], k/v [B,Sk,nkv,dh] f32, q_offsets/kv_lens [B] int32, all
    contiguous on one CUDA device; dh in ``HEAD_DIMS``.  → [B,Sq,nh,dh] f32.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_prefill kernel needs CUDA tensors, got {dev}")
    B, Sq, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    if B < 1 or Sq < 1 or nh != nkv * q_group or dh not in HEAD_DIMS:
        raise ValueError(f"bad geometry: B={B} Sq={Sq} nh={nh} nkv={nkv} "
                         f"G={q_group} dh={dh} (head dims {HEAD_DIMS})")
    f32, i32 = torch.float32, torch.int32
    build.check(q, "q", (B, Sq, nh, dh), f32, dev)
    build.check(k, "k", (B, Sk, nkv, dh), f32, dev)
    build.check(v, "v", (B, Sk, nkv, dh), f32, dev)
    build.check(q_offsets, "q_offsets", (B,), i32, dev)
    build.check(kv_lens, "kv_lens", (B,), i32, dev)
    out = torch.empty((B, Sq, nh, dh), dtype=f32, device=dev)
    fn = build.load("flash_prefill", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offsets.data_ptr(),
             kv_lens.data_ptr(), out.data_ptr(), B, Sq, Sk, nh, nkv, dh,
             scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
