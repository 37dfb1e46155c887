"""Absorbed EliteKV decode attention over the paged pool: the CUDA kernel.

Port of the JAX package's ``kernels/elite_decode.py::elite_decode_paged``.
Per (lane, kv head) one pass over the lane's compressed cache computes

    s = (q_e · K_eᵀ + q_lat · C_kᵀ) · scale      masked at pos >= lengths[b]
    o = softmax(s) · C_v

walking the block table, so the sequence is never gathered contiguously.
The kernel source, with what bounds it and its design, is
``csrc/elite_decode_paged.cu``; the plain version is
``ref.elite_decode_paged_ref``.  ``kernels.ops`` picks between them by the
device of the inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                           ctypes.c_void_p]


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Launch the CUDA kernel.

    q_e [B,nh,2r], q_lat [B,nh,dc], k_e_pages [n_slots,nkv,2r],
    c_k/c_v_pages [n_slots,dc] (the same tensor under J-LRD), all f32;
    block_tables [B,mb] and lengths [B] int32; every tensor contiguous on
    one CUDA device.  → o [B,nh,dc] f32; length-0 lanes give zeros.
    """
    dev = q_e.device
    if dev.type != "cuda":
        raise ValueError(f"elite_decode_paged kernel needs CUDA tensors, got {dev}")
    B, nh, r2 = q_e.shape
    n_slots, nkv = k_e_pages.shape[0], k_e_pages.shape[1]
    dc = c_k_pages.shape[-1]
    mb = block_tables.shape[-1]
    if B < 1 or nh != nkv * q_group or n_slots % block_size:
        raise ValueError(f"bad geometry: B={B} nh={nh} nkv={nkv} G={q_group} "
                         f"n_slots={n_slots} block_size={block_size}")
    f32, i32 = torch.float32, torch.int32
    build.check(q_e, "q_e", (B, nh, r2), f32, dev)
    build.check(q_lat, "q_lat", (B, nh, dc), f32, dev)
    build.check(k_e_pages, "k_e_pages", (n_slots, nkv, r2), f32, dev)
    build.check(c_k_pages, "c_k_pages", (n_slots, dc), f32, dev)
    build.check(c_v_pages, "c_v_pages", (n_slots, dc), f32, dev)
    build.check(block_tables, "block_tables", (B, mb), i32, dev)
    build.check(lengths, "lengths", (B,), i32, dev)
    out = torch.empty((B, nh, dc), dtype=f32, device=dev)
    fn = build.load("elite_decode_paged", _ARGTYPES)
    err = fn(q_e.data_ptr(), q_lat.data_ptr(), k_e_pages.data_ptr(),
             c_k_pages.data_ptr(), c_v_pages.data_ptr(), block_tables.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), B, nkv, q_group, r2, dc,
             block_size, mb, scale, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"elite_decode_paged launch failed: CUDA error {err}")
    elite_decode_paged.launches += 1
    return out


elite_decode_paged.launches = 0
