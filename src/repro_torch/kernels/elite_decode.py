"""Absorbed EliteKV decode and verify attention over the paged pool and
over a contiguous cache: the CUDA kernels.

Ports of the JAX package's ``kernels/elite_decode.py`` family.  Per
(lane, kv head) one pass over the lane's compressed cache computes

    s = (q_e · K_eᵀ + q_lat · C_kᵀ) · scale      over the visited rows
    o = softmax(s) · C_v

walking the pool in place, so nothing is gathered contiguously:

* ``elite_decode``                 a contiguous ``[B, S, ...]`` cache up to
  ``lengths``, read in tiles of ``CONTIG_TILE`` rows, as pages whose table
  is the identity (no table is built);
* ``elite_decode_paged``           f32 pages, the chain ``block_tables``
  up to ``lengths``;
* ``elite_decode_paged_q8``        int8 pages dequantized by their per-slot
  f32 scales as they are staged;
* ``elite_decode_sparse_paged``    f32 pages, a ``[B, W]`` selection
  ``sel_tables`` with per-block row counts ``sel_counts`` (0 skips);
* ``elite_decode_sparse_paged_q8`` the selection over int8 pages;
* ``elite_verify_paged``           speculative verify: ``W`` query positions
  per lane, row ``w`` at ``q_offsets + w`` masked offset-causally, f32 pages;
* ``elite_verify_paged_q8``        verify over int8 pages.

All seven are entries of one templated kernel, ``csrc/elite_decode_paged.cu``,
whose header says what bounds it and how it is built; the plain versions
are ``ref.elite_decode_ref``, ``ref.elite_decode_[sparse_]paged[_q8]_ref`` and
``ref.elite_verify_paged[_q8]_ref``.  ``kernels.ops`` picks between kernel
and plain version by the device of the inputs.  Each launcher counts its
launches in its ``launches`` attribute.  A call whose shared memory per CTA
exceeds the card's opt-in limit raises ``ValueError`` before launching.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SOURCE = "elite_decode_paged"
_SMEM_OPTIN: dict = {}
#: rows of a contiguous cache staged per barrier round: the paged pool's
#: block size, so that a contiguous call walks the rows in the tiles (and
#: gives the bits) of ``elite_decode_paged`` over the identity table
CONTIG_TILE = 16


def smem_bytes(window: int, q_group: int, block_size: int, r2: int, dc: int,
               shared_cv: bool) -> int:
    """Shared memory per CTA of a call (``window`` 1 for decode), from the
    kernel source's own formula."""
    fn = build.load("elite_decode_smem_bytes", [ctypes.c_int] * 6,
                    restype=ctypes.c_long, source=_SOURCE)
    return int(fn(window, q_group, block_size, r2, dc, int(shared_cv)))


def smem_optin_limit(device) -> int:
    """The card's opt-in limit of shared memory for one block, in bytes."""
    if device not in _SMEM_OPTIN:
        fn = build.load("elite_decode_smem_optin", [], source=_SOURCE)
        with torch.cuda.device(device):
            _SMEM_OPTIN[device] = int(fn())
    return _SMEM_OPTIN[device]


def _launch(symbol: str, q_e, q_lat, pages, scales, table, rows, q_group: int,
            scale: float, block_size: int, q_offsets=None) -> torch.Tensor:
    """Check every argument and launch entry ``symbol``.  ``pages`` is
    (k_e, c_k, c_v); ``scales`` () for f32 pages or the three [n_slots] f32
    scales of int8 pages; ``table`` [B, W] int32 and ``rows`` either
    ``lengths`` [B] (chain walk) or ``sel_counts`` [B, W] (selection).
    ``q_offsets`` [B] int32 makes it a verify call, whose q_e/q_lat and
    output carry a window axis: [B, W, nh, ·]."""
    dev = q_e.device
    if dev.type != "cuda":
        raise ValueError(f"{symbol} kernel needs CUDA tensors, got {dev}")
    k_e, c_k, c_v = pages
    verify = q_offsets is not None
    if verify:
        B, window, nh, r2 = q_e.shape
    else:
        (B, nh, r2), window = q_e.shape, 1
    lead = (B, window) if verify else (B,)
    n_slots, nkv = k_e.shape[0], k_e.shape[1]
    dc = c_k.shape[-1]
    width = table.shape[-1]
    if B < 1 or window < 1 or nh != nkv * q_group or n_slots % block_size:
        raise ValueError(f"bad geometry: B={B} W={window} nh={nh} nkv={nkv} "
                         f"G={q_group} n_slots={n_slots} block_size={block_size}")
    f32, i32 = torch.float32, torch.int32
    page_dtype = torch.int8 if scales else f32
    build.check(q_e, "q_e", lead + (nh, r2), f32, dev)
    build.check(q_lat, "q_lat", lead + (nh, dc), f32, dev)
    build.check(k_e, "k_e_pages", (n_slots, nkv, r2), page_dtype, dev)
    build.check(c_k, "c_k_pages", (n_slots, dc), page_dtype, dev)
    build.check(c_v, "c_v_pages", (n_slots, dc), page_dtype, dev)
    for name, s in zip(("k_e_scale", "c_k_scale", "c_v_scale"), scales):
        build.check(s, name, (n_slots,), f32, dev)
    sparse = "sparse" in symbol
    build.check(table, "sel_tables" if sparse else "block_tables", (B, width), i32, dev)
    build.check(rows, "sel_counts" if sparse else "lengths",
                (B, width) if sparse else (B,), i32, dev)
    walk = (table, rows)
    if verify:
        build.check(q_offsets, "q_offsets", (B,), i32, dev)
        walk = (table, q_offsets, rows)
    # as the kernel decides it: one latent tensor (and scale) staged once
    shared_cv = c_k.data_ptr() == c_v.data_ptr() and (
        not scales or scales[1].data_ptr() == scales[2].data_ptr())
    out = torch.empty(lead + (nh, dc), dtype=f32, device=dev)
    ints = (B, window, nkv, q_group, r2, dc, block_size, width) if verify else \
        (B, nkv, q_group, r2, dc, block_size, width)
    _call(symbol, (q_e, q_lat, k_e, c_k, c_v, *scales, *walk, out), ints, scale,
          window, q_group, block_size, r2, dc, shared_cv)
    return out


def _call(symbol: str, ptrs, ints, scale: float, window: int, q_group: int,
          block_size: int, r2: int, dc: int, shared_cv: bool) -> None:
    """Refuse a call whose shared memory per CTA exceeds the card's opt-in
    limit, then launch entry ``symbol`` with the tensors ``ptrs`` and the
    ints ``ints`` on the current stream."""
    dev = ptrs[0].device
    need = smem_bytes(window, q_group, block_size, r2, dc, shared_cv)
    limit = smem_optin_limit(dev)
    if need > limit:
        raise ValueError(f"{symbol}: {need} B of shared memory per CTA (window "
                         f"{window}, G={q_group}, 2r={r2}, d_c={dc}, block_size="
                         f"{block_size}) exceeds the card's opt-in limit of {limit} B")
    argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [
        ctypes.c_float, ctypes.c_void_p]
    fn = build.load(symbol, argtypes, source=_SOURCE)
    err = fn(*(t.data_ptr() for t in ptrs), *ints, scale,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                 scale: float) -> torch.Tensor:
    """q_e [B,nh,2r], q_lat [B,nh,dc], k_e [B,S,nkv,2r], c_k/c_v [B,S,dc]
    (the same tensor under J-LRD), all f32; lengths [B] int32; every tensor
    contiguous on one CUDA device.  Lane b attends its rows ``< lengths[b]``
    (all S for a longer length).  → o [B,nh,dc] f32; length-0 lanes give
    zeros."""
    dev = q_e.device
    if dev.type != "cuda":
        raise ValueError(f"elite_decode kernel needs CUDA tensors, got {dev}")
    B, nh, r2 = q_e.shape
    S, nkv = k_e.shape[1], k_e.shape[2]
    dc = c_k.shape[-1]
    if B < 1 or S < 1 or nh != nkv * q_group:
        raise ValueError(f"bad geometry: B={B} S={S} nh={nh} nkv={nkv} G={q_group}")
    f32 = torch.float32
    build.check(q_e, "q_e", (B, nh, r2), f32, dev)
    build.check(q_lat, "q_lat", (B, nh, dc), f32, dev)
    build.check(k_e, "k_e", (B, S, nkv, r2), f32, dev)
    build.check(c_k, "c_k", (B, S, dc), f32, dev)
    build.check(c_v, "c_v", (B, S, dc), f32, dev)
    build.check(lengths, "lengths", (B,), torch.int32, dev)
    out = torch.empty((B, nh, dc), dtype=f32, device=dev)
    _call("elite_decode", (q_e, q_lat, k_e, c_k, c_v, lengths, out),
          (B, S, nkv, q_group, r2, dc, CONTIG_TILE), scale, 1, q_group, CONTIG_TILE,
          r2, dc, c_k.data_ptr() == c_v.data_ptr())
    elite_decode.launches += 1
    return out


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """q_e [B,nh,2r], q_lat [B,nh,dc], k_e_pages [n_slots,nkv,2r],
    c_k/c_v_pages [n_slots,dc] (the same tensor under J-LRD), all f32;
    block_tables [B,mb] and lengths [B] int32; every tensor contiguous on
    one CUDA device.  → o [B,nh,dc] f32; length-0 lanes give zeros."""
    out = _launch("elite_decode_paged", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (), block_tables, lengths, q_group, scale, block_size)
    elite_decode_paged.launches += 1
    return out


def elite_decode_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, lengths,
                          q_group: int, scale: float, block_size: int) -> torch.Tensor:
    """``elite_decode_paged`` over int8 pages and their f32 scales
    [n_slots] (J-LRD: the same latent tensor and scale twice) → f32."""
    out = _launch("elite_decode_paged_q8", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (k_e_scale, c_k_scale, c_v_scale), block_tables, lengths,
                  q_group, scale, block_size)
    elite_decode_paged_q8.launches += 1
    return out


def elite_decode_sparse_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              sel_tables, sel_counts, q_group: int, scale: float,
                              block_size: int) -> torch.Tensor:
    """``elite_decode_paged`` over the selection sel_tables/sel_counts
    [B,W] int32 (physical block ids, rows per block) → o [B,nh,dc] f32;
    all-zero lanes give zeros."""
    out = _launch("elite_decode_sparse_paged", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (), sel_tables, sel_counts,
                  q_group, scale, block_size)
    elite_decode_sparse_paged.launches += 1
    return out


def elite_decode_sparse_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                 k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                 sel_counts, q_group: int, scale: float,
                                 block_size: int) -> torch.Tensor:
    """``elite_decode_sparse_paged`` over int8 pages and their scales → f32."""
    out = _launch("elite_decode_sparse_paged_q8", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (k_e_scale, c_k_scale, c_v_scale),
                  sel_tables, sel_counts, q_group, scale, block_size)
    elite_decode_sparse_paged_q8.launches += 1
    return out


def elite_verify_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, q_offsets, lengths, q_group: int,
                       scale: float, block_size: int) -> torch.Tensor:
    """Speculative verify: q_e [B,W,nh,2r], q_lat [B,W,nh,dc] f32, pages as
    in ``elite_decode_paged``, block_tables [B,mb], q_offsets [B] (position
    of each lane's window row 0) and lengths [B] (live length including the
    window) int32.  Row ``w`` sees positions ``<= q_offsets + w`` and
    ``< lengths``.  → o [B,W,nh,dc] f32; length-0 lanes give zeros."""
    out = _launch("elite_verify_paged", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (), block_tables, lengths, q_group, scale, block_size, q_offsets)
    elite_verify_paged.launches += 1
    return out


def elite_verify_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, q_offsets,
                          lengths, q_group: int, scale: float,
                          block_size: int) -> torch.Tensor:
    """``elite_verify_paged`` over int8 pages and their f32 scales → f32."""
    out = _launch("elite_verify_paged_q8", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (k_e_scale, c_k_scale, c_v_scale),
                  block_tables, lengths, q_group, scale, block_size, q_offsets)
    elite_verify_paged_q8.launches += 1
    return out


for _fn in (elite_decode, elite_decode_paged, elite_decode_paged_q8,
            elite_decode_sparse_paged, elite_decode_sparse_paged_q8,
            elite_verify_paged, elite_verify_paged_q8):
    _fn.launches = 0
