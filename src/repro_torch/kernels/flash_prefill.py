"""Causal GQA flash attention with per-lane offsets: the CUDA kernel.

Port of the JAX package's ``kernels/flash_prefill.py::flash_prefill``.  Key
``j`` is visible to query ``i`` of lane ``b`` iff ``j <= i + q_offsets[b]``
and ``j < kv_lens[b]``; query head ``h`` reads kv head ``h // G``.  Unlike
the TPU version, ``Sq`` and ``Sk`` need not be multiples of the tiles.  The
kernel source, with what bounds it and its design, is
``csrc/flash_prefill.cu``; the plain version is ``ref.flash_prefill_ref``.
``kernels.ops`` picks between them by the device of the inputs.

One launch per call, through one of two bodies that ``plan`` picks from the
shapes alone (never from ``q_offsets`` or ``kv_lens``):

* ``decode``: at most ``DECODE_ROWS`` query rows per kv head (``G · Sq``),
  as in the baseline model's decode.  A CTA takes one (lane, kv head, range
  of ``RANGE_KEYS`` keys) and all the query rows that read that kv head;
  the last CTA of a (lane, kv head) merges the ranges' partials in
  ascending order (``ref.flash_split_ref`` is that arithmetic in plain
  PyTorch).  The ranges are fixed, so a lane's bits depend on neither the
  other lanes' ``kv_lens`` nor ``Sk``.  Partials and counters are per-device
  scratch that the wrapper allocates once and grows.
* ``prefill``: every other call; 64 query rows of one query head per CTA on
  the tensor cores (3xTF32).

On meta tensors (the dry run's prefill step) ``flash_prefill`` is its meta
version: the same checks, plan, scratch and output, no launch; it counts
the call's bytes and FLOPs (``prefill_cost``) in ``build.META_CALLS``.  A
meta tensor holds no offsets or lengths, so every lane's queries count as
the last ``Sq`` positions of its ``Sk`` keys (``q_offsets = Sk - Sq``,
``kv_lens = Sk``): a prefill from position 0, or a decode at index
``Sk - 1``, the most the call can need.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)          # the instantiations in csrc/flash_prefill.cu
#: query rows per kv head (G · Sq) up to which the decode body runs
DECODE_ROWS = 16
#: keys per range of the decode body (the source's kRangeKeys)
RANGE_KEYS = 128
#: query rows per CTA of the prefill body, and keys per K/V tile
PREFILL_ROWS, PREFILL_KEYS = 64, 32
BODIES = {"prefill": 0, "decode": 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                           ctypes.c_void_p]


class Plan(NamedTuple):
    """How one call is cut: ``body`` ("decode" or "prefill"); for the decode
    body ``ranges`` key ranges of ``RANGE_KEYS`` per (lane, kv head) and
    ``rows`` query rows per CTA, which size the partials."""
    body: str
    ranges: int
    rows: int


def plan(B: int, Sq: int, Sk: int, nh: int, nkv: int) -> Plan:
    """The plan of a call on q [B, Sq, nh, ·] and k/v [B, Sk, nkv, ·]."""
    G = nh // nkv
    if G * Sq <= DECODE_ROWS:
        ranges = max(1, -(-Sk // RANGE_KEYS))
        return Plan("decode", ranges, G * Sq)
    return Plan("prefill", 1, PREFILL_ROWS)


def plan_for(q, k, v, q_group: int, scale: float, q_offsets, kv_lens) -> Plan:
    """The plan of the call ``ops.flash_prefill(q, k, v, ...)``: read from
    the shapes of q and k only."""
    B, Sq, nh, _ = q.shape
    return plan(B, Sq, k.shape[1], nh, k.shape[2])


def smem_bytes(body: str, dh: int) -> int:
    """Shared memory per CTA of ``body`` at head dim ``dh``: the kernel
    source's layouts, in bytes."""
    if body == "decode":
        s, rows, tile = dh + 4, DECODE_ROWS, 32
        return 4 * (rows * dh + 4 * tile * s + rows * tile + 3 * rows + 4)
    return 4 * (PREFILL_ROWS + 4 * PREFILL_KEYS) * (dh + 4)


def smem_bytes_built(body: str, dh: int) -> int:
    """``smem_bytes`` as the compiled source computes it (needs the build)."""
    fn = build.load("flash_prefill_smem_bytes", [ctypes.c_int] * 2,
                    restype=ctypes.c_long, source="flash_prefill")
    return int(fn(BODIES[body], dh))


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Launch the CUDA kernel.

    q [B,Sq,nh,dh], k/v [B,Sk,nkv,dh] f32, q_offsets/kv_lens [B] int32, all
    contiguous on one CUDA device; dh in ``HEAD_DIMS``.  → [B,Sq,nh,dh] f32.
    On meta tensors, the meta version (module docstring).
    """
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_prefill kernel needs CUDA (or meta) tensors, got {dev}")
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
    p = plan(B, Sq, Sk, nh, nkv)
    n_part = B * nkv * p.ranges * p.rows * (dh + 2) if p.body == "decode" else 0
    part, cnt = build.scratch(dev, "flash_prefill", n_part, B * nkv)
    out = torch.empty((B, Sq, nh, dh), dtype=f32, device=dev)
    if dev.type == "meta":
        build.meta_call("flash_prefill", *prefill_cost(q, k, [Sk - Sq] * B, [Sk] * B))
        return out
    fn = build.load("flash_prefill", _ARGTYPES)
    build.launch("flash_prefill", fn,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offsets.data_ptr(),
                  kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                  B, Sq, Sk, nh, nkv, dh, BODIES[p.body], scale), q)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def visible_pairs(Sq: int, Sk: int, q_offset: int, kv_len: int) -> int:
    """(query, key) pairs one lane scores: query i sees keys
    j <= i + q_offset with j < min(kv_len, Sk) (``q_offset >= 0``)."""
    m = max(0, min(kv_len, Sk))
    n1 = max(0, min(Sq, m - q_offset))       # rows whose causal edge is inside
    return n1 * (q_offset + 1) + n1 * (n1 - 1) // 2 + (Sq - n1) * m


def prefill_cost(q, k, q_offsets, kv_lens):
    """(bytes, flops) of a call on q [B,Sq,nh,dh], k [B,Sk,nkv,dh] and the
    lanes' offsets and lengths (tensors or host lists): q and o whole, each
    lane's k/v rows below kv_len once; 4·dh flops per visible pair and
    head."""
    offs = q_offsets.tolist() if torch.is_tensor(q_offsets) else list(q_offsets)
    lens = kv_lens.tolist() if torch.is_tensor(kv_lens) else list(kv_lens)
    B, Sq, nh, dh = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    pairs = sum(visible_pairs(Sq, Sk, o, n) for o, n in zip(offs, lens))
    kv_rows = sum(min(n, Sk) for n in lens)
    nbytes = 4 * (2 * q.numel() + 2 * kv_rows * nkv * dh + 2 * B)
    return nbytes, pairs * nh * 4 * dh
