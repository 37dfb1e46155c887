"""Rotary embedding of q and k in one launch: the CUDA kernel.

Port of the JAX package's ``kernels/rope_elite.py::rope_elite``: each pair
of a head is rotated at angle ``pos · freqs[row, c]``, with cos/sin
computed in the kernel.  ``rope_elite_qk`` rotates a layer's q and k at the
same positions in one launch: query head ``h`` reads frequency row
``h // q_per_row``, key head ``h`` row ``h // k_per_row``, and each angle's
sincos is computed once for all the heads of its row.  ``rope_elite`` is
the TPU contract, one tensor with freqs ``[H, r]``, run by the same body
with no k.  Beyond that contract, positions may be ``[S]`` or per lane
``[B, S]`` (int32 or int64) and q, k may be strided views with a unit last
stride (the ``q[..., :2r]`` slice of a projection).  The kernel source,
with what bounds it, is ``csrc/rope_elite.cu``; the plain versions are
``ref.rope_elite_ref`` and ``ref.rope_elite_qk_ref``.  ``kernels.ops``
picks between them by the device of the query.

``rope_elite_backward`` is the same kernel in its transpose mode: it
rotates the outputs' gradients by the negated angles, which gives the
inputs' gradients (``ops`` wraps both entries in ``torch.autograd``
functions whose backward launches it).  It counts its launches apart, in
``rope_elite_backward.launches``.

``plan`` chooses the launch from shapes and alignment: 16-byte accesses
where every row start and stride allows them, else 8-byte ones; head
subsets of at most ``MAX_VECTORS`` heads per thread; a CTA of about
``CTA_THREADS`` threads over the tokens of one lane, its frequency rows cut
into row blocks where one token's rows need more than ``MAX_THREADS``
threads.  A CUDA tensor the kernel cannot take (a row start not 8-byte
aligned, an offset past 32 bits, one row needing more than
``MAX_THREADS`` threads) raises.

On meta tensors (the dry run's trace) the three entries are their meta
versions: the same checks and plan, the outputs allocated, no launch; each
call's bytes and FLOPs (``rope_cost``) go to ``build.META_CALLS`` under the
name a launch would count in (``rope_elite``, or ``rope_elite_backward``
in transpose mode).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

MAX_VECTORS = 9        # heads per thread (kMaxVectors in the source)
MAX_THREADS = 512      # threads per CTA (kMaxThreads)
CTA_THREADS = 256      # what a CTA aims at: tokens per CTA = this // per token
MAX_TOKENS_PER_CTA = 64          # blockDim.z's limit

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 20 + [ctypes.c_void_p])


class Plan(NamedTuple):
    vec: int               # pairs per access: 2 (16 bytes) or 1 (8 bytes)
    subsets: int           # threads that share one (token, row, vector)
    per_sub: int           # heads per thread
    block: Tuple[int, int, int]   # (vectors per row, rows per CTA x subsets, tokens)
    grid: Tuple[int, int]         # (token blocks, lanes)
    row_blocks: int = 1           # grid z: a token's rows cut across CTAs


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, r: int, rows: int, heads_per_row: int, aligned16: bool) -> Plan:
    """The launch for B lanes of S tokens, ``rows`` frequency rows of r
    pairs, each read by ``heads_per_row`` heads (q and k together).
    ``aligned16``: every input row start and stride is 16-byte aligned.
    A token's rows share one CTA when their threads fit in ``MAX_THREADS``,
    else they are cut into the fewest even row blocks that fit."""
    vec = 2 if aligned16 and r % 2 == 0 else 1
    subsets = -(-heads_per_row // MAX_VECTORS)
    per_sub = -(-heads_per_row // subsets)
    per_row = (r // vec) * subsets
    if per_row > MAX_THREADS:
        raise ValueError(f"rope_elite: {per_row} threads per token and row (r={r}, "
                         f"{subsets} subsets) exceed the CTA's {MAX_THREADS}")
    row_blocks = -(-rows // (MAX_THREADS // per_row))
    rpc = -(-rows // row_blocks)
    tz = max(1, min(MAX_TOKENS_PER_CTA, CTA_THREADS // (per_row * rpc), S))
    return Plan(vec, subsets, per_sub, (r // vec, rpc * subsets, tz), (-(-S // tz), B),
                row_blocks)


def access_bytes(*tensors) -> int:
    """16 if every tensor's start and every stride of an axis longer than
    one (but the last, which is 1) is 16-byte aligned, else 8 if they are
    8-byte aligned; raises otherwise."""
    best = 16
    for t in tensors:
        offs = [t.data_ptr()] + [4 * st for n, st in zip(t.shape[:-1], t.stride()[:-1])
                                 if n > 1]
        while best > 4 and any(o % best for o in offs):
            best //= 2
    if best < 8:
        raise ValueError("rope_elite: a row start or stride is not 8-byte aligned")
    return best


def plan_for(q, k, positions, freqs, q_per_row: int, k_per_row: int) -> Plan:
    """``plan`` for a call's arguments (k None: the one-tensor entry)."""
    B, S, _, r2 = q.shape
    inputs = (q,) if k is None else (q, k)
    return plan(B, S, r2 // 2, freqs.shape[0], q_per_row + k_per_row,
                access_bytes(*inputs) == 16)


def _check(name, t, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    if t.dim() != len(shape) or any(w is not None and n != w for n, w in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must have unit stride")
    span = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    if span >= 2**31:
        raise ValueError(f"{name}: offsets past 32 bits")


def _launch(q, k, positions, freqs, q_per_row: int, k_per_row: int,
            transpose: bool = False):
    """Check and launch; k is None for the one-tensor entry; ``transpose``
    rotates by the negated angles (the backward).  → (q_rot, k_rot)."""
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rope_elite kernel needs CUDA (or meta) tensors, got {dev}")
    if q.dim() != 4 or q.shape[-1] % 2:
        raise ValueError(f"q: shape {tuple(q.shape)}, expected [B, S, H, 2r]")
    B, S, Hq, r2 = q.shape
    rows, r = freqs.shape if freqs.dim() == 2 else (-1, -1)
    if r != r2 // 2 or q_per_row < 1 or k_per_row < 0 or rows * q_per_row != Hq:
        raise ValueError(f"freqs: shape {tuple(freqs.shape)} with {q_per_row} query "
                         f"heads per row, expected ({Hq // max(q_per_row, 1)}, {r2 // 2})")
    _check("q", q, (B, S, Hq, r2), dev)
    _check("freqs", freqs, (rows, r), dev)
    if k is not None:
        _check("k", k, (B, S, rows * k_per_row, r2), dev)
    if positions.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"positions: dtype {positions.dtype}, expected int32 or int64")
    if tuple(positions.shape) not in ((S,), (B, S)) or not positions.is_contiguous():
        raise ValueError(f"positions: shape {tuple(positions.shape)}, expected "
                         f"contiguous ({S},) or ({B}, {S})")
    if positions.device != dev:
        raise ValueError(f"positions: on {positions.device}, expected {dev}")
    if B > 65535:
        raise ValueError(f"rope_elite: {B} lanes exceed the grid's 65535")
    q_out = torch.empty((B, S, Hq, r2), dtype=torch.float32, device=dev)
    k_out = None if k is None else torch.empty(k.shape, dtype=torch.float32, device=dev)
    if q_out.numel() == 0:
        return q_out, k_out
    if max(q_out.numel(), 0 if k_out is None else k_out.numel()) >= 2**31:
        raise ValueError("rope_elite: outputs past 32-bit offsets")
    p = plan_for(q, k, positions, freqs, q_per_row, k_per_row)
    if dev.type == "meta":
        build.meta_call("rope_elite_backward" if transpose else "rope_elite",
                        *rope_cost((q, k, positions, freqs)))
        return q_out, k_out
    kst = k.stride()[:3] if k is not None else (0, 0, 0)
    fn = build.load("rope_elite_qk", _ARGTYPES, source="rope_elite")
    name = ("rope_elite" if k is None else "rope_elite_qk") + ("_backward" if transpose else "")
    build.launch(name, fn,
                 (q.data_ptr(), 0 if k is None else k.data_ptr(), positions.data_ptr(),
                  int(positions.dtype == torch.int64), freqs.data_ptr(), q_out.data_ptr(),
                  0 if k_out is None else k_out.data_ptr(), p.vec, B, S, r, rows,
                  q_per_row, k_per_row, p.subsets, p.per_sub, p.block[2],
                  p.block[1] // p.subsets,
                  *q.stride()[:3], *kst, S if positions.dim() == 2 else 0,
                  freqs.stride(0), int(transpose)), q)
    if transpose:
        rope_elite_backward.launches += 1
    else:
        rope_elite.launches += 1
    return q_out, k_out


def rope_elite_qk(q, k, positions, freqs, q_per_row: int, k_per_row: int):
    """Launch the CUDA kernel on q and k together.

    q [B,S,Hq,2r] and k [B,S,Hk,2r] f32, each with ``stride(-1) == 1``;
    positions [S] or [B,S] int32/int64, contiguous; freqs [R,r] f32 with a
    unit last stride, Hq = R·q_per_row, Hk = R·k_per_row; all on one CUDA
    device.  → (q_rot, k_rot), contiguous f32.  Counts one launch in
    ``rope_elite.launches``.
    """
    if k_per_row < 1:
        raise ValueError(f"k_per_row {k_per_row}: expected >= 1")
    return _launch(q, k, positions, freqs, q_per_row, k_per_row)


def one_tensor_rows(x, freqs):
    """(frequency rows, heads per row) of the one-tensor entry: freqs
    [H, r] whose head stride is 0 broadcast one row, which all H heads
    read; else one row per head."""
    if x.dim() == 4 and freqs.dim() == 2 and freqs.shape[0] == x.shape[2] > 1 \
            and freqs.stride(0) == 0:
        return freqs[:1], x.shape[2]
    return freqs, 1


def rope_elite(x, positions, freqs) -> torch.Tensor:
    """Launch the CUDA kernel on one tensor (the TPU contract).

    x [B,S,H,2r] f32 with ``x.stride(-1) == 1``; positions [S] or [B,S]
    int32/int64, contiguous; freqs [H,r] f32 with a unit last stride (head
    stride 0 broadcasts one row, whose sincos the heads then share); all on
    one CUDA device.  → contiguous [B,S,H,2r] f32.
    """
    rows, per_row = one_tensor_rows(x, freqs)
    return _launch(x, None, positions, rows, per_row, 0)[0]


def rope_elite_backward(g_q, g_k, positions, freqs, q_per_row: int, k_per_row: int):
    """Launch the kernel in its transpose mode: the gradients of the
    rotation's inputs from those of its outputs, g_q [B,S,Hq,2r] and g_k
    [B,S,Hk,2r] (None with ``k_per_row = 0``: the one-tensor entry, whose
    freqs come through ``one_tensor_rows``), under ``rope_elite_qk``'s
    contract.  → (g_q_in, g_k_in), contiguous f32.  Counts one launch in
    ``rope_elite_backward.launches``."""
    if (g_k is None) != (k_per_row == 0):
        raise ValueError(f"k_per_row {k_per_row}: expected 0 exactly when g_k is None")
    return _launch(g_q, g_k, positions, freqs, q_per_row, k_per_row, transpose=True)


rope_elite.launches = 0
rope_elite_backward.launches = 0


def rope_cost(a):
    """(bytes, flops) of a rotation on (q, k, positions, freqs, ...), k None
    for the one-tensor entry: q and k read and their outputs written once,
    the positions and the freq rows once; 6 flops per rotated pair (4
    products, a sum and a difference) and 3 per distinct angle (the angle,
    one sincos counted as two)."""
    q, k, pos, freqs = a[:4]
    n = q.numel() + (0 if k is None else k.numel())
    tokens = q.shape[0] * q.shape[1]
    return (8 * n + pos.numel() * pos.element_size() + 4 * freqs.numel(),
            3 * n + 3 * tokens * freqs.numel())
