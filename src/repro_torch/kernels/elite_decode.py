"""Absorbed EliteKV decode and verify attention over the paged pool and
over a contiguous cache: the CUDA kernels.

Ports of the JAX package's ``kernels/elite_decode.py`` family.  Per lane
and query row, over the lane's compressed cache,

    s = (q_e · K_eᵀ + q_lat · C_kᵀ) · scale      over the visited rows
    o = softmax(s) · C_v

walking the pool in place, so nothing is gathered contiguously:

* ``elite_decode``                 a contiguous ``[B, S, ...]`` cache up to
  ``lengths``, read in tiles of ``CONTIG_TILE`` rows, as pages whose table
  is the identity (no table is built); with ``return_lse`` it also writes
  each row's log-sum-exp, which merges pieces of a sequence-sharded cache
  (``kernels/ops.py``, ``ref.merge_lse``);
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
launches in its ``launches`` attribute.

Each call is planned on the host (``plan_for``) from shapes alone: kv heads
per CTA by shared memory, tiles in flight, and split-KV ranges of the walk
of a fixed size per model width and card (never by ``lengths``, the batch
or the walk's width, so nothing is read back from the card and a lane's
bits do not depend on the other lanes); the kernel merges the ranges'
partials itself, in the last CTA of each (lane, head group), using
per-device scratch that the wrapper allocates once and grows.  Calls on
one device are ordered by their stream.  A verify window whose rows for one
kv head do not fit the card's opt-in shared memory is cut into parts of
fewer window positions, each part its own CTAs in the same launch, with the
uncut call's walk, ranges and per-row arithmetic; only a window of which
one position does not fit raises ``ValueError`` before launching.
``ref.split_call_ref`` is the plan's arithmetic in plain PyTorch.

``elite_decode`` on meta tensors is its meta version (the dry run's decode
step): the same checks, plan (for the target card of ``build``), scratch
and output, no launch; it counts the call's bytes and FLOPs
(``contig_decode_cost``) in ``build.META_CALLS``.  A meta tensor holds no
lengths, so it counts every lane's whole cache: the walk of the dry run's
decode at index S - 1, the most the call can need.  The paged and verify
entries take CUDA tensors only.  ``decode_cost`` and
``contig_decode_cost`` are the bytes and FLOPs of a call on its inputs,
which ``chip_smoke.py``'s bounds read too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_SOURCE = "elite_decode_paged"
_SMEM_OPTIN: dict = {}
_SM_COUNT: dict = {}
_ENTRIES: dict = {}
#: rows of a contiguous cache staged per tile: the paged pool's block size,
#: so that a contiguous call walks the rows in the tiles (and gives the bits)
#: of ``elite_decode_paged`` over the identity table
CONTIG_TILE = 16
#: CTAs a plan aims at per SM of the card, on the reference load
CTAS_PER_SM = 2
#: the load a plan's ranges are sized for: lanes, and tiles per lane (8
#: lanes of 1,024 rows in tiles of 16); see ``split_plan``
REF_LANES, REF_TILES = 8, 64


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _odd_quads(x: int) -> int:
    return 4 * ((_round4(x) // 4) | 1)


def smem_bytes(window: int, q_group: int, heads: int, block_size: int, r2: int,
               dc: int, shared_cv: bool, q8: bool = False, stages: int = 2) -> int:
    """Shared memory per CTA of a call (``window`` 1 for decode) whose CTAs
    hold ``heads`` kv heads, with ``stages`` tiles in flight: the kernel
    source's ``make_layout``, in bytes."""
    R, bs, lat = window * q_group * heads, block_size, 1 if shared_cv else 2
    ks, cs = _odd_quads(heads * r2), _odd_quads(dc)
    rows = _round4(R * r2) + 2 * _round4(R * dc) + _round4(R * bs) + 3 * _round4(R) + 4
    tile = bs * (ks + lat * cs)
    raw = (bs * (_round16(heads * r2) + lat * _round16(dc)) + 12 * _round4(bs)) // 4
    floats = rows + (tile + stages * raw if q8 else stages * tile)
    return 4 * floats


def smem_bytes_built(window: int, q_group: int, heads: int, block_size: int, r2: int,
                     dc: int, shared_cv: bool, q8: bool, stages: int) -> int:
    """``smem_bytes`` as the compiled kernel source computes it (needs the
    build): a check that the two agree."""
    fn = build.load("elite_decode_smem_bytes", [ctypes.c_int] * 9,
                    restype=ctypes.c_long, source=_SOURCE)
    return int(fn(window, q_group, heads, block_size, r2, dc, int(shared_cv), int(q8),
                  stages))


def smem_optin_limit(device) -> int:
    """The card's opt-in limit of shared memory for one block, in bytes
    (the target card's for the meta device)."""
    if device.type == "meta":
        return build.TARGET_SMEM_OPTIN
    if device not in _SMEM_OPTIN:
        fn = build.load("elite_decode_smem_optin", [], source=_SOURCE)
        with torch.cuda.device(device):
            _SMEM_OPTIN[device] = int(fn())
    return _SMEM_OPTIN[device]


def sm_count(device) -> int:
    if device.type == "meta":
        return build.TARGET_SMS
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[device]


class Plan(NamedTuple):
    """How one call is cut: ``heads`` kv heads per CTA in ``groups`` head
    groups, ``stages`` tiles in flight, the window in ``parts`` parts of
    ``part`` positions (1 and 1 for decode; one part unless one kv head's
    rows of the whole window do not fit), each lane's walk of ``n_tiles``
    tiles in ``splits`` ranges of ``tiles_per_split``; ``ctas`` CTAs of
    ``smem`` bytes of shared memory."""
    heads: int
    groups: int
    stages: int
    splits: int
    tiles_per_split: int
    ctas: int
    smem: int
    part: int = 1
    parts: int = 1


def head_group(window: int, q_group: int, nkv: int, block_size: int, r2: int, dc: int,
               shared_cv: bool, q8: bool, limit: int):
    """(kv heads per CTA, stages, bytes) for CTAs of ``window`` positions:
    the largest divisor of ``nkv`` whose CTA fits ``limit`` bytes with two
    tiles in flight, else with one; None if one kv head does not fit."""
    heads = [h for h in range(nkv, 0, -1) if nkv % h == 0]
    for stages in (2, 1):
        for h in heads:
            need = smem_bytes(window, q_group, h, block_size, r2, dc, shared_cv, q8, stages)
            if need <= limit:
                return h, stages, need
    return None


def window_parts(window: int, q_group: int, nkv: int, block_size: int, r2: int, dc: int,
                 shared_cv: bool, q8: bool, limit: int, symbol: str = "elite_decode",
                 part: int = 0):
    """(kv heads per CTA, stages, bytes, window positions per CTA).  The
    whole window when one kv head's rows of it fit (``head_group``); else
    the window cut into the fewest parts of ``ceil(window / n)`` positions
    that fit, heads and stages sized again for a part.  ``part`` forces a
    cut of an uncut call into parts of that many positions, with the uncut
    call's heads and stages (so its ranges, and its bits, are the uncut
    call's).  A window of which one position of one kv head does not fit
    raises ``ValueError``."""
    fit = head_group(window, q_group, nkv, block_size, r2, dc, shared_cv, q8, limit)
    if fit is not None:
        heads, stages, need = fit
        if not 0 < part < window:
            return heads, stages, need, window
        return heads, stages, smem_bytes(part, q_group, heads, block_size, r2, dc,
                                         shared_cv, q8, stages), part
    sizes = [part] if part else sorted({-(-window // n) for n in range(2, window + 1)},
                                       reverse=True)
    for size in sizes:
        fit = head_group(size, q_group, nkv, block_size, r2, dc, shared_cv, q8, limit)
        if fit is not None:
            return (*fit, size)
    need = smem_bytes(1, q_group, 1, block_size, r2, dc, shared_cv, q8, 1)
    raise ValueError(f"{symbol}: a window of {window} positions cannot be cut to fit: "
                     f"{need} B of shared memory per CTA for one position (G={q_group}, "
                     f"one kv head, 2r={r2}, d_c={dc}, block_size={block_size}) exceeds "
                     f"the card's opt-in limit of {limit} B")


def split_plan(groups: int, n_tiles: int, target_ctas: int, max_splits: int):
    """(splits, tiles per split) of a walk ``n_tiles`` tiles wide.  Tiles per
    split come from the head groups and the card alone: as many as give
    ``target_ctas`` CTAs on the reference load of ``REF_LANES`` lanes of
    ``REF_TILES`` tiles.  Neither the batch nor the walk's width (the step's
    longest chain, which the other lanes set) plays a part, so a lane's
    ranges, and so its bits, depend on its own length only: a wider walk
    adds ranges past the lane's end, whose empty partials the merge skips
    exactly.  Only a walk wider than ``tiles per split · max_splits`` (the
    merge keeps a weight per row and split in shared memory) takes longer
    ranges, as few as fit.  Lengths play no part."""
    tps = max(1, -(-REF_LANES * groups * REF_TILES // target_ctas))
    if n_tiles > tps * max_splits:
        tps = -(-n_tiles // max_splits)
    return max(1, -(-n_tiles // tps)), tps


@functools.lru_cache(maxsize=None)
def plan(B: int, window: int, q_group: int, nkv: int, block_size: int, r2: int, dc: int,
         shared_cv: bool, q8: bool, n_tiles: int, sms: int, limit: int,
         symbol: str = "elite_decode", part: int = 0, split_nkv: int = 0) -> Plan:
    """The plan of one call: head groups (and window parts, where one kv
    head's rows of the whole window do not fit) by shared memory
    (``window_parts``), then the walk's width (``mb``, the selection's
    ``W`` or ``ceil(S / 16)``) cut into ranges sized for ``CTAS_PER_SM``
    CTAs per SM on the reference load, at most ``dc`` splits
    (``split_plan``: the range size depends on neither ``B``, the width nor
    the window's parts).  ``part`` forces a cut (see ``window_parts``).
    ``split_nkv`` (a head shard's call: the unsharded call's kv heads)
    sizes the ranges from that call's head groups instead of this one's, so
    that each shard walks the unsharded call's ranges and merges its
    partials in its order: the shard's bits are the unsharded call's.
    Raises ``ValueError`` for widths the kernel does not take.  Memoized: a
    serving step asks for the same few plans in every layer."""
    if r2 % 4 or dc % 4 or not 1 <= block_size <= 32:
        raise ValueError(f"{symbol}: needs 2r and d_c multiples of 4 and a tile of at most "
                         f"32 rows, got 2r={r2} d_c={dc} block_size={block_size}")
    heads, stages, need, size = window_parts(window, q_group, nkv, block_size, r2, dc,
                                             shared_cv, q8, limit, symbol, part)
    groups, parts = nkv // heads, -(-window // size)
    split_groups = groups
    if split_nkv and split_nkv != nkv:
        split_groups = split_nkv // window_parts(window, q_group, split_nkv, block_size, r2,
                                                 dc, shared_cv, q8, limit, symbol, part)[0]
    splits, tps = split_plan(split_groups, n_tiles, sms * CTAS_PER_SM, dc)
    return Plan(heads, groups, stages, splits, tps, B * groups * parts * splits, need,
                size, parts)


def shares(a, b) -> bool:
    """Whether two tensors are one (J-LRD passes its latent as c_k and
    c_v): the same start address, or on meta, where none has an address,
    the same storage and offset."""
    if a.is_meta:
        return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
                and a.storage_offset() == b.storage_offset())
    return a.data_ptr() == b.data_ptr()


def plan_for(name: str, args, sms: int, limit: int, part: int = 0,
             split_nkv: int = 0) -> Plan:
    """The plan of the call ``ops.<name>(*args)`` (a decode or verify entry)
    on a card of ``sms`` SMs and ``limit`` bytes of opt-in shared memory per
    block; ``part`` forces a verify window's cut, ``split_nkv`` sizes a head
    shard's ranges (``plan``)."""
    q_e, _, k_e, c_k, c_v = args[:5]
    q8 = name.endswith("_q8")
    scales = args[5:8] if q8 else ()
    r2, dc = k_e.shape[-1], c_k.shape[-1]
    shared_cv = shares(c_k, c_v) and (not q8 or shares(scales[1], scales[2]))
    if name == "elite_decode":
        (B, S, nkv), G = k_e.shape[:3], args[6]
        window, bs, n_tiles = 1, CONTIG_TILE, -(-S // CONTIG_TILE)
    else:
        B, nkv, G, bs = q_e.shape[0], k_e.shape[1], args[-3], args[-1]
        window = q_e.shape[1] if "verify" in name else 1
        n_tiles = args[8 if q8 else 5].shape[-1]
    return plan(B, window, G, nkv, bs, r2, dc, shared_cv, q8, n_tiles, sms, limit, name,
                part, split_nkv)


def _launch(symbol: str, q_e, q_lat, pages, scales, table, rows, q_group: int,
            scale: float, block_size: int, q_offsets=None, part: int = 0,
            split_nkv: int = 0) -> torch.Tensor:
    """Check every argument and launch entry ``symbol``.  ``pages`` is
    (k_e, c_k, c_v); ``scales`` () for f32 pages or the three [n_slots] f32
    scales of int8 pages; ``table`` [B, W] int32 and ``rows`` either
    ``lengths`` [B] (chain walk) or ``sel_counts`` [B, W] (selection).
    ``q_offsets`` [B] int32 makes it a verify call, whose q_e/q_lat and
    output carry a window axis: [B, W, nh, ·]; ``part`` forces its window
    cut into parts of that many positions; ``split_nkv`` plans a head
    shard's ranges as the unsharded call's (``plan``)."""
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
    shared_cv = c_k.data_ptr() == c_v.data_ptr() and (
        not scales or scales[1].data_ptr() == scales[2].data_ptr())
    p = plan(B, window, q_group, nkv, block_size, r2, dc, shared_cv, bool(scales), width,
             sm_count(dev), smem_optin_limit(dev), symbol, part, split_nkv)
    out = torch.empty(lead + (nh, dc), dtype=f32, device=dev)
    ints = (B, window, nkv, q_group, r2, dc, block_size, width) if verify else \
        (B, nkv, q_group, r2, dc, block_size, width)
    _call(symbol, (q_e, q_lat, k_e, c_k, c_v, *scales, *walk, out), ints, scale, p,
          p.part * q_group * p.heads, dc)
    return out


def _call(symbol: str, ptrs, ints, scale: float, p: Plan, R: int, dc: int) -> None:
    """Launch entry ``symbol`` by the plan ``p`` (``R`` query rows in a
    CTA's part of the window) with the tensors ``ptrs`` (None passes a null
    pointer), the scratch, the ints ``ints`` and the plan on the current
    stream."""
    dev = ptrs[0].device
    for t in ptrs:
        if t is not None and t.data_ptr() % 4:
            raise ValueError(f"{symbol}: a {t.dtype} argument is not 4-byte aligned")
    B = ints[0]
    units = B * p.groups * p.parts
    partials, cnt = build.scratch(dev, "elite_decode", units * p.splits * R * (dc + 2), units)
    if dev.type == "meta":
        return
    fn = _ENTRIES.get(symbol)
    if fn is None:
        argtypes = [ctypes.c_void_p] * (len(ptrs) + 2) + [ctypes.c_int] * (len(ints) + 5) + [
            ctypes.c_float, ctypes.c_void_p]
        fn = _ENTRIES[symbol] = build.load(symbol, argtypes, source=_SOURCE)
    build.launch(symbol, fn, (*(None if t is None else t.data_ptr() for t in ptrs),
                              partials.data_ptr(),
                              cnt.data_ptr(), *ints, p.heads, p.splits,
                              p.tiles_per_split, p.stages, p.part, scale), ptrs[0])


def elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                 scale: float, return_lse: bool = False):
    """q_e [B,nh,2r], q_lat [B,nh,dc], k_e [B,S,nkv,2r], c_k/c_v [B,S,dc]
    (the same tensor under J-LRD), all f32; lengths [B] int32; every tensor
    contiguous on one CUDA device.  Lane b attends its rows ``< lengths[b]``
    (all S for a longer length; none for a length <= 0).  → o [B,nh,dc]
    f32; length-0 lanes give zeros.  ``return_lse`` → (o, lse [B,nh] f32),
    each row's natural log-sum-exp of its scaled scores (-inf for a lane
    with no row), written by the same launch; o's bits do not change with
    it.  On meta tensors, the meta version (module docstring)."""
    dev = q_e.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"elite_decode kernel needs CUDA (or meta) tensors, got {dev}")
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
    p = plan(B, 1, q_group, nkv, CONTIG_TILE, r2, dc, shares(c_k, c_v),
             False, -(-S // CONTIG_TILE), sm_count(dev), smem_optin_limit(dev),
             "elite_decode")
    out = torch.empty((B, nh, dc), dtype=f32, device=dev)
    lse = torch.empty((B, nh), dtype=f32, device=dev) if return_lse else None
    _call("elite_decode", (q_e, q_lat, k_e, c_k, c_v, lengths, out, lse),
          (B, S, nkv, q_group, r2, dc, CONTIG_TILE), scale, p, q_group * p.heads, dc)
    if dev.type == "meta":
        build.meta_call("elite_decode", *contig_decode_cost(
            (q_e, q_lat, k_e, c_k, c_v, lengths), rows=B * S, lse=return_lse))
    else:
        elite_decode.launches += 1
    return (out, lse) if return_lse else out


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """q_e [B,nh,2r], q_lat [B,nh,dc], k_e_pages [n_slots,nkv,2r],
    c_k/c_v_pages [n_slots,dc] (the same tensor under J-LRD), all f32;
    block_tables [B,mb] and lengths [B] int32; every tensor contiguous on
    one CUDA device.  → o [B,nh,dc] f32; length-0 lanes give zeros.
    ``split_nkv``: a head shard's call, planned as the unsharded call of
    that many kv heads (``plan``); every entry below takes it."""
    out = _launch("elite_decode_paged", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (), block_tables, lengths, q_group, scale, block_size,
                  split_nkv=split_nkv)
    elite_decode_paged.launches += 1
    return out


def elite_decode_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, lengths,
                          q_group: int, scale: float, block_size: int,
                          split_nkv: int = 0) -> torch.Tensor:
    """``elite_decode_paged`` over int8 pages and their f32 scales
    [n_slots] (J-LRD: the same latent tensor and scale twice) → f32."""
    out = _launch("elite_decode_paged_q8", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (k_e_scale, c_k_scale, c_v_scale), block_tables, lengths,
                  q_group, scale, block_size, split_nkv=split_nkv)
    elite_decode_paged_q8.launches += 1
    return out


def elite_decode_sparse_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              sel_tables, sel_counts, q_group: int, scale: float,
                              block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """``elite_decode_paged`` over the selection sel_tables/sel_counts
    [B,W] int32 (physical block ids, rows per block) → o [B,nh,dc] f32;
    all-zero lanes give zeros."""
    out = _launch("elite_decode_sparse_paged", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (), sel_tables, sel_counts,
                  q_group, scale, block_size, split_nkv=split_nkv)
    elite_decode_sparse_paged.launches += 1
    return out


def elite_decode_sparse_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                 k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                 sel_counts, q_group: int, scale: float,
                                 block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """``elite_decode_sparse_paged`` over int8 pages and their scales → f32."""
    out = _launch("elite_decode_sparse_paged_q8", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (k_e_scale, c_k_scale, c_v_scale),
                  sel_tables, sel_counts, q_group, scale, block_size, split_nkv=split_nkv)
    elite_decode_sparse_paged_q8.launches += 1
    return out


def elite_verify_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, q_offsets, lengths, q_group: int,
                       scale: float, block_size: int, part: int = 0,
                       split_nkv: int = 0) -> torch.Tensor:
    """Speculative verify: q_e [B,W,nh,2r], q_lat [B,W,nh,dc] f32, pages as
    in ``elite_decode_paged``, block_tables [B,mb], q_offsets [B] (position
    of each lane's window row 0) and lengths [B] (live length including the
    window) int32.  Row ``w`` sees positions ``<= q_offsets + w`` and
    ``< lengths``.  → o [B,W,nh,dc] f32; length-0 lanes give zeros.
    ``part`` (a check's knob) forces the window's cut into parts of that
    many positions; the plan cuts by itself where it must."""
    out = _launch("elite_verify_paged", q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                  (), block_tables, lengths, q_group, scale, block_size, q_offsets, part,
                  split_nkv)
    elite_verify_paged.launches += 1
    return out


def elite_verify_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, q_offsets,
                          lengths, q_group: int, scale: float,
                          block_size: int, part: int = 0,
                          split_nkv: int = 0) -> torch.Tensor:
    """``elite_verify_paged`` over int8 pages and their f32 scales → f32."""
    out = _launch("elite_verify_paged_q8", q_e, q_lat,
                  (k_e_pages, c_k_pages, c_v_pages), (k_e_scale, c_k_scale, c_v_scale),
                  block_tables, lengths, q_group, scale, block_size, q_offsets, part,
                  split_nkv)
    elite_verify_paged_q8.launches += 1
    return out


for _fn in (elite_decode, elite_decode_paged, elite_decode_paged_q8,
            elite_decode_sparse_paged, elite_decode_sparse_paged_q8,
            elite_verify_paged, elite_verify_paged_q8):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# bytes and FLOPs of a call (the bounds of chip_smoke.py and the dry run)
# ---------------------------------------------------------------------------
# A decode or verify call is the argument tuple ``ops.<name>`` takes:
# (q_e, q_lat, k_e, c_k, c_v, [k_e_scale, c_k_scale, c_v_scale,] table,
#  [q_offsets,] rows, q_group, scale, block_size) — table/rows are
# block_tables/lengths for the chain and verify entries and
# sel_tables/sel_counts for the sparse ones; q_offsets only for verify.

def split_decode(name: str, a):
    """→ (q_e, q_lat, pages, scales, table, q_offsets or None, rows, G, bs)."""
    n = 8 if name.endswith("q8") else 5
    if "verify" in name:
        return a[0], a[1], a[2:5], a[5:n], a[n], a[n + 1], a[n + 2], a[n + 3], a[n + 5]
    return a[0], a[1], a[2:5], a[5:n], a[n], None, a[n + 1], a[n + 2], a[n + 4]


def visited_rows(name: str, a) -> int:
    """Pool rows the call's walk visits: live lengths (chain, verify) or the
    sum of the selected blocks' counts (selection)."""
    *_, table, _, rows, _, bs = split_decode(name, a)
    if "sparse" in name:
        return int(rows.clamp(0, bs).sum())
    return int(rows.clamp(max=table.shape[1] * bs).sum())


def scored_pairs(name: str, a) -> int:
    """(query position, pool row) pairs the call scores: one per visited row
    for decode; for verify, row w of a lane sees min(q_offset + w + 1,
    length) rows (a padding row past the lane's window sees them all)."""
    if "verify" not in name:
        return visited_rows(name, a)
    q_e, *_, table, offs, rows, _, bs = split_decode(name, a)
    lens = rows.clamp(max=table.shape[1] * bs).tolist()
    W = q_e.shape[1]
    return sum(min(o + w + 1, n) for o, n in zip(offs.tolist(), lens) if n
               for w in range(W))


def decode_cost(name: str, a):
    """(bytes, flops) the call needs on these inputs: every input read once —
    only the visited rows of the pages, plus their per-slot scales — and the
    output written once; the flops of every scored (query, row) pair."""
    q_e, q_lat, (k_e, c_k, c_v), scales, table, offs, rows, G, bs = split_decode(name, a)
    nh, r2 = q_e.shape[-2:]
    dc = c_k.shape[-1]
    nkv = nh // G
    live = visited_rows(name, a)
    lat = 1 if c_v is c_k else 2
    per_row = k_e.element_size() * (nkv * r2 + lat * dc) + 4 * len(set(
        s.data_ptr() for s in scales))
    extra = 0 if offs is None else offs.numel()
    # q_e, q_lat and the output (q_lat's shape), the walk's int32 arrays
    nbytes = (4 * (q_e.numel() + 2 * q_lat.numel() + table.numel() + rows.numel()
                   + extra) + live * per_row)
    flops = scored_pairs(name, a) * nh * (2 * (r2 + dc) + 2 * dc)
    return nbytes, flops


def contig_decode_cost(a, rows=None, lse: bool = False):
    """(bytes, flops) of ``elite_decode`` on its argument tuple (q_e, q_lat,
    k_e, c_k, c_v, lengths, ...): q_e, q_lat and the output once (and the
    [B, nh] log-sum-exp with ``lse``), each lane's rows below its length
    once (``rows`` of them in all, read from ``lengths`` unless given); the
    flops of every scored row."""
    q_e, q_lat, k_e, c_k, c_v, lengths = a[:6]
    B, nh, r2 = q_e.shape
    S, nkv, dc = k_e.shape[1], k_e.shape[2], c_k.shape[-1]
    if rows is None:
        rows = int(lengths.clamp(0, S).sum())
    lat = 1 if shares(c_k, c_v) else 2
    nbytes = (4 * (q_e.numel() + 2 * q_lat.numel() + B + (B * nh if lse else 0))
              + rows * 4 * (nkv * r2 + lat * dc))
    return nbytes, rows * nh * (2 * (r2 + dc) + 2 * dc)
