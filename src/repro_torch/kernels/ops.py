"""Dispatch for the attention and rotary kernels, with their launch counts.

A call whose query (``x`` for ``rope_elite``, ``q`` for ``rope_elite_qk``)
lies on a CUDA device launches the hand-written kernel (which raises on
anything it does not take); a call on the CPU runs the plain PyTorch
version.  Nothing falls back from one to the other.  Each launcher counts
its launches in a plain integer attribute
(``elite_decode.elite_decode_paged.launches``, ...), which ``launches()``
reads; both rotary entries launch one body and count in
``rope_elite.launches``.  ``select_topk_blocks`` is no kernel: it runs the
plain torch selection on either device, as the reference runs it in plain
jnp.

Meta tensors (the dry run's shape-only trace, ``launch/dryrun.py``).  A
meta input to ``elite_decode``, ``flash_prefill``, ``rope_elite`` or
``rope_elite_qk`` (and so to the rotary backward) takes the kernel's path
to its launcher's meta version, which allocates what the CUDA launcher
allocates — outputs, split-KV scratch sized by the same host plan — and
counts the call's bytes and FLOPs in ``build.META_CALLS`` instead of
launching; it never runs the plain version (whose temporaries, such as
``flash_prefill``'s whole ``[B, H, S, S]`` scores, the kernel never
allocates) and adds nothing to a launch count.  A meta input to any other
entry (paged, sparse, verify, their ``_q8`` forms) raises
``NotImplementedError`` naming the entry.

Gradients.  On the card the two rotary entries run inside
``torch.autograd.Function``s when an input requires grad under grad mode:
forward launches the kernel as above, backward launches it in its
transpose mode on the outputs' gradients (``rope_elite.rope_elite_backward``,
counted in ``rope_elite_backward.launches``), so the gradient reaches q
and k, and through a strided ``q[..., :2r]`` view the projection it was
sliced from.  Positions and frequencies are buffers and get none.  The
decode, verify and ``flash_prefill`` kernels have no backward: a CUDA
input that requires grad under grad mode makes them raise, naming the
kernel, rather than give an output that silently drops the gradient
(serving runs under ``torch.no_grad()``).  On the CPU the plain versions
are differentiable as they are.

Tensor parallelism.  ``elite_decode_paged_tp``, ``elite_decode_sparse_paged_tp``
and ``elite_verify_paged_tp`` are the reference's ``shard_map`` wrappers on
a ``launch.mesh.TPMesh``: one call of the single-device entry above per
head shard (each counted and traced as that entry), planned with
``split_nkv`` (the unsharded call's kv heads, which size the split-KV
ranges; the plain versions ignore it), and the shards' outputs copied to
the mesh's first device and concatenated, the reference's ``all_gather``.
They launch no kernel of their own.

Sharded steps.  ``rope_elite_qk``, ``flash_prefill`` and ``elite_decode``
take ``DTensor``s (the sharded train, prefill and decode steps,
``distributed/sharding.py``) through
``torch.distributed.tensor.experimental.local_map``, the counterpart of the
reference's ``shard_map`` around a Pallas call: each rank runs the entry
above on its local tensors (so a CUDA local tensor launches the kernel, a
meta one takes the meta version and a CPU one the plain version, counted
as that entry) and the outputs are placed as the inputs were.  Queries
shard their heads and batch; keys and values shard the batch and, where
the kv heads divide the mesh axis, their heads, else they are replicated:
then a shard's query heads ``[q0, q0 + Hq)`` use kv heads ``h // G``, so
``flash_prefill`` slices the replicated keys and values to those heads and
passes the shard's own ``q_group``, and ``rope_elite_qk``, whose one launch
reads one frequency row per ``q_per_row`` query heads and per
``k_per_row`` key heads, rotates the shard's query heads beside all the
key heads as one tensor of per-head rows (``rope_elite``'s one-tensor
launch, its backward likewise) where no such row split exists.
``elite_decode`` over a cache whose sequence is sharded (the decode plan's
``seq_over_tp``, or the data axes at batch 1) attends each rank's rows
with the kernel's log-sum-exp and merges the pieces with two all-reduces
per sharding mesh dim (``_sharded_elite_decode``, ``ref.merge_lse``).

``set_kernel_tracer`` (the reference's, ``kernels/ops.py``) arms spans on
the ``kernel`` track of a tracer, one per call, named after the entry
(``rope_elite_qk`` for the two-tensor rotary) with the first tensor's
``shape``.  On the card a launch is timed by CUDA events on its stream
(``build.launch``) and read when the trace is, so the span count per name
equals the launch counts' delta and nothing waits for the card; a plain
version on the CPU is timed on the host.  Disarmed, each costs one ``is
None`` test.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import is_dtensor, local_range, settled
from repro_torch.kernels import build
from repro_torch.kernels import elite_decode as _ed
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import ref
from repro_torch.kernels import rope_elite as _re

LAUNCHERS = {"elite_decode": _ed.elite_decode,
             "elite_decode_paged": _ed.elite_decode_paged,
             "elite_decode_paged_q8": _ed.elite_decode_paged_q8,
             "elite_decode_sparse_paged": _ed.elite_decode_sparse_paged,
             "elite_decode_sparse_paged_q8": _ed.elite_decode_sparse_paged_q8,
             "elite_verify_paged": _ed.elite_verify_paged,
             "elite_verify_paged_q8": _ed.elite_verify_paged_q8,
             "flash_prefill": _fp.flash_prefill,
             "rope_elite": _re.rope_elite,
             "rope_elite_backward": _re.rope_elite_backward}

select_topk_blocks = ref.select_topk_blocks


def set_kernel_tracer(tracer, device=None) -> None:
    """Install (or clear with ``None``) the tracer kernel calls report to.
    Process-wide, as in the reference: kernel call sites sit below the
    scheduler.  ``device`` is one device or a sequence of them (a router's
    replicas); each CUDA device is anchored now (one synchronize), so its
    launches never wait; a disabled tracer disarms."""
    if tracer is not None and not tracer.enabled:
        tracer = None
    build.TRACER = tracer
    if tracer is None or device is None:
        return
    devices = device if isinstance(device, (list, tuple)) else [device]
    indices = {torch.cuda.current_device() if d.index is None else d.index
               for d in map(torch.device, devices) if d.type == "cuda"}
    for index in sorted(indices):
        build.anchor(tracer, torch.device("cuda", index))


def _plain(name: str, fn, *args):
    """A plain version on the CPU, as a host-timed span when armed."""
    tr = build.TRACER
    if tr is None:
        return fn(*args)
    with tr.span(name, track="kernel", cat="kernel", shape=str(tuple(args[0].shape))):
        return fn(*args)


def _no_backward(name: str, *args) -> None:
    """Raise if autograd would record ``name``'s kernel, which has no
    backward: grad mode is on and a tensor argument requires grad."""
    if torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an input "
                           f"requires grad; call it under torch.no_grad()")


def _grad_view(g: torch.Tensor) -> torch.Tensor:
    """An output's gradient as the rotary kernel reads it: a unit last
    stride and 8-byte aligned rows, else a contiguous copy."""
    if g.stride(-1) != 1 or g.data_ptr() % 8 or any(st % 2 for st in g.stride()[:-1]):
        return g.contiguous()
    return g


class _RopeQK(torch.autograd.Function):
    """``rope_elite_qk`` on the card with its kernel backward.  Grads that
    autograd does not have arrive as zeros (materialized)."""

    @staticmethod
    def forward(ctx, q, k, positions, freqs, q_per_row: int, k_per_row: int):
        ctx.save_for_backward(positions, freqs)
        ctx.per_row = (q_per_row, k_per_row)
        return _re.rope_elite_qk(q, k, positions, freqs, q_per_row, k_per_row)

    @staticmethod
    def backward(ctx, g_q, g_k):
        positions, freqs = ctx.saved_tensors
        d_q, d_k = _re.rope_elite_backward(_grad_view(g_q), _grad_view(g_k), positions,
                                           freqs, *ctx.per_row)
        return d_q, d_k, None, None, None, None


class _Rope(torch.autograd.Function):
    """``rope_elite`` (one tensor) on the card with its kernel backward."""

    @staticmethod
    def forward(ctx, x, positions, freqs):
        ctx.save_for_backward(positions, freqs)
        return _re.rope_elite(x, positions, freqs)

    @staticmethod
    def backward(ctx, g):
        positions, freqs = ctx.saved_tensors
        g = _grad_view(g)
        rows, per_row = _re.one_tensor_rows(g, freqs)
        return _re.rope_elite_backward(g, None, positions, rows, per_row, 0)[0], None, None


def _refuse_meta(name: str, t) -> None:
    """Raise for a meta input to an entry that has no meta version."""
    if t.is_meta:
        raise NotImplementedError(f"{name}: no meta version (the dry run lowers the "
                                  f"contiguous steps); got meta tensors")


def _kernel_side(t) -> bool:
    """Whether a call on ``t`` goes to the kernel's launcher (CUDA, or its
    meta version) rather than the plain version (CPU)."""
    return t.is_cuda or t.is_meta


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                 scale: float, return_lse: bool = False):
    """Absorbed decode over a contiguous cache; see ``ref.elite_decode_ref``
    (``return_lse`` → (o, each row's log-sum-exp))."""
    if is_dtensor(q_e):
        if return_lse:
            raise ValueError("elite_decode on DTensors merges its shards: no lse out")
        return _sharded_elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group, scale)
    args = (q_e, q_lat, k_e, c_k, c_v, lengths, q_group, scale)
    if _kernel_side(q_e):
        _no_backward("elite_decode", *args)
        return _ed.elite_decode(*args, return_lse=return_lse)
    return _plain("elite_decode", lambda *a: ref.elite_decode_ref(*a, return_lse=return_lse),
                  *args)


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """Paged absorbed decode attention; see ``ref.elite_decode_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables, lengths,
            q_group, scale, block_size)
    _refuse_meta("elite_decode_paged", q_e)
    if q_e.is_cuda:
        _no_backward("elite_decode_paged", *args)
        return _ed.elite_decode_paged(*args, split_nkv=split_nkv)
    return _plain("elite_decode_paged", ref.elite_decode_paged_ref, *args)


def elite_decode_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, lengths,
                          q_group: int, scale: float, block_size: int,
                          split_nkv: int = 0) -> torch.Tensor:
    """Decode over an int8 pool; see ``ref.elite_decode_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, block_tables, lengths, q_group, scale, block_size)
    _refuse_meta("elite_decode_paged_q8", q_e)
    if q_e.is_cuda:
        _no_backward("elite_decode_paged_q8", *args)
        return _ed.elite_decode_paged_q8(*args, split_nkv=split_nkv)
    return _plain("elite_decode_paged_q8", ref.elite_decode_paged_q8_ref, *args)


def elite_decode_sparse_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              sel_tables, sel_counts, q_group: int, scale: float,
                              block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """Decode over a block selection; see ``ref.elite_decode_sparse_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, sel_tables, sel_counts,
            q_group, scale, block_size)
    _refuse_meta("elite_decode_sparse_paged", q_e)
    if q_e.is_cuda:
        _no_backward("elite_decode_sparse_paged", *args)
        return _ed.elite_decode_sparse_paged(*args, split_nkv=split_nkv)
    return _plain("elite_decode_sparse_paged", ref.elite_decode_sparse_paged_ref, *args)


def elite_decode_sparse_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                 k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                 sel_counts, q_group: int, scale: float,
                                 block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """Selection decode over an int8 pool; see
    ``ref.elite_decode_sparse_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, sel_tables, sel_counts, q_group, scale, block_size)
    _refuse_meta("elite_decode_sparse_paged_q8", q_e)
    if q_e.is_cuda:
        _no_backward("elite_decode_sparse_paged_q8", *args)
        return _ed.elite_decode_sparse_paged_q8(*args, split_nkv=split_nkv)
    return _plain("elite_decode_sparse_paged_q8", ref.elite_decode_sparse_paged_q8_ref,
                  *args)


def elite_verify_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, q_offsets, lengths, q_group: int, scale: float,
                       block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """Speculative verify over the pool; see ``ref.elite_verify_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables, q_offsets,
            lengths, q_group, scale, block_size)
    _refuse_meta("elite_verify_paged", q_e)
    if q_e.is_cuda:
        _no_backward("elite_verify_paged", *args)
        return _ed.elite_verify_paged(*args, split_nkv=split_nkv)
    return _plain("elite_verify_paged", ref.elite_verify_paged_ref, *args)


def elite_verify_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, q_offsets,
                          lengths, q_group: int, scale: float,
                          block_size: int, split_nkv: int = 0) -> torch.Tensor:
    """Verify over an int8 pool; see ``ref.elite_verify_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, block_tables, q_offsets, lengths, q_group, scale, block_size)
    _refuse_meta("elite_verify_paged_q8", q_e)
    if q_e.is_cuda:
        _no_backward("elite_verify_paged_q8", *args)
        return _ed.elite_verify_paged_q8(*args, split_nkv=split_nkv)
    return _plain("elite_verify_paged_q8", ref.elite_verify_paged_q8_ref, *args)


# ---------------------------------------------------------------------------
# tensor-parallel wrappers: the reference's shard_map over the "model" axis
# ---------------------------------------------------------------------------

def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _shard_of(x, r: int, mesh):
    """Shard ``r``'s copy of a replicated argument: its entry of a per-shard
    sequence (a sharded pool's leaf), else ``x`` on ``devices[r]``."""
    if isinstance(x, (list, tuple)):
        return x[r]
    return x.to(mesh.devices[r])


def _kv_shard(k_e, r: int, mesh):
    """Shard ``r``'s ``k_e`` pages: its entry of a sharded pool's per-shard
    tuple, else kv heads ``[r·h, (r+1)·h)`` of the whole pages, on
    ``devices[r]``."""
    if isinstance(k_e, (list, tuple)):
        return k_e[r]
    h = k_e.shape[1] // mesh.tp
    return k_e[:, r * h:(r + 1) * h].contiguous().to(mesh.devices[r])


def _tp_attend(fn, mesh, head_axis: int, q_e, q_lat, pages, scales, walk, q_group: int,
               scale: float, block_size: int):
    """Run the single-device entry ``fn`` once per head shard and gather.

    ``pages`` is (k_e, c_k, c_v): ``k_e`` the whole ``[n_slots, nkv, 2r]``
    pages or a sharded pool's tuple of ``tp`` head shards, the latents (and
    ``scales``, ``()`` for f32) a tensor or a per-shard tuple.  Shard ``r``
    takes query heads ``[r·nh/tp, (r+1)·nh/tp)`` on ``head_axis`` and its kv
    heads' pages, and the replicated latents, scales and ``walk`` on
    ``devices[r]``; its call is planned as the unsharded call's
    (``split_nkv``), so its ranges and merge order are that call's.  The
    outputs are copied to ``devices[0]`` and concatenated in shard order:
    the reference's tiled ``all_gather``."""
    k_e, c_k, c_v = pages
    nkv = (sum(t.shape[1] for t in k_e) if isinstance(k_e, (list, tuple))
           else k_e.shape[1])
    nh, tp = q_e.shape[head_axis], mesh.tp
    if nkv % tp or nh != nkv * q_group:
        raise ValueError(f"tensor parallelism needs tp to divide the kv heads: tp={tp} "
                         f"nkv={nkv} nh={nh} (pad the config: pad_cfg_for_tp)")
    if isinstance(k_e, (list, tuple)) and len(k_e) != tp:
        raise ValueError(f"k_e pages in {len(k_e)} shards for a mesh of tp={tp}")
    per = nh // tp
    outs = []
    for r, dev in enumerate(mesh.devices):
        ck = _shard_of(c_k, r, mesh)
        cv = ck if c_v is c_k else _shard_of(c_v, r, mesh)
        sc = [_shard_of(x, r, mesh) for x in scales]
        if scales and scales[2] is scales[1]:
            sc[2] = sc[1]
        q = [t.narrow(head_axis, r * per, per).contiguous().to(dev) for t in (q_e, q_lat)]
        o = fn(*q, _kv_shard(k_e, r, mesh), ck, cv, *sc,
               *(_shard_of(w, r, mesh) for w in walk), q_group, scale, block_size,
               split_nkv=nkv)
        outs.append(o.to(mesh.devices[0]))
    return torch.cat(outs, head_axis)


def elite_decode_paged_tp(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, scales,
                          block_tables, lengths, q_group: int, scale: float,
                          block_size: int, mesh) -> torch.Tensor:
    """Tensor-parallel paged decode over ``mesh`` (a ``launch.mesh.TPMesh``;
    None is tp 1): q_e/q_lat [B, nh, *] split on heads, ``k_e_pages`` on kv
    heads, the rest replicated (``_tp_attend``) → the full-head
    o [B, nh, dc] on ``devices[0]``.  ``scales`` is None for an f32 pool or
    the ``(k_e, c_k, c_v)`` scale triple of an int8 one (exact under head
    sharding: a scale is per slot).  At tp 1 the single-device entry."""
    fn = elite_decode_paged if scales is None else elite_decode_paged_q8
    if _tp(mesh) == 1:
        return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, *(scales or ()),
                  block_tables, lengths, q_group, scale, block_size)
    return _tp_attend(fn, mesh, 1, q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                      scales or (), (block_tables, lengths), q_group, scale, block_size)


def elite_decode_sparse_paged_tp(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, scales,
                                 sel_tables, sel_counts, q_group: int, scale: float,
                                 block_size: int, mesh) -> torch.Tensor:
    """``elite_decode_paged_tp`` over a block selection: ``sel_tables`` /
    ``sel_counts`` are replicated, chosen once on the full-head query
    (``select_topk_blocks``), so every shard walks the same blocks."""
    fn = elite_decode_sparse_paged if scales is None else elite_decode_sparse_paged_q8
    if _tp(mesh) == 1:
        return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, *(scales or ()),
                  sel_tables, sel_counts, q_group, scale, block_size)
    return _tp_attend(fn, mesh, 1, q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                      scales or (), (sel_tables, sel_counts), q_group, scale, block_size)


def elite_verify_paged_tp(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, scales,
                          block_tables, q_offsets, lengths, q_group: int, scale: float,
                          block_size: int, mesh) -> torch.Tensor:
    """Tensor-parallel speculative verify: as ``elite_decode_paged_tp``
    with a window axis, q_e/q_lat [B, W, nh, *] split on axis 2 and the
    gather reassembling o [B, W, nh, dc]."""
    fn = elite_verify_paged if scales is None else elite_verify_paged_q8
    if _tp(mesh) == 1:
        return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, *(scales or ()),
                  block_tables, q_offsets, lengths, q_group, scale, block_size)
    return _tp_attend(fn, mesh, 2, q_e, q_lat, (k_e_pages, c_k_pages, c_v_pages),
                      scales or (), (block_tables, q_offsets, lengths), q_group, scale,
                      block_size)


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Causal GQA attention with per-lane offsets; see ``ref.flash_prefill_ref``."""
    if is_dtensor(q):
        return _sharded_flash_prefill(q, k, v, q_group, scale, q_offsets, kv_lens)
    args = (q, k, v, q_group, scale, q_offsets, kv_lens)
    if _kernel_side(q):
        _no_backward("flash_prefill", *args)
        return _fp.flash_prefill(*args)
    return _plain("flash_prefill", ref.flash_prefill_ref, *args)


def rope_elite(x, positions, freqs) -> torch.Tensor:
    """Per-head rotary of packed elite dims; see ``ref.rope_elite_ref``."""
    if _kernel_side(x):
        if torch.is_grad_enabled() and x.requires_grad:
            _no_backward("rope_elite (positions, freqs)", positions, freqs)
            return _Rope.apply(x, positions, freqs)
        return _re.rope_elite(x, positions, freqs)
    return _plain("rope_elite", ref.rope_elite_ref, x, positions, freqs)


def rope_elite_qk(q, k, positions, freqs, q_per_row: int, k_per_row: int):
    """q and k of a layer rotated in one launch; see ``ref.rope_elite_qk_ref``."""
    if is_dtensor(q):
        return _sharded_rope_qk(q, k, positions, freqs, q_per_row, k_per_row)
    args = (q, k, positions, freqs, q_per_row, k_per_row)
    if _kernel_side(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
            _no_backward("rope_elite_qk (positions, freqs)", positions, freqs)
            return _RopeQK.apply(*args)
        return _re.rope_elite_qk(*args)
    return _plain("rope_elite_qk", ref.rope_elite_qk_ref, *args)


# ---------------------------------------------------------------------------
# sharded steps: the kernels under local_map
# ---------------------------------------------------------------------------

def _head_split(x, head_dim: int = 2):
    """(mesh dim that shards ``x``'s heads or None, the local heads' first
    global head) of a ``DTensor`` [B, S, H, *]: at most one mesh dim may
    shard the heads, evenly."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(x.placements) if p == Shard(head_dim)]
    if not dims:
        return None, 0
    if len(dims) > 1 or x.shape[head_dim] % x.device_mesh.size(dims[0]):
        raise ValueError(f"heads {x.shape[head_dim]} must split evenly over one mesh dim, "
                         f"got {x.placements} on {x.device_mesh}")
    i = dims[0]
    per = x.shape[head_dim] // x.device_mesh.size(i)
    return i, x.device_mesh.get_coordinate()[i] * per


def _batch_only(x):
    """``x``'s placements with only its batch sharding (dim 0) kept."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if p == Shard(0) else Replicate() for p in x.placements]


def _like_batch(q, t):
    """The placements for a per-lane [B] or per-lane-row tensor ``t`` (or
    None for a plain tensor) beside ``q``: sharded as ``q``'s batch."""
    return _batch_only(q) if is_dtensor(t) else None


def _check_placements(name: str, x, allowed) -> None:
    from torch.distributed.tensor import Replicate
    bad = [p for p in x.placements if p != Replicate() and p not in allowed]
    if bad:
        raise ValueError(f"{name}: placements {x.placements} are not batch or head "
                         f"sharding")


def _sharded_flash_prefill(q, k, v, q_group: int, scale: float, q_offsets, kv_lens):
    """``flash_prefill`` on ``DTensor``s: each rank attends with its query
    heads and lanes.  Keys and values keep their kv-head sharding where the
    query heads' mesh dim shards them too; replicated kv heads are sliced
    to those the shard's query heads read (``h // q_group``), and the call
    gets the shard's own group."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_placements(f"flash_prefill {name}", x, (Shard(0), Shard(2)))
    hdim, q0 = _head_split(q)
    kv_pl = _batch_only(q)
    nkv, nh = k.shape[2], q.shape[2]
    hq = nh if hdim is None else nh // q.device_mesh.size(hdim)
    if hdim is not None and k.placements[hdim] == Shard(2) \
            and v.placements[hdim] == Shard(2):
        kv_pl[hdim] = Shard(2)             # kv heads shard with the query heads
        lo, n_kv, group = None, None, q_group
    else:                                  # replicated kv heads: the shard's own
        lo = q0 // q_group
        n_kv = -(-(q0 + hq) // q_group) - lo
        group = hq // n_kv
        if group * n_kv != hq or (hq >= q_group and q0 % q_group):
            raise ValueError(f"flash_prefill: query heads [{q0}, {q0 + hq}) do not map "
                             f"onto whole kv heads of group {q_group}")

    def local(q_l, k_l, v_l, offs, lens):
        if lo is not None:
            k_l = k_l[:, :, lo:lo + n_kv].contiguous()
            v_l = v_l[:, :, lo:lo + n_kv].contiguous()
        return flash_prefill(q_l, k_l, v_l, group, scale, offs, lens)

    fn = local_map(local, out_placements=list(q.placements),
                   in_placements=(list(q.placements), kv_pl, kv_pl,
                                  _like_batch(q, q_offsets), _like_batch(q, kv_lens)),
                   device_mesh=q.device_mesh, redistribute_inputs=True)
    return fn(q, k, v, q_offsets, kv_lens)


def _all_reduce(t, op: str, mesh, dim: int):
    """``t`` reduced by ``op`` ("max", "sum") over mesh dim ``dim`` (a
    functional collective, waited on)."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t, op, (mesh, dim))
    return out.wait() if hasattr(out, "wait") else out


def _sharded_elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int, scale: float):
    """``elite_decode`` on ``DTensor``s: q_e/q_lat [B, nh, *] with lanes
    and heads sharded, the cache [B, S, ...] with lanes, sequence (``k_e``
    and the latents alike) or ``k_e``'s kv heads sharded.

    Over the mesh dims that shard the cache sequence, each rank gathers the
    query (``[q_e | q_lat]`` in one gather), attends its own rows ``[s0,
    s0 + S_l)`` with local lengths ``clamp(len - s0, 0, S_l)`` through the
    kernel with its log-sum-exp, and merges with the other pieces by two
    all-reduces per such dim: the max of the lse, then the sum of ``[o·w |
    w]`` with ``w = ref.merge_weights(lse, max)``, ``o = Σ o·w / max(Σ w,
    1e-30)`` (``ref.merge_lse``'s sums).  No collective moves the cache.
    Over a dim that shards ``k_e``'s kv heads the query heads shard with
    them; over one that replicates ``k_e``, query heads stay sharded and
    read the kv heads ``h // q_group`` sliced from the replicated ones with
    the shard's own group, as ``_sharded_flash_prefill``; there a latent
    whose d_c the rules shard (the cache without ``seq_over_tp``) is
    gathered, as the kernel reads whole latent rows.  → o [B, nh, dc]
    placed as the query after the gather."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_e.device_mesh
    q = settled(torch.cat([q_e, q_lat], dim=-1))
    _check_placements("elite_decode q", q, (Shard(0), Shard(1)))
    _check_placements("elite_decode k_e", k_e, (Shard(0), Shard(1), Shard(2)))
    if list(c_v.placements) != list(c_k.placements):
        raise ValueError(f"elite_decode: latents placed {c_k.placements}, {c_v.placements}")
    k_pl, q_pl, c_pl = list(k_e.placements), list(q.placements), []
    for i, (kp, cp) in enumerate(zip(k_pl, c_k.placements)):
        lane_or_seq = kp in (Shard(0), Shard(1))
        if (cp != kp) if lane_or_seq else cp not in (Replicate(), Shard(2)):
            raise ValueError(f"elite_decode: latents placed {c_k.placements} beside k_e "
                             f"{k_e.placements}")
        c_pl.append(kp if lane_or_seq else Replicate())
        if kp == Shard(1):
            q_pl[i] = Replicate()          # gather the query over the sequence's dims
        elif kp == Shard(0):
            q_pl[i] = Shard(0)
        elif kp == Shard(2):
            q_pl[i] = Shard(1)             # query heads with their kv heads
        elif q_pl[i] == Shard(0):
            k_pl[i] = c_pl[i] = Shard(0)   # cut the replicated cache to the lanes
    seq = [i for i, p in enumerate(k_pl) if p == Shard(1)]
    if not is_dtensor(lengths):            # a whole [B] on every rank
        lengths = DTensor.from_local(lengths, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    l_pl = [Shard(0) if p == Shard(0) else Replicate() for p in q_pl]
    hdims = [i for i, p in enumerate(q_pl) if p == Shard(1)]
    nh, nkv, r2 = q.shape[1], k_e.shape[2], q_e.shape[-1]
    lo = n_kv = None
    group = q_group
    if hdims and k_pl[hdims[0]] != Shard(2):   # replicated kv heads: the shard's own
        hq = nh // mesh.size(hdims[0])
        q0 = mesh.get_coordinate()[hdims[0]] * hq
        lo = q0 // q_group
        n_kv = -(-(q0 + hq) // q_group) - lo
        group = hq // n_kv
        if group * n_kv != hq or (hq >= q_group and q0 % q_group):
            raise ValueError(f"elite_decode: query heads [{q0}, {q0 + hq}) do not map "
                             f"onto whole kv heads of group {q_group}")
    s0 = local_range(k_e, 1)[0]
    shared = c_v is c_k

    def local(q_l, k_l, ck_l, *rest):
        cv_l, len_l = (ck_l, rest[0]) if shared else rest
        qe_l, ql_l = q_l[..., :r2].contiguous(), q_l[..., r2:].contiguous()
        if lo is not None:
            k_l = k_l[:, :, lo:lo + n_kv].contiguous()
        if not seq:
            return elite_decode(qe_l, ql_l, k_l, ck_l, cv_l, len_l, group, scale)
        mine = (len_l - s0).clamp(0, k_l.shape[1]).to(torch.int32)
        o, lse = elite_decode(qe_l, ql_l, k_l, ck_l, cv_l, mine, group, scale,
                              return_lse=True)
        top = lse
        for i in seq:
            top = _all_reduce(top, "max", mesh, i)
        w = ref.merge_weights(lse, top)[..., None]
        sums = torch.cat([o * w, w], dim=-1)
        for i in seq:
            sums = _all_reduce(sums, "sum", mesh, i)
        return sums[..., :-1] / sums[..., -1:].clamp(min=1e-30)

    args = (q, k_e, c_k) + (() if shared else (c_v,)) + (lengths,)
    pls = (q_pl, k_pl, c_pl) + (() if shared else (c_pl,)) + (l_pl,)
    fn = local_map(local, out_placements=q_pl, in_placements=pls, device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*args)


def _rows(first: int, n: int, per_row: int):
    """The frequency row of each of ``n`` heads from global head ``first``."""
    return [(first + j) // per_row for j in range(n)]


def _sharded_rope_qk(q, k, positions, freqs, q_per_row: int, k_per_row: int):
    """``rope_elite_qk`` on ``DTensor``s: each rank rotates its local q and
    k heads in one launch.  Where the local heads' frequency rows form one
    run of rows read ``Hq / R`` and ``Hk / R`` heads apiece, the two-tensor
    launch takes that run; else the local q and k heads go through the
    one-tensor launch together, one row per head."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    q, k = settled(q), settled(k)          # a pending sum (a batch-1 FSDP product)
    for name, x in (("q", q), ("k", k)):
        _check_placements(f"rope_elite_qk {name}", x, (Shard(0), Shard(2)))
    _, q0 = _head_split(q)
    _, k0 = _head_split(k)
    hq, hk = q._local_tensor.shape[2], k._local_tensor.shape[2]
    rq, rk = _rows(q0, hq, q_per_row), _rows(k0, hk, k_per_row)
    n = len(set(rq))
    # one run of n rows from rq[0], read by hq / n query and hk / n key heads each
    paired = (hq % n == 0 and hk % n == 0
              and rq == [rq[0] + j // (hq // n) for j in range(hq)]
              and rk == [rq[0] + j // (hk // n) for j in range(hk)])

    def local(q_l, k_l, pos, f):
        if paired:
            return rope_elite_qk(q_l, k_l, pos, f[rq[0]:rq[0] + n], hq // n, hk // n)
        idx = torch.tensor(rq + rk, device=f.device)
        out = rope_elite(torch.cat([q_l, k_l], dim=2), pos, f.index_select(0, idx))
        return out[:, :, :hq], out[:, :, hq:]

    rep = lambda t: (list(t.placements) if is_dtensor(t) else None)
    fn = local_map(local, out_placements=(list(q.placements), list(k.placements)),
                   in_placements=(list(q.placements), list(k.placements), rep(positions),
                                  rep(freqs)),
                   device_mesh=q.device_mesh, redistribute_inputs=True)
    return fn(q, k, positions, freqs)
