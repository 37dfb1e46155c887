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
             "rope_elite": _re.rope_elite}

select_topk_blocks = ref.select_topk_blocks


def set_kernel_tracer(tracer, device=None) -> None:
    """Install (or clear with ``None``) the tracer kernel calls report to.
    Process-wide, as in the reference: kernel call sites sit below the
    scheduler.  A CUDA ``device`` is anchored now (one synchronize), so its
    launches never wait; a disabled tracer disarms."""
    if tracer is not None and not tracer.enabled:
        tracer = None
    build.TRACER = tracer
    dev = torch.device(device) if device is not None else None
    if tracer is not None and dev is not None and dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        build.anchor(tracer, torch.device("cuda", index))


def _plain(name: str, fn, *args):
    """A plain version on the CPU, as a host-timed span when armed."""
    tr = build.TRACER
    if tr is None:
        return fn(*args)
    with tr.span(name, track="kernel", cat="kernel", shape=str(tuple(args[0].shape))):
        return fn(*args)


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                 scale: float) -> torch.Tensor:
    """Absorbed decode over a contiguous cache; see ``ref.elite_decode_ref``."""
    args = (q_e, q_lat, k_e, c_k, c_v, lengths, q_group, scale)
    if q_e.is_cuda:
        return _ed.elite_decode(*args)
    return _plain("elite_decode", ref.elite_decode_ref, *args)


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Paged absorbed decode attention; see ``ref.elite_decode_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables, lengths,
            q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_decode_paged(*args)
    return _plain("elite_decode_paged", ref.elite_decode_paged_ref, *args)


def elite_decode_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, lengths,
                          q_group: int, scale: float, block_size: int) -> torch.Tensor:
    """Decode over an int8 pool; see ``ref.elite_decode_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, block_tables, lengths, q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_decode_paged_q8(*args)
    return _plain("elite_decode_paged_q8", ref.elite_decode_paged_q8_ref, *args)


def elite_decode_sparse_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              sel_tables, sel_counts, q_group: int, scale: float,
                              block_size: int) -> torch.Tensor:
    """Decode over a block selection; see ``ref.elite_decode_sparse_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, sel_tables, sel_counts,
            q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_decode_sparse_paged(*args)
    return _plain("elite_decode_sparse_paged", ref.elite_decode_sparse_paged_ref, *args)


def elite_decode_sparse_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                 k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                 sel_counts, q_group: int, scale: float,
                                 block_size: int) -> torch.Tensor:
    """Selection decode over an int8 pool; see
    ``ref.elite_decode_sparse_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, sel_tables, sel_counts, q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_decode_sparse_paged_q8(*args)
    return _plain("elite_decode_sparse_paged_q8", ref.elite_decode_sparse_paged_q8_ref,
                  *args)


def elite_verify_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, q_offsets, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Speculative verify over the pool; see ``ref.elite_verify_paged_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables, q_offsets,
            lengths, q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_verify_paged(*args)
    return _plain("elite_verify_paged", ref.elite_verify_paged_ref, *args)


def elite_verify_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, q_offsets,
                          lengths, q_group: int, scale: float,
                          block_size: int) -> torch.Tensor:
    """Verify over an int8 pool; see ``ref.elite_verify_paged_q8_ref``."""
    args = (q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
            c_v_scale, block_tables, q_offsets, lengths, q_group, scale, block_size)
    if q_e.is_cuda:
        return _ed.elite_verify_paged_q8(*args)
    return _plain("elite_verify_paged_q8", ref.elite_verify_paged_q8_ref, *args)


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Causal GQA attention with per-lane offsets; see ``ref.flash_prefill_ref``."""
    args = (q, k, v, q_group, scale, q_offsets, kv_lens)
    if q.is_cuda:
        return _fp.flash_prefill(*args)
    return _plain("flash_prefill", ref.flash_prefill_ref, *args)


def rope_elite(x, positions, freqs) -> torch.Tensor:
    """Per-head rotary of packed elite dims; see ``ref.rope_elite_ref``."""
    if x.is_cuda:
        return _re.rope_elite(x, positions, freqs)
    return _plain("rope_elite", ref.rope_elite_ref, x, positions, freqs)


def rope_elite_qk(q, k, positions, freqs, q_per_row: int, k_per_row: int):
    """q and k of a layer rotated in one launch; see ``ref.rope_elite_qk_ref``."""
    args = (q, k, positions, freqs, q_per_row, k_per_row)
    if q.is_cuda:
        return _re.rope_elite_qk(*args)
    return _plain("rope_elite_qk", ref.rope_elite_qk_ref, *args)
