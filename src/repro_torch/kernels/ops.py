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
"""
from __future__ import annotations

from typing import Dict

import torch

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


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def elite_decode(q_e, q_lat, k_e, c_k, c_v, lengths, q_group: int,
                 scale: float) -> torch.Tensor:
    """Absorbed decode over a contiguous cache; see ``ref.elite_decode_ref``."""
    fn = _ed.elite_decode if q_e.is_cuda else ref.elite_decode_ref
    return fn(q_e, q_lat, k_e, c_k, c_v, lengths, q_group, scale)


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Paged absorbed decode attention; see ``ref.elite_decode_paged_ref``."""
    fn = _ed.elite_decode_paged if q_e.is_cuda else ref.elite_decode_paged_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables,
              lengths, q_group, scale, block_size)


def elite_decode_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, lengths,
                          q_group: int, scale: float, block_size: int) -> torch.Tensor:
    """Decode over an int8 pool; see ``ref.elite_decode_paged_q8_ref``."""
    fn = _ed.elite_decode_paged_q8 if q_e.is_cuda else ref.elite_decode_paged_q8_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
              c_v_scale, block_tables, lengths, q_group, scale, block_size)


def elite_decode_sparse_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                              sel_tables, sel_counts, q_group: int, scale: float,
                              block_size: int) -> torch.Tensor:
    """Decode over a block selection; see ``ref.elite_decode_sparse_paged_ref``."""
    fn = _ed.elite_decode_sparse_paged if q_e.is_cuda else ref.elite_decode_sparse_paged_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, sel_tables, sel_counts,
              q_group, scale, block_size)


def elite_decode_sparse_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                                 k_e_scale, c_k_scale, c_v_scale, sel_tables,
                                 sel_counts, q_group: int, scale: float,
                                 block_size: int) -> torch.Tensor:
    """Selection decode over an int8 pool; see
    ``ref.elite_decode_sparse_paged_q8_ref``."""
    fn = (_ed.elite_decode_sparse_paged_q8 if q_e.is_cuda
          else ref.elite_decode_sparse_paged_q8_ref)
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
              c_v_scale, sel_tables, sel_counts, q_group, scale, block_size)


def elite_verify_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, q_offsets, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Speculative verify over the pool; see ``ref.elite_verify_paged_ref``."""
    fn = _ed.elite_verify_paged if q_e.is_cuda else ref.elite_verify_paged_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables, q_offsets,
              lengths, q_group, scale, block_size)


def elite_verify_paged_q8(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                          k_e_scale, c_k_scale, c_v_scale, block_tables, q_offsets,
                          lengths, q_group: int, scale: float,
                          block_size: int) -> torch.Tensor:
    """Verify over an int8 pool; see ``ref.elite_verify_paged_q8_ref``."""
    fn = _ed.elite_verify_paged_q8 if q_e.is_cuda else ref.elite_verify_paged_q8_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, k_e_scale, c_k_scale,
              c_v_scale, block_tables, q_offsets, lengths, q_group, scale, block_size)


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Causal GQA attention with per-lane offsets; see ``ref.flash_prefill_ref``."""
    fn = _fp.flash_prefill if q.is_cuda else ref.flash_prefill_ref
    return fn(q, k, v, q_group, scale, q_offsets, kv_lens)


def rope_elite(x, positions, freqs) -> torch.Tensor:
    """Per-head rotary of packed elite dims; see ``ref.rope_elite_ref``."""
    fn = _re.rope_elite if x.is_cuda else ref.rope_elite_ref
    return fn(x, positions, freqs)


def rope_elite_qk(q, k, positions, freqs, q_per_row: int, k_per_row: int):
    """q and k of a layer rotated in one launch; see ``ref.rope_elite_qk_ref``."""
    fn = _re.rope_elite_qk if q.is_cuda else ref.rope_elite_qk_ref
    return fn(q, k, positions, freqs, q_per_row, k_per_row)
