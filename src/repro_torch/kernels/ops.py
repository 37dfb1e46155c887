"""Dispatch for the attention kernels, with their launch counts.

A call whose query lies on a CUDA device launches the hand-written kernel
(which raises on anything it does not take); a call on the CPU runs the
plain PyTorch version.  Nothing falls back from one to the other.  Each
launcher counts its launches in a plain integer attribute
(``elite_decode.elite_decode_paged.launches``,
``flash_prefill.flash_prefill.launches``), which ``launches()`` reads.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import elite_decode as _ed
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import ref

LAUNCHERS = {"elite_decode_paged": _ed.elite_decode_paged,
             "flash_prefill": _fp.flash_prefill}


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def elite_decode_paged(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages,
                       block_tables, lengths, q_group: int, scale: float,
                       block_size: int) -> torch.Tensor:
    """Paged absorbed decode attention; see ``ref.elite_decode_paged_ref``."""
    fn = _ed.elite_decode_paged if q_e.is_cuda else ref.elite_decode_paged_ref
    return fn(q_e, q_lat, k_e_pages, c_k_pages, c_v_pages, block_tables,
              lengths, q_group, scale, block_size)


def flash_prefill(q, k, v, q_group: int, scale: float, q_offsets,
                  kv_lens) -> torch.Tensor:
    """Causal GQA attention with per-lane offsets; see ``ref.flash_prefill_ref``."""
    fn = _fp.flash_prefill if q.is_cuda else ref.flash_prefill_ref
    return fn(q, k, v, q_group, scale, q_offsets, kv_lens)
