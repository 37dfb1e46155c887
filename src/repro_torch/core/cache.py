"""KV-cache size accounting, the block-paged compressed-KV pool and its
admission/eviction policy.

Counterpart of the JAX package's ``core/cache.py``, for a pool on one
device.  Size formulas (paper §3.2), per token per attention layer, in
floats: ``2 · n_kv · d_h`` for the baseline, ``2 · r · n_kv + d_ckv`` under
RoPElite + J-LRD (``+ d_ck + d_cv`` under S-LRD).  ``PagedKVPool`` stores
the compressed ``(k_e, c)`` streams of every attention layer in fixed-size
token blocks shared across sequences;
sequences own ragged chains of blocks through per-sequence block tables,
grown one block at a time and recycled the moment a sequence retires.  Page
tensors keep the reference's leaf names and ``[n_super, n_slots, ...]``
layout (``k_e``, and ``c`` or ``c_k``/``c_v``), so contents compare leaf for
leaf; the forward passes write them in place.  All bookkeeping (free list,
tables, lengths) is host-side Python.

``dtype="int8"`` stores every stream as symmetric-absmax int8 rows with a
per-slot f32 scale leaf ``<name>_scale`` ``[n_super, n_slots]`` beside it
(``core/quant.py``).  ``block_summaries=True`` (sparse decode) adds the
latent key stream's per-block masked mean and absmax, ``<key>_blkmean`` and
``<key>_blkmax`` ``[n_super, num_blocks, d_c]`` f32 (``key`` is ``c``, or
``c_k`` under S-LRD), which the page scatter keeps current.

``BlockManager`` adds the scheduler's policy: ``"preempt"`` admission (no
reservation; growth may raise ``OutOfBlocks`` and the scheduler evicts) or
the ``"watermark"`` reservation, recompute eviction, and the rollback of a
speculative window (``truncate``).

Not ported yet: the prefix cache and copy-on-write, host swap and
tensor-parallel page placement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant

#: per-block latent summary leaves of a ``block_summaries=True`` pool
BLOCK_SUMMARY_SUFFIXES = ("_blkmean", "_blkmax")


def attn_cache_floats_per_token(cfg: ModelConfig) -> int:
    return cfg.elitekv.cache_per_token_per_layer(cfg.n_kv_heads, cfg.head_dim)


def model_cache_floats_per_token(cfg: ModelConfig) -> int:
    """Every layer of the port's stacks is an attention layer."""
    return cfg.num_layers * attn_cache_floats_per_token(cfg)


def cache_ratio(cfg_elite: ModelConfig, cfg_base: ModelConfig) -> float:
    """Attention-KV compression ratio vs the unmodified model."""
    a = model_cache_floats_per_token(cfg_elite)
    b = model_cache_floats_per_token(cfg_base)
    return a / b if b else 1.0


def measured_cache_bytes(cache, batch: int, max_len: int) -> Dict[str, int]:
    """Bytes held by a live contiguous cache (``lm.init_cache``), split
    attention vs SSM state as the reference reports them (the port has no
    SSM layers, so ``ssm_bytes`` is 0)."""
    attn = sum(t.numel() * t.element_size()
               for layer in cache["blocks"].values() for t in layer.values())
    return {"attn_bytes": attn, "ssm_bytes": 0,
            "attn_bytes_per_token": attn // (batch * max_len)}


class OutOfBlocks(RuntimeError):
    """Raised when the pool cannot satisfy an allocation (the caller may
    retry after retiring or evicting sequences, or refuse admission)."""


class BlockAllocator:
    """Host-side free list over ``num_blocks`` fixed-size token blocks."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.high_water = 0          # max blocks simultaneously in use
        self.total_allocs = 0        # lifetime alloc count

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        got = [self._free.pop() for _ in range(n)]
        self.total_allocs += n
        self.high_water = max(self.high_water, self.num_used)
        return got

    def free(self, blocks: Sequence[int]) -> None:
        self._free.extend(blocks)


@dataclasses.dataclass
class PoolStats:
    block_size: int
    num_blocks: int
    blocks_in_use: int
    blocks_free: int
    high_water_blocks: int
    total_allocs: int
    live_tokens: int        # sum of sequence lengths
    allocated_tokens: int   # blocks_in_use * block_size (internal fragmentation)
    live_bytes: int
    allocated_bytes: int
    dtype: str = "float32"
    bytes_per_token: int = 0


class PagedKVPool:
    """Block-paged device storage for EliteKV's compressed cache streams.

    ``pages["p0"][name]`` is ``[n_layers, n_slots, ...]`` with
    ``n_slots = num_blocks · block_size``; token ``t`` of block ``b`` lives at
    flat slot ``b · block_size + t``.  ``dtype`` is ``"float32"`` or
    ``"int8"`` (or the torch dtype).
    """

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 device="cuda", dtype="float32", block_summaries: bool = False):
        if not cfg.elitekv.enabled:
            raise ValueError("the paged pool stores EliteKV compressed streams only")
        quantized = quant.is_int8(dtype)
        if not quantized and dtype not in ("float32", torch.float32):
            raise ValueError(f"pool dtype {dtype!r}: expected 'float32' or 'int8'")
        self.dtype = torch.int8 if quantized else torch.float32
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.device = torch.device(device)
        self.allocator = BlockAllocator(num_blocks)
        self._tables: Dict[int, List[int]] = {}   # seq_id → block chain
        self._lengths: Dict[int, int] = {}        # seq_id → live token count
        e = cfg.elitekv
        n_slots = num_blocks * block_size
        tails = {"k_e": (cfg.n_kv_heads, 2 * e.elite_r)}
        if e.lrd == "joint":
            tails["c"] = (e.d_ckv,)
        else:
            tails["c_k"] = (e.d_ck,)
            tails["c_v"] = (e.d_cv,)
        L, dev = cfg.num_layers, self.device
        leaves = {}
        for name, tail in tails.items():
            leaves[name] = torch.zeros((L, n_slots) + tail, dtype=self.dtype, device=dev)
            if quantized:
                leaves[name + "_scale"] = torch.zeros((L, n_slots), device=dev)
        if block_summaries:
            key = "c" if e.lrd == "joint" else "c_k"
            for sfx in BLOCK_SUMMARY_SUFFIXES:
                leaves[key + sfx] = torch.zeros((L, num_blocks) + tails[key], device=dev)
        self.pages = {"p0": leaves}

    # -- sequence lifecycle -------------------------------------------------
    def ensure_capacity(self, seq_id: int, length: int) -> None:
        """Grow ``seq_id``'s chain to hold ``length`` tokens (allocating
        lazily on first touch).  Raises OutOfBlocks when the pool is full."""
        table = self._tables.setdefault(seq_id, [])
        need = -(-length // self.block_size) - len(table)
        if need > 0:
            table.extend(self.allocator.alloc(need))
        self._lengths[seq_id] = max(self._lengths.get(seq_id, 0), length)

    def can_fit(self, extra_tokens: int) -> bool:
        return self.allocator.num_free * self.block_size >= extra_tokens

    def truncate(self, seq_id: int, length: int) -> None:
        """Shrink ``seq_id`` to ``length`` tokens and return the tail blocks
        the shorter chain no longer covers to the allocator (speculative
        decode rolls a rejected window tail back here).  Pages are never
        rewritten: later growth writes over the stale slots.  Every block
        has one owner (there is no prefix cache in the port yet, hence no
        refcount and no shared block to merely un-link).  An unknown
        sequence accepts only ``length == 0`` and stays unknown; growing
        through ``truncate`` is an assertion; 0 keeps the empty chain
        registered."""
        assert length >= 0, length
        if seq_id not in self._lengths:
            assert length == 0, (seq_id, length)
            return
        assert length <= self._lengths[seq_id], (seq_id, length, self._lengths[seq_id])
        table = self._tables.get(seq_id, [])
        keep = -(-length // self.block_size)
        if keep < len(table):
            self.allocator.free(table[keep:])
            del table[keep:]
        self._lengths[seq_id] = length

    def free_seq(self, seq_id: int) -> None:
        blocks = self._tables.pop(seq_id, [])
        if blocks:
            self.allocator.free(blocks)
        self._lengths.pop(seq_id, None)

    def length(self, seq_id: int) -> int:
        return self._lengths.get(seq_id, 0)

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._tables.get(seq_id, []))

    # -- index helpers ------------------------------------------------------
    @property
    def oob_slot(self) -> int:
        """Scatter sentinel: one past the last flat slot.  Writes to it are
        dropped (idle lanes, prompt padding)."""
        return self.num_blocks * self.block_size

    def block_table_array(self, seq_ids: Sequence[Optional[int]],
                          max_blocks: int) -> np.ndarray:
        """Padded int32 ``[len(seq_ids), max_blocks]`` table.  Pad entries
        are block 0 — a live block of some other sequence — so only the
        per-sequence lengths make them invisible downstream."""
        out = np.zeros((len(seq_ids), max_blocks), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            t = self._tables.get(sid, [])
            assert len(t) <= max_blocks, (len(t), max_blocks)
            out[i, :len(t)] = t
        return out

    def flat_slots(self, seq_id: int, positions) -> np.ndarray:
        """Flat pool slots of logical ``positions`` of ``seq_id``'s chain:
        position ``p`` lives at ``table[p // bs] · bs + p % bs``."""
        table = np.asarray(self._tables[seq_id], np.int64)
        pos = np.asarray(positions)
        return table[pos // self.block_size] * self.block_size \
            + pos % self.block_size

    def slot_mapping(self, seq_ids: Sequence[Optional[int]],
                     positions: Sequence[int]) -> np.ndarray:
        """Flat write slots for one token per sequence; inactive lanes
        (seq_id None) map to ``oob_slot``."""
        out = np.full((len(seq_ids),), self.oob_slot, np.int32)
        for i, (sid, pos) in enumerate(zip(seq_ids, positions)):
            if sid is not None:
                out[i] = self.flat_slots(sid, pos)
        return out

    def prefill_slot_mapping(self, seq_id: int, start: int,
                             n_tokens: int, pad_to: int) -> np.ndarray:
        """Flat write slots for ``n_tokens`` consecutive positions from
        ``start``, padded with ``oob_slot`` up to ``pad_to``."""
        out = np.full((pad_to,), self.oob_slot, np.int32)
        out[:n_tokens] = self.flat_slots(seq_id, np.arange(start, start + n_tokens))
        return out

    # -- accounting ---------------------------------------------------------
    def bytes_per_token(self) -> int:
        """Pool bytes per token slot, summed over every page leaf: int8 rows
        and their f32 scales in a quantized pool, and the block summaries
        spread over their blocks' slots."""
        n_slots = self.num_blocks * self.block_size
        return sum(a.numel() * a.element_size() // n_slots
                   for layer in self.pages.values() for a in layer.values())

    def stats(self) -> PoolStats:
        live = sum(self._lengths.values())
        alloc_tok = self.allocator.num_used * self.block_size
        bpt = self.bytes_per_token()
        return PoolStats(
            block_size=self.block_size, num_blocks=self.num_blocks,
            blocks_in_use=self.allocator.num_used,
            blocks_free=self.allocator.num_free,
            high_water_blocks=self.allocator.high_water,
            total_allocs=self.allocator.total_allocs,
            live_tokens=live, allocated_tokens=alloc_tok,
            live_bytes=live * bpt, allocated_bytes=alloc_tok * bpt,
            dtype=str(self.dtype).removeprefix("torch."), bytes_per_token=bpt)


class BlockManager:
    """Admission + eviction policy over a ``PagedKVPool``.

    * ``"preempt"`` (default) — no reservation: a request is admitted once
      its next allocation fits; residents grow on demand, and growth may
      raise ``OutOfBlocks``, which the scheduler resolves by preempting the
      youngest resident (recompute eviction: its blocks are freed and its
      prefix re-prefilled after re-admission).
    * ``"watermark"`` — the worst-case blocks still owed to every resident
      are held back, so growth never fails.
    """

    def __init__(self, pool: PagedKVPool, policy: str = "preempt"):
        if policy not in ("preempt", "watermark"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.pool = pool
        self.policy = policy
        self._resident_worst: Dict[int, int] = {}   # seq_id → worst-case blocks
        self.preemptions = 0

    @property
    def reserved_blocks(self) -> int:
        """Watermark: worst-case blocks still owed to registered residents."""
        return sum(max(0, w - len(self.pool.block_table(sid)))
                   for sid, w in self._resident_worst.items())

    def can_admit(self, first_alloc_tokens: int, worst_case_blocks: int) -> bool:
        if self.policy == "watermark":
            return (self.pool.allocator.num_free - self.reserved_blocks
                    >= worst_case_blocks)
        return self.pool.can_fit(first_alloc_tokens)

    def register(self, seq_id: int, worst_case_blocks: int) -> None:
        self._resident_worst[seq_id] = worst_case_blocks

    def grow(self, seq_id: int, length: int) -> None:
        """Grow ``seq_id`` to ``length`` tokens; raises ``OutOfBlocks`` when
        the pool is exhausted (the scheduler then preempts)."""
        self.pool.ensure_capacity(seq_id, length)

    def release(self, seq_id: int) -> None:
        """Retire or evict: free the chain and drop residency."""
        self.pool.free_seq(seq_id)
        self._resident_worst.pop(seq_id, None)

    def truncate(self, seq_id: int, length: int) -> None:
        """Roll ``seq_id`` back to ``length`` tokens (a rejected speculative
        window tail): its tail blocks return to the free list at once and
        residency is kept, so the watermark reservation grows back by
        exactly the released blocks."""
        self.pool.truncate(seq_id, length)

    def preempt_recompute(self, seq_id: int) -> None:
        self.release(seq_id)
        self.preemptions += 1
