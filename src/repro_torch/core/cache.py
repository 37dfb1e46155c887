"""KV-cache size accounting, the block-paged compressed-KV pool and its
admission/eviction policy.

Counterpart of the JAX package's ``core/cache.py``, for a pool on one
device.  Size formulas (paper §3.2), per token per attention layer, in
floats: ``2 · n_kv · d_h`` for the baseline, ``2 · r · n_kv + d_ckv`` under
RoPElite + J-LRD (``+ d_ck + d_cv`` under S-LRD); Mamba layers hold a
per-sequence state instead (``ssm_state_floats``).  ``PagedKVPool`` pages
attention-only stacks (dense or MoE) and refuses any other: it stores
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
the ``"watermark"`` reservation, recompute or host-swap eviction, the
rollback of a speculative window (``truncate``) and, with
``prefix_cache=True``, the cross-request prefix cache: full prompt blocks
are content-addressed by chained sha256 hashes (``prefix_block_hashes``),
shared across chains with refcounts, kept in an LRU once no chain holds
them, and copied on write (``make_private``) before a chain writes into a
block another chain reads.  Swap-out gathers a victim's slots on the
device and copies them once into pinned host memory (``SwappedSeq``);
swap-in scatters them back onto whatever chain it is given, byte for byte.

With a ``tracer`` the pool emits the reference's events on the ``pool``
track: ``alloc``, ``free`` (reasons ``release``, ``truncate``, ``reclaim``)
and ``retain`` as blocks change hands, ``share``, ``cow`` and
``prefix_register`` for the prefix cache, and ``swap_out``/``swap_in``
spans over the host window of a swap, whose device copy on the card adds a
``device_ms`` argument read when the trace is (two CUDA events, no wait).

Tensor-parallel placement (``mesh=``, a ``launch.mesh.TPMesh`` of ``tp >
1`` devices) follows ``distributed/sharding.py::serving_page_pspecs``:
``k_e`` is split over its kv heads, shard ``r`` ``[L, n_slots, n_kv/tp,
2r]`` on ``devices[r]``, and every other leaf (latents, int8 scales, block
summaries) is replicated, stored once per distinct device.  Each leaf of
such a pool's ``pages["p0"]`` is then a tuple of ``tp`` tensors, entry
``r`` the one shard ``r`` reads (one object for the shards of one device).
The host bookkeeping (block ids, chains, refcounts, prefix hashes) is the
same at any tp, and every write of page contents (the forwards' scatter,
copy-on-write, swap-in) goes to every shard and copy (``put_rows``), so the
shards gathered hold a tp-1 pool's bytes.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.distributed.sharding import plan_for_mesh, serving_page_pspecs
from repro_torch.obs.trace import NULL_TRACER, DeviceDuration

#: per-block latent summary leaves of a ``block_summaries=True`` pool
BLOCK_SUMMARY_SUFFIXES = ("_blkmean", "_blkmax")


def is_block_summary(name: str) -> bool:
    """True for page leaves indexed by block rather than by slot."""
    return name.endswith(BLOCK_SUMMARY_SUFFIXES)


#: the page leaf a tensor-parallel pool splits, over its kv heads: the axis
#: after the slot axis (``serving_page_pspecs``)
HEAD_SPLIT = "k_e"


def first(leaf) -> torch.Tensor:
    """A page leaf's tensor, or the first shard's of a sharded pool's tuple
    (for a replicated leaf, its copy on the mesh's first device)."""
    return leaf if torch.is_tensor(leaf) else leaf[0]


def leaf_copies(leaf) -> List[torch.Tensor]:
    """The distinct tensors of a page leaf: the leaf itself, or each tensor
    of a sharded pool's per-shard tuple once."""
    if torch.is_tensor(leaf):
        return [leaf]
    return list({id(t): t for t in leaf}.values())


def put_rows(name: str, leaf, dim: int, index: torch.Tensor, src: torch.Tensor) -> None:
    """``index_copy_(dim, index, src)`` into page leaf ``name`` on every
    shard: a tensor as it is; shard ``r`` of a split ``k_e`` takes its kv
    heads of ``src`` (the axis after ``dim``), every distinct copy of a
    replicated leaf all of ``src``."""
    if torch.is_tensor(leaf):
        leaf.index_copy_(dim, index, src)
    elif name == HEAD_SPLIT:
        h = src.shape[dim + 1] // len(leaf)
        for r, t in enumerate(leaf):
            t.index_copy_(dim, index.to(t.device), src.narrow(dim + 1, r * h, h).to(t.device))
    else:
        for t in leaf_copies(leaf):
            t.index_copy_(dim, index.to(t.device), src.to(t.device))


def take_rows(name: str, leaf, dim: int, index: torch.Tensor, out: torch.Tensor) -> None:
    """Rows ``index`` of page leaf ``name``'s axis ``dim`` with every kv
    head into ``out`` (on the device of the leaf's first tensor): a split
    ``k_e``'s shards read and concatenated in shard order, a replicated
    leaf read from its first copy."""
    if name != HEAD_SPLIT or torch.is_tensor(leaf):
        torch.index_select(first(leaf), dim, index, out=out)
    else:
        torch.cat([torch.index_select(t, dim, index.to(t.device)).to(out.device)
                   for t in leaf], dim + 1, out=out)


#: the hash chain's root "parent" digest (the reference's, so keys agree)
_HASH_ROOT = b"elitekv-prefix-v1"


def block_hash(parent: bytes, tokens) -> bytes:
    """Key of one full token block: ``sha256(parent ‖ int32 tokens)``.  The
    parent makes the key commit to every token before the block."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def prefix_block_hashes(tokens, block_size: int) -> List[bytes]:
    """Chained hashes of every full ``block_size``-token block of
    ``tokens``; a partial tail block has none (it is never cached)."""
    toks = np.asarray(tokens, np.int32)
    out: List[bytes] = []
    parent = _HASH_ROOT
    for i in range(len(toks) // block_size):
        parent = block_hash(parent, toks[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


class PrefixCache:
    """Content-addressed map from chained block hashes to physical blocks,
    with LRU retention of blocks no chain references.

    A cached block whose refcount drops to 0 is *retained* (still servable
    to lookups) instead of freed, and reclaimed oldest first only when the
    allocator runs dry.  A cached block is never rewritten in place: shared
    blocks are copied on write, and a sole owner about to rewrite one first
    drops its claim (``invalidate``)."""

    def __init__(self):
        self._by_hash: Dict[bytes, int] = {}          # chain hash → block
        self._by_block: Dict[int, bytes] = {}         # block → chain hash
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self.hits = 0                                 # lookups that shared >= 1 block
        self.misses = 0                               # lookups that shared none
        self.hit_tokens = 0                           # tokens served from the cache
        self.lookup_tokens = 0                        # tokens presented to lookups
        self.reclaimed = 0                            # retained blocks evicted

    @property
    def num_cached(self) -> int:
        return len(self._by_hash)

    @property
    def num_retained(self) -> int:
        return len(self._lru)

    def get(self, h: bytes) -> Optional[int]:
        return self._by_hash.get(h)

    def is_cached(self, block: int) -> bool:
        return block in self._by_block

    def claim(self, h: bytes, block: int) -> bool:
        """Register ``block`` as the home of chain hash ``h``; the first
        claim wins (a duplicate keeps the existing block)."""
        if h in self._by_hash or block in self._by_block:
            return False
        self._by_hash[h] = block
        self._by_block[block] = h
        return True

    def on_ref(self, block: int) -> None:
        """``block`` gained a reference: it leaves the reclaimable LRU."""
        self._lru.pop(block, None)

    def retain(self, block: int) -> bool:
        """``block``'s refcount hit 0: keep it (most recently used) if it is
        cached → True; False means the pool frees it."""
        if block not in self._by_block:
            return False
        self._lru[block] = None
        self._lru.move_to_end(block)
        return True

    def invalidate(self, block: int) -> None:
        """Drop ``block``'s content claim; the block stays where it is."""
        h = self._by_block.pop(block, None)
        if h is not None:
            del self._by_hash[h]
        self._lru.pop(block, None)

    def reclaim(self, n: int) -> List[int]:
        """Evict up to ``n`` retained blocks, least recently used first,
        dropping their claims → the blocks, now unowned."""
        out: List[int] = []
        while len(out) < n and self._lru:
            block, _ = self._lru.popitem(last=False)
            del self._by_hash[self._by_block.pop(block)]
            self.reclaimed += 1
            out.append(block)
        return out


def attn_cache_floats_per_token(cfg: ModelConfig) -> int:
    return cfg.elitekv.cache_per_token_per_layer(cfg.n_kv_heads, cfg.head_dim)


def model_cache_floats_per_token(cfg: ModelConfig) -> int:
    """Cache floats per token over the attention layers (Mamba layers keep
    no per-token cache)."""
    return cfg.n_attn_layers * attn_cache_floats_per_token(cfg)


def ssm_state_floats(cfg: ModelConfig, batch: int) -> int:
    """Floats of Mamba state for ``batch`` sequences, whatever their length:
    each SSM layer's conv window and ``d_inner × N`` state."""
    n_ssm = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "ssm")
    per = (cfg.ssm_conv - 1) * cfg.d_inner + cfg.d_inner * cfg.ssm_state
    return n_ssm * per * batch


def cache_ratio(cfg_elite: ModelConfig, cfg_base: ModelConfig) -> float:
    """Attention-KV compression ratio vs the unmodified model."""
    a = model_cache_floats_per_token(cfg_elite)
    b = model_cache_floats_per_token(cfg_base)
    return a / b if b else 1.0


def measured_cache_bytes(cache, batch: int, max_len: int) -> Dict[str, int]:
    """Bytes held by a live contiguous cache (``lm.init_cache``), split
    attention rows vs Mamba ``conv``/``ssm`` state as the reference reports
    them."""
    attn = ssm = 0
    for layer in cache["blocks"].values():
        for name, t in layer.items():
            nbytes = t.numel() * t.element_size()
            if name in ("conv", "ssm"):
                ssm += nbytes
            else:
                attn += nbytes
    return {"attn_bytes": attn, "ssm_bytes": ssm,
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

    def reset(self) -> None:
        """Every block free again, in the fresh allocator's order (the
        lifetime counters are kept)."""
        self._free = list(range(self.num_blocks - 1, -1, -1))


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
    blocks_shared: int = 0     # blocks referenced by more than one chain
    blocks_retained: int = 0   # refcount-0 prefix-cache blocks (reclaimable)
    cow_copies: int = 0        # lifetime copy-on-write block copies
    dtype: str = "float32"
    bytes_per_token: int = 0


class PagedKVPool:
    """Block-paged device storage for EliteKV's compressed cache streams.

    ``pages["p0"][name]`` is ``[n_layers, n_slots, ...]`` with
    ``n_slots = num_blocks · block_size``; token ``t`` of block ``b`` lives at
    flat slot ``b · block_size + t``.  ``dtype`` is ``"float32"`` or
    ``"int8"`` (or the torch dtype).  ``tracer`` receives the pool events.
    Only attention-only stacks of one layer position page (dense, or MoE
    in every layer); any other is a ``ValueError``.  ``mesh`` (a
    ``TPMesh``) places the pages over its devices (module docstring) and
    takes the place of ``device``, which becomes ``devices[0]``; a ``tp``
    that does not divide the kv heads is a ``ValueError``.
    """

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 device="cuda", dtype="float32", block_summaries: bool = False,
                 tracer=None, mesh=None):
        if not cfg.elitekv.enabled:
            raise ValueError("the paged pool stores EliteKV compressed streams only")
        if cfg.n_attn_layers != cfg.num_layers:
            raise ValueError("paged serving supports attention-only stacks: "
                             f"{cfg.name} has Mamba layers (serve it with generate)")
        if cfg.block_period != 1:
            raise ValueError(f"the paged pool holds one layer position; {cfg.name} "
                             f"repeats every {cfg.block_period} layers")
        quantized = quant.is_int8(dtype)
        if not quantized and dtype not in ("float32", torch.float32):
            raise ValueError(f"pool dtype {dtype!r}: expected 'float32' or 'int8'")
        self.dtype = torch.int8 if quantized else torch.float32
        self.trace = tracer or NULL_TRACER
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.tp
        if cfg.n_kv_heads % self.tp:
            raise ValueError(f"tp={self.tp} does not divide {cfg.name}'s {cfg.n_kv_heads} kv "
                             f"heads: pad the config first "
                             f"(distributed/sharding.py::pad_cfg_for_tp)")
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        self.allocator = BlockAllocator(num_blocks)
        self._tables: Dict[int, List[int]] = {}   # seq_id → block chain
        self._lengths: Dict[int, int] = {}        # seq_id → live token count
        self._refcount: Dict[int, int] = {}       # block → chains referencing it
        self.prefix: Optional[PrefixCache] = None  # set by BlockManager
        self.cow_copies = 0                       # lifetime copy-on-write count
        e = cfg.elitekv
        n_slots = num_blocks * block_size
        tails = {"k_e": (cfg.n_kv_heads, 2 * e.elite_r)}
        if e.lrd == "joint":
            tails["c"] = (e.d_ckv,)
        else:
            tails["c_k"] = (e.d_ck,)
            tails["c_v"] = (e.d_cv,)
        L = cfg.num_layers
        shapes = {}
        for name, tail in tails.items():
            shapes[name] = ((L, n_slots) + tail, self.dtype)
            if quantized:
                shapes[name + "_scale"] = ((L, n_slots), torch.float32)
        if block_summaries:
            key = "c" if e.lrd == "joint" else "c_k"
            for sfx in BLOCK_SUMMARY_SUFFIXES:
                shapes[key + sfx] = ((L, num_blocks) + tails[key], torch.float32)
        if self.tp == 1:
            leaves = {name: torch.zeros(shape, dtype=dt, device=self.device)
                      for name, (shape, dt) in shapes.items()}
        else:
            specs = serving_page_pspecs(cfg, plan_for_mesh({"model": self.tp}))
            leaves = {name: self._placed(shape, dt, specs[name])
                      for name, (shape, dt) in shapes.items()}
        self.pages = {"p0": leaves}

    def _placed(self, shape, dtype, spec) -> tuple:
        """A leaf of ``shape`` over the mesh by its ``spec``: split on the
        axis the spec gives the TP axis (one shard per device of the mesh),
        else one replica per distinct device."""
        devices = self.mesh.devices
        if "model" in spec:
            axis = spec.index("model")
            shape = shape[:axis] + (shape[axis] // self.tp,) + shape[axis + 1:]
            return tuple(torch.zeros(shape, dtype=dtype, device=d) for d in devices)
        copies = {d: torch.zeros(shape, dtype=dtype, device=d) for d in self.mesh.distinct()}
        return tuple(copies[d] for d in devices)

    # -- allocation (prefix-cache aware) ------------------------------------
    def _alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks at refcount 1, reclaiming LRU-retained
        prefix blocks (oldest first) when the free list alone is short."""
        short = n - self.allocator.num_free
        if short > 0 and self.prefix is not None:
            evicted = self.prefix.reclaim(short)
            if evicted:
                self.allocator.free(evicted)
                self.trace.instant("free", track="pool", cat="pool", seq=-1,
                                   blocks=evicted, reason="reclaim")
        got = self.allocator.alloc(n)       # raises OutOfBlocks if still short
        for b in got:
            self._refcount[b] = 1
        return got

    def _release_blocks(self, blocks: Sequence[int], seq_id: int, reason: str) -> None:
        """Drop one reference per block.  A block at refcount 0 returns to
        the free list, or stays retained in the prefix cache's LRU when it
        backs a cached prefix."""
        freed: List[int] = []
        retained: List[int] = []
        for b in blocks:
            self._refcount[b] -= 1
            if self._refcount[b] > 0:
                continue                    # another chain still reads it
            del self._refcount[b]
            if self.prefix is not None and self.prefix.retain(b):
                retained.append(b)
            else:
                freed.append(b)
        if freed:
            self.allocator.free(freed)
            self.trace.instant("free", track="pool", cat="pool", seq=seq_id,
                               blocks=freed, reason=reason)
        if retained:
            self.trace.instant("retain", track="pool", cat="cache", seq=seq_id,
                               blocks=retained)

    # -- sequence lifecycle -------------------------------------------------
    def ensure_capacity(self, seq_id: int, length: int) -> None:
        """Grow ``seq_id``'s chain to hold ``length`` tokens (allocating
        lazily on first touch).  Raises OutOfBlocks when the pool is full."""
        table = self._tables.setdefault(seq_id, [])
        need = -(-length // self.block_size) - len(table)
        if need > 0:
            got = self._alloc(need)
            table.extend(got)
            self.trace.instant("alloc", track="pool", cat="pool", seq=seq_id,
                               blocks=got, length=length)
        self._lengths[seq_id] = max(self._lengths.get(seq_id, 0), length)

    def share_prefix(self, seq_id: int, blocks: Sequence[int]) -> None:
        """Splice cached ``blocks`` into ``seq_id``'s fresh chain as its
        head; each gains a reference.  The chain's length becomes exactly
        the shared coverage."""
        table = self._tables.setdefault(seq_id, [])
        assert not table and not self._lengths.get(seq_id, 0), \
            (seq_id, "prefix sharing requires a fresh chain")
        for b in blocks:
            self._refcount[b] = self._refcount.get(b, 0) + 1
            if self.prefix is not None:
                self.prefix.on_ref(b)
        table.extend(blocks)
        self._lengths[seq_id] = len(blocks) * self.block_size
        if blocks:
            self.trace.instant("share", track="pool", cat="cache", seq=seq_id,
                               blocks=list(blocks))

    def make_private(self, seq_id: int, start: int, end: int) -> None:
        """Copy-on-write barrier: before ``seq_id`` writes positions
        ``[start, end)``, give it sole ownership of every covered block.  A
        block another chain references is copied on the device into a fresh
        block (slot leaves copy the block's ``block_size`` slots, summary
        leaves its one row) and the writer's chain repoints; a sole-owner
        block that backs a cached prefix just drops its claim.  The copies
        are issued on the current stream, so they precede the writes the
        caller issues next."""
        if end <= start:
            return
        table = self._tables.get(seq_id, [])
        bs = self.block_size
        for bi in range(start // bs, min(-(-end // bs), len(table))):
            b = table[bi]
            if self._refcount.get(b, 0) > 1:
                new = self._alloc(1)[0]
                for name, leaf in self.pages["p0"].items():
                    for arr in leaf_copies(leaf):      # every shard and copy
                        if is_block_summary(name):
                            arr[:, new] = arr[:, b]
                        else:
                            arr[:, new * bs:(new + 1) * bs] = arr[:, b * bs:(b + 1) * bs]
                self._refcount[b] -= 1
                table[bi] = new
                self.cow_copies += 1
                self.trace.instant("cow", track="pool", cat="cache", seq=seq_id,
                                   block=b, copy=new)
            elif self.prefix is not None and self.prefix.is_cached(b):
                self.prefix.invalidate(b)   # sole owner rewrites in place

    def can_fit(self, extra_tokens: int) -> bool:
        retained = self.prefix.num_retained if self.prefix is not None else 0
        return (self.allocator.num_free + retained) * self.block_size >= extra_tokens

    def truncate(self, seq_id: int, length: int) -> None:
        """Shrink ``seq_id`` to ``length`` tokens, releasing the tail blocks
        the shorter chain no longer covers (speculative decode rolls a
        rejected window tail back here).  Pages are never rewritten: later
        growth writes over the stale slots.  A released block another chain
        still references is only un-linked, never freed or rolled back; the
        next write into a kept block that is still shared goes through
        ``make_private`` first.  An unknown sequence accepts only
        ``length == 0`` and stays unknown; growing through ``truncate`` is
        an assertion; 0 keeps the empty chain registered."""
        assert length >= 0, length
        if seq_id not in self._lengths:
            assert length == 0, (seq_id, length)
            return
        assert length <= self._lengths[seq_id], (seq_id, length, self._lengths[seq_id])
        table = self._tables.get(seq_id, [])
        keep = -(-length // self.block_size)
        if keep < len(table):
            dropped = table[keep:]
            del table[keep:]
            self._release_blocks(dropped, seq_id, reason="truncate")
        self._lengths[seq_id] = length

    def free_seq(self, seq_id: int) -> None:
        self._release_blocks(self._tables.pop(seq_id, []), seq_id, reason="release")
        self._lengths.pop(seq_id, None)

    def reset(self) -> None:
        """Forget every sequence: all blocks free, no chains, lengths or
        refcounts, a fresh prefix cache if there is one.  The pages keep
        their contents (nothing reads a slot before it is written again)."""
        self.allocator.reset()
        self._tables.clear()
        self._lengths.clear()
        self._refcount.clear()
        self.cow_copies = 0
        if self.prefix is not None:
            self.prefix = PrefixCache()

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
    def floats_per_token(self) -> int:
        """Cache elements per token over the model's layers (the formula,
        whatever the pool's dtype)."""
        return model_cache_floats_per_token(self.cfg)

    def _leaf_bytes(self, name: str, leaf) -> int:
        """A leaf's bytes as one device would hold it whole: a split
        ``k_e``'s shards summed, a replicated leaf once."""
        parts = leaf if name == HEAD_SPLIT and not torch.is_tensor(leaf) else [first(leaf)]
        return sum(t.numel() * t.element_size() for t in parts)

    def bytes_per_token(self) -> int:
        """Pool bytes per token slot, summed over every page leaf: int8 rows
        and their f32 scales in a quantized pool, and the block summaries
        spread over their blocks' slots.  Global: a sharded pool counts its
        split ``k_e`` whole and each replicated leaf once."""
        n_slots = self.num_blocks * self.block_size
        return sum(self._leaf_bytes(name, a) // n_slots
                   for layer in self.pages.values() for name, a in layer.items())

    def bytes_per_token_per_device(self) -> int:
        """Pool bytes per token slot resident on each device of the mesh:
        the split ``k_e`` counts ``1/tp`` of its bytes, every replicated
        leaf in full (the reference's formula).  ``bytes_per_token()`` at
        tp 1."""
        n_slots = self.num_blocks * self.block_size
        return sum(self._leaf_bytes(name, a) // (self.tp if name == HEAD_SPLIT else 1)
                   // n_slots for layer in self.pages.values() for name, a in layer.items())

    def leaf_shape(self, name: str) -> Tuple[int, ...]:
        """Page leaf ``name``'s shape with every kv head (a tp-1 pool's)."""
        t = first(self.pages["p0"][name])
        if name == HEAD_SPLIT and self.tp > 1:
            return tuple(t.shape[:2]) + (t.shape[2] * self.tp,) + tuple(t.shape[3:])
        return tuple(t.shape)

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
            blocks_shared=sum(1 for c in self._refcount.values() if c > 1),
            blocks_retained=self.prefix.num_retained if self.prefix is not None else 0,
            cow_copies=self.cow_copies,
            dtype=str(self.dtype).removeprefix("torch."), bytes_per_token=bpt)


@dataclasses.dataclass
class SwappedSeq:
    """Host copy of a preempted sequence's cached streams (swap eviction).

    ``host`` is one byte buffer — pinned when the pool is on a CUDA card —
    holding, per page leaf, the sequence's ``length`` slots in *token
    order* (``[n_layers, length, ...]``) or, for block-summary leaves, its
    chain's rows in *chain order* (``[n_layers, n_chain_blocks, ...]``), so
    swap-in may land on other blocks.  ``layout`` is ``(name, dtype, shape,
    byte offset)`` per leaf.  ``ready`` marks the end of the device→host
    copy; ``leaves()`` waits for it before the host reads the buffer."""
    length: int
    host: torch.Tensor
    layout: Tuple[Tuple[str, torch.dtype, Tuple[int, ...], int], ...]
    ready: Optional["torch.cuda.Event"] = None

    def nbytes(self) -> int:
        return sum(_nbytes(dt, shape) for _, dt, shape, _ in self.layout)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """{leaf name: host tensor}, once the copy has landed."""
        if self.ready is not None:
            self.ready.synchronize()
        return _unpack(self.host, self.layout)


def _nbytes(dtype: torch.dtype, shape) -> int:
    return int(np.prod(shape)) * dtype.itemsize


def _copy_events(trace, dev):
    """Two timing CUDA events for a traced swap copy on the card, else None."""
    if not trace.enabled or dev.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _unpack(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Typed views of a packed byte buffer, one per ``layout`` entry."""
    return {name: buf[off:off + _nbytes(dt, shape)].view(dt).view(shape)
            for name, dt, shape, off in layout}


class BlockManager:
    """Admission + eviction policy over a ``PagedKVPool``.

    * ``"preempt"`` (default) — no reservation: a request is admitted once
      its next allocation (first prefill chunk, or a swapped prefix being
      restored) fits; residents grow on demand, and growth may raise
      ``OutOfBlocks``, which the scheduler resolves by preempting the
      youngest resident.
    * ``"watermark"`` — the worst-case blocks still owed to every resident
      are held back, so growth never fails.

    Eviction: ``preempt_recompute`` frees the victim's blocks (its prefix is
    re-prefilled after re-admission); ``preempt_swap_out`` / ``swap_in``
    copy its cached tokens to host memory and back onto a fresh chain.

    With ``prefix_cache=True`` the manager runs the cross-request prefix
    cache: ``lookup_prefix`` splices cached full prompt blocks into a fresh
    chain, ``register_prefix`` claims a chain's freshly written full blocks,
    and ``prepare_write`` is the copy-on-write barrier before a scatter.
    Release, preemption and ``truncate`` respect refcounts: a block another
    chain references is never freed or rolled back.
    """

    def __init__(self, pool: PagedKVPool, policy: str = "preempt",
                 prefix_cache: bool = False):
        if policy not in ("preempt", "watermark"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.pool = pool
        self.policy = policy
        if prefix_cache and pool.prefix is None:
            pool.prefix = PrefixCache()
        self._resident_worst: Dict[int, int] = {}   # seq_id → worst-case blocks
        self.preemptions = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_bytes = 0                      # lifetime device→host bytes

    @property
    def prefix(self) -> Optional[PrefixCache]:
        return self.pool.prefix

    # -- prefix cache -------------------------------------------------------
    def lookup_prefix(self, seq_id: int, tokens) -> int:
        """Share the longest cached chain of full ``tokens`` blocks into
        ``seq_id``'s fresh chain → tokens covered (0 on a miss).  The hit
        stops one token short of ``len(tokens)``: the final prompt token is
        always prefilled, so its logits row exists."""
        pc = self.prefix
        if pc is None or len(tokens) == 0:
            return 0
        bs = self.pool.block_size
        pc.lookup_tokens += len(tokens)
        blocks: List[int] = []
        for h in prefix_block_hashes(tokens, bs)[:(len(tokens) - 1) // bs]:
            b = pc.get(h)
            if b is None:
                break
            blocks.append(b)
        if not blocks:
            pc.misses += 1
            return 0
        self.pool.share_prefix(seq_id, blocks)
        pc.hits += 1
        pc.hit_tokens += len(blocks) * bs
        return len(blocks) * bs

    def register_prefix(self, seq_id: int, tokens) -> int:
        """Claim every full block of ``tokens`` that ``seq_id``'s chain has
        written for future lookups (first claim wins) → new claims."""
        pc = self.prefix
        if pc is None:
            return 0
        bs = self.pool.block_size
        table = self.pool.block_table(seq_id)
        n_full = min(len(tokens) // bs, self.pool.length(seq_id) // bs, len(table))
        claimed = sum(pc.claim(h, table[i])
                      for i, h in enumerate(prefix_block_hashes(tokens, bs)[:n_full]))
        if claimed:
            self.pool.trace.instant("prefix_register", track="pool", cat="cache",
                                    seq=seq_id, blocks=claimed)
        return claimed

    def prepare_write(self, seq_id: int, start: int, end: int) -> None:
        """Copy-on-write barrier for a scatter into positions ``[start,
        end)`` of ``seq_id``'s chain (nothing to do without the cache)."""
        if self.prefix is not None:
            self.pool.make_private(seq_id, start, end)

    # -- admission ----------------------------------------------------------
    @property
    def reserved_blocks(self) -> int:
        """Watermark: worst-case blocks still owed to registered residents."""
        return sum(max(0, w - len(self.pool.block_table(sid)))
                   for sid, w in self._resident_worst.items())

    def can_admit(self, first_alloc_tokens: int, worst_case_blocks: int) -> bool:
        if self.policy == "watermark":
            # retained prefix blocks count as free: growth reclaims them
            retained = self.prefix.num_retained if self.prefix is not None else 0
            return (self.pool.allocator.num_free + retained - self.reserved_blocks
                    >= worst_case_blocks)
        return self.pool.can_fit(first_alloc_tokens)

    def register(self, seq_id: int, worst_case_blocks: int) -> None:
        self._resident_worst[seq_id] = worst_case_blocks

    # -- growth / release ---------------------------------------------------
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
        window tail): its tail blocks are released at once (a block another
        chain reads is only un-linked) and residency is kept, so the
        watermark reservation grows back by exactly the released blocks."""
        self.pool.truncate(seq_id, length)

    # -- eviction -----------------------------------------------------------
    def preempt_recompute(self, seq_id: int) -> None:
        self.release(seq_id)
        self.preemptions += 1

    def preempt_swap_out(self, seq_id: int, length: int) -> Optional[SwappedSeq]:
        """Copy ``length`` cached tokens to host memory, then free the chain.
        ``length`` comes from the request's state, not ``pool.length``: a
        growth whose write never ran must not be swapped.  The slots are
        gathered on the device into one buffer and copied once, without
        waiting, into pinned host memory; freeing the blocks after the
        gather is safe because later writes to them queue behind it.  The
        ``swap_out`` span covers the host window; traced on the card, its
        ``device_ms`` times the gather and the copy.
        → None when nothing is cached yet (a plain requeue)."""
        self.preemptions += 1
        if length <= 0:
            self.release(seq_id)
            return None
        pool = self.pool
        dev = pool.device
        ev = _copy_events(pool.trace, dev)
        timed = {"device_ms": DeviceDuration(*ev)} if ev else {}
        with pool.trace.span("swap_out", track="pool", cat="swap", seq=seq_id,
                             length=length, **timed):
            slots = torch.as_tensor(pool.flat_slots(seq_id, np.arange(length)), device=dev)
            chain = torch.as_tensor(pool.block_table(seq_id)[:-(-length // pool.block_size)],
                                    dtype=torch.int64, device=dev)
            layout, off = [], 0
            for name, leaf in pool.pages["p0"].items():
                n = len(chain) if is_block_summary(name) else length
                full = pool.leaf_shape(name)
                shape = (full[0], n) + full[2:]
                dtype = first(leaf).dtype
                layout.append((name, dtype, shape, off))
                off += -(-_nbytes(dtype, shape) // 16) * 16     # 16-byte aligned leaves
            if ev:
                ev[0].record(torch.cuda.current_stream(dev))
            staging = torch.empty(off, dtype=torch.uint8, device=dev)
            for name, view in _unpack(staging, layout).items():
                idx = chain if is_block_summary(name) else slots
                take_rows(name, pool.pages["p0"][name], 1, idx, view)
            ready = None
            if dev.type == "cuda":
                host = torch.empty(off, dtype=torch.uint8, pin_memory=True)
                host.copy_(staging, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host = staging
            if ev:
                ev[1].record(torch.cuda.current_stream(dev))
            self.release(seq_id)
            swapped = SwappedSeq(length=length, host=host, layout=tuple(layout), ready=ready)
        self.swap_outs += 1
        self.swapped_bytes += swapped.nbytes()
        return swapped

    def swap_in(self, seq_id: int, swapped: SwappedSeq) -> None:
        """Allocate a fresh chain and scatter the host copy back, byte for
        byte.  Raises ``OutOfBlocks`` if it does not fit (the caller defers
        admission).  The host→device copy queues on the stream behind the
        swap-out's device→host copy.  The ``swap_in`` span covers the host
        window; traced on the card, its ``device_ms`` times the copy and the
        scatter."""
        pool = self.pool
        pool.ensure_capacity(seq_id, swapped.length)
        dev = pool.device
        ev = _copy_events(pool.trace, dev)
        timed = {"device_ms": DeviceDuration(*ev)} if ev else {}
        with pool.trace.span("swap_in", track="pool", cat="swap", seq=seq_id,
                             length=swapped.length, **timed):
            slots = torch.as_tensor(pool.flat_slots(seq_id, np.arange(swapped.length)),
                                    device=dev)
            chain = torch.as_tensor(
                pool.block_table(seq_id)[:-(-swapped.length // pool.block_size)],
                dtype=torch.int64, device=dev)
            if ev:
                ev[0].record(torch.cuda.current_stream(dev))
            staged = swapped.host.to(dev, non_blocking=True)
            for name, view in _unpack(staged, swapped.layout).items():
                idx = chain if is_block_summary(name) else slots
                put_rows(name, pool.pages["p0"][name], 1, idx, view)
            if ev:
                ev[1].record(torch.cuda.current_stream(dev))
        self.swap_ins += 1
