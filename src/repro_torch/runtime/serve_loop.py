"""Serving: lockstep batches over a contiguous cache, and continuous
batching over the paged compressed cache.

Counterpart of the JAX package's ``runtime/serve_loop.py``.  Two tiers:

* ``generate`` — lockstep batched greedy decoding of equal-length prompts
  over a contiguous cache (``lm.init_cache``), EliteKV or baseline GQA
  attention, Mamba state or both (every family); the argmax stays on the
  device.
* ``Scheduler`` (EliteKV, attention-only stacks: dense or MoE; a vision
  model serves text prompts; an audio model is refused by both tiers) — requests
  queue with arrival times (in scheduler steps), are admitted into free
  *slots* mid-flight, prefill their prompts — whole at admission
  (``prefill_chunk_tokens=0``) or in fixed-size chunks, up to
  ``prefill_batch_lanes`` lanes' chunks packed
  into one forward — interleaved with one decode step over all
  ``max_slots`` lanes (idle lanes masked by length 0), and retire on EOS or
  token budget, recycling their pool blocks at once.  With
  ``admission="preempt"`` (default) a pool that runs dry mid-flight
  preempts the youngest resident, which is requeued at the head of the
  line and either recomputes its prefix (prompt + generated) on
  re-admission (``eviction="recompute"``) or has its cached streams copied
  to pinned host memory and restored byte for byte (``eviction="swap"``);
  either way its token stream is unchanged.

Decoding samples per request: ``temperature <= 0`` is greedy argmax;
otherwise nucleus (``top_p``) sampling with the request's ``seed``, batched
over the lanes on the device (``sample_tokens``).  Token ``i`` of a request
draws from the Threefry key ``fold_in(key(seed), i)`` (``runtime/prng.py``,
bit for bit the reference's), so the draw does not depend on the slot, the
step or a preemption that served it.  The noise follows the sorted
position, so a draw can move when two near-equal logits swap order under
a rounding-level change.

Every forward of both tiers runs under ``torch.no_grad()`` (``generate``,
``Scheduler.step``): parameters that still require grad (weights taken
in the middle of training) build no autograd graph here, and the pool's and cache's in-place
writes carry no history.

``prefix_cache=True`` shares full prompt blocks across requests: admission
probes the content-addressed cache (``BlockManager.lookup_prefix``) and
prefill resumes at the first miss, freshly prefilled blocks are registered
after every chunk, and every write goes through the copy-on-write barrier
(``prepare_write`` inside ``_grow_or_preempt``), so streams equal the
cache-off run's.

``cache_dtype="int8"`` serves from an int8 pool (per-slot scales, fused
dequantization in the decode kernels); ``sparse_topk_blocks > 0`` decodes
over the block-top-k selection plus ``sparse_recent_blocks`` newest blocks.
Partial-width sparse decode with ``admission="preempt"`` needs
``eviction="swap"``: a recompute re-prefills densely and cannot reproduce
streams that lower layers attended sparsely, while swap restores the pages
and block summaries exactly (``admission="watermark"``, which never
preempts, is sound too).

``speculate_k > 0`` replaces the one-token decode step with a
self-speculative macro-step: ``k`` batched decode forwards of a draft model
(``lm.make_draft_params``: the joint factors truncated to ``draft_rank``,
0 = the full model) propose tokens, one verify forward of the full model
(``lm.apply_verify_paged``) scores all ``k+1`` window positions per lane,
and the chain is truncated back over what is not kept.  Greedy lanes keep
the argmax-matching prefix plus one corrected or bonus token; sampled
lanes accept by rejection sampling against the request's nucleus
distribution (``speculative_accept`` / ``residual_sample``, coins from the
same count-folded PRNG), so a full-rank draft gives plain decode's stream
up to the verify and decode forwards' rounding.
Speculation with sparse decode is a ``ValueError`` (a verify window has no
single selection query).

``Scheduler(mesh=...)`` (a ``launch.mesh.TPMesh``) serves tensor-parallel,
as the reference's ``mesh=`` does: the pool's ``k_e`` pages are split by kv
head over the mesh (``PagedKVPool(mesh=)``) and every paged forward, draft
forwards included, runs its decode and verify attention once per head
shard (``kernels/ops.py``'s ``*_tp`` wrappers); everything else runs
full-head on ``mesh.devices[0]``, where the params live.  The host
bookkeeping (blocks, admission, preemption, swap, prefix sharing) is the
same at every tp, so a run at tp > 1 takes tp 1's decisions and gives its
streams.

Observability, as in the reference: ``Scheduler(tracer=..., metrics=...)``
records the run into a ``repro_torch.obs.Tracer`` — a span per step phase
on the ``scheduler`` track, request lifecycle instants (``submit``,
``admit``, ``prefix_hit``/``prefix_miss``, ``preempt``, ``prefill_chunk``,
``first_token``, ``retire``, ``sparse_select``), ``req<uid>`` residency on
``slot<i>``, pool counters and the pool's own events — and meters it into a
``MetricsRegistry`` (a fresh one per scheduler unless one is passed).  The
hooks read clocks and host state only: a traced run gives the untraced
run's tokens bit for bit, and waits for the card no more often.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import (BlockManager, OutOfBlocks, PagedKVPool,
                                    SwappedSeq, measured_cache_bytes)
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import lm, moe
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime import prng

#: Host-observable phases of one scheduler step (``ServeReport.phase_ms``
#: keys); ``other`` is the residual, so the phases sum to the step wall time.
#: ``draft``/``verify``/``accept`` are the speculative macro-step's, ``swap``
#: the host-swap copies'.
PHASES = ("prefill", "decode", "draft", "verify", "sample", "accept", "swap", "other")


def make_prefill_step(cfg: ModelConfig, moe_impl: str = "ragged", constrain=None):
    """→ ``prefill_step(params, buffers, batch, cache) -> logits``, filling
    ``cache`` in place; ``constrain`` is ``lm.apply_prefill``'s sharding
    hook (placed params, batch and cache make it the sharded step)."""
    def prefill_step(params, buffers, tokens, cache):
        return lm.apply_prefill(params, buffers, cfg, tokens, cache, moe_impl=moe_impl,
                                constrain=constrain)

    return prefill_step


def make_decode_step(cfg: ModelConfig, moe_impl: str = "ragged", constrain=None):
    """→ ``decode_step(params, buffers, tokens, cache) -> (next [B] int64,
    logits)``: the greedy next token stays on the device.  ``constrain`` is
    ``lm.apply_decode``'s sharding hook (placed params, tokens and cache
    make it the sharded step; the argmax over vocabulary-sharded logits
    gathers them, as the reference's does under GSPMD)."""
    def decode_step(params, buffers, tokens, cache):
        logits = lm.apply_decode(params, buffers, cfg, tokens, cache, moe_impl=moe_impl,
                                 constrain=constrain)
        last = logits[:, -1]
        if is_dtensor(last):               # the vocabulary gathered, lanes kept sharded
            from torch.distributed.tensor import Replicate, Shard
            last = last.redistribute(last.device_mesh, [
                p if p == Shard(0) else Replicate() for p in last.placements])
        return last.argmax(dim=-1), logits

    return decode_step


@dataclasses.dataclass
class ServeStats:
    """Counters for the lockstep ``generate`` path.

    ``prefill_tokens``  — prompt tokens pushed through the prefill forward
                          (batch × prompt length).
    ``decoded_tokens``  — tokens produced (batch × new tokens).
    ``cache_bytes``     — measured bytes of the attention KV cache allocated
                          for the run (the paper's compression shows here).
    ``ssm_bytes``       — measured bytes of the Mamba ``(conv, ssm)`` states
                          beside it (per sequence, not per token).
    ``step_ms``         — the port's own: host-clock ms of the prefill
                          step, then of each decode step, each ending in a
                          device synchronisation.
    """
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    cache_bytes: int = 0
    ssm_bytes: int = 0
    step_ms: List[float] = dataclasses.field(default_factory=list)


def _check_text(cfg: ModelConfig) -> None:
    """Both tiers serve token prompts: an audio model has no token
    embedding (its entry points take frames), so it is refused here, where
    the reference fails on the missing ``frames``."""
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name} is an audio model with no token embedding: it "
                         "takes frame embeddings through lm's entry points, not token "
                         "prompts (the reference cannot serve it either)")


@torch.no_grad()
def generate(params, buffers, cfg: ModelConfig, prompts, max_new_tokens: int,
             device="cuda", moe_impl: str = "ragged") -> Tuple[np.ndarray, ServeStats]:
    """Greedy generation for a batch of equal-length prompts over a
    contiguous f32 cache of ``prompt + max_new_tokens`` rows.

    prompts [B, S_prompt] int → generated [B, max_new_tokens] int32.
    ``params``/``buffers`` must live on ``device``.  Prompts are text: a
    vision model serves them without patches; an audio model is refused
    (``_check_text``).  MoE layers dispatch by ``moe_impl`` in every forward.
    """
    _check_text(cfg)
    moe.check_impl(moe_impl)
    prompts = np.asarray(prompts, np.int32)
    B, Sp = prompts.shape
    max_len = Sp + max_new_tokens
    dev = torch.empty(0, device=device).device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cache = lm.init_cache(cfg, B, max_len, device=dev)
    prefill, decode = make_prefill_step(cfg, moe_impl), make_decode_step(cfg, moe_impl)
    stats = ServeStats(prefill_tokens=B * Sp, decoded_tokens=B * max_new_tokens)
    t0 = time.perf_counter()
    logits = prefill(params, buffers, torch.from_numpy(prompts).to(dev), cache)
    nxt = logits[:, -1].argmax(dim=-1)
    del logits
    outs = [nxt]
    for _ in range(max_new_tokens - 1):
        sync()
        t1 = time.perf_counter()
        stats.step_ms.append((t1 - t0) * 1e3)
        t0 = t1
        nxt, _ = decode(params, buffers, nxt[:, None], cache)
        outs.append(nxt)
    sync()
    stats.step_ms.append((time.perf_counter() - t0) * 1e3)
    measured = measured_cache_bytes(cache, B, max_len)
    stats.cache_bytes, stats.ssm_bytes = measured["attn_bytes"], measured["ssm_bytes"]
    return torch.stack(outs, dim=1).cpu().numpy().astype(np.int32), stats


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _gumbel_scores(logits, temps, top_ps, seeds, counts):
    """The reference sampler's pieces for every lane, by sorted position:
    logits / temperature sorted descending (stable, so equal logits keep
    token order), the Gumbel noise drawn for *sorted* positions from
    ``fold_in(key(seed), count)``, and the mass before each position.
    → (order [B,V] token ids, sorted scaled logits, noise, excluded mass)."""
    scaled = logits.float() / temps.float().clamp(min=1e-6)[:, None]
    order = torch.sort(-scaled, dim=-1, stable=True).indices
    sl = scaled.gather(-1, order)
    probs = torch.softmax(sl, dim=-1)
    noise = prng.gumbel(prng.fold_in(prng.key(seeds), counts), sl.shape[-1])
    return order, sl, noise, torch.cumsum(probs, dim=-1) - probs


def _nucleus(excl, top_ps):
    """A sorted position stays in the nucleus while the mass before it is
    under top_p; the first always stays."""
    kept = excl < top_ps.float()[:, None]
    kept[:, 0] = True
    return kept


def sample_tokens(logits, temps, top_ps, seeds, counts):
    """Batched per-request sampling, on ``logits``' device.

    logits [B,V]; temps/top_ps [B] f32; seeds/counts [B] int.  Lane ``i``
    draws from ``fold_in(key(seeds[i]), counts[i])`` (the count is the
    request's token index), the reference's ``categorical`` over its
    nucleus: the argmax of the sorted scaled logits plus Gumbel noise by
    sorted position.  ``temps[i] <= 0`` is the argmax itself, never a
    division by the clamped temperature.  → [B] int64."""
    greedy = logits.argmax(dim=-1)
    order, sl, noise, excl = _gumbel_scores(logits, temps, top_ps, seeds, counts)
    scores = (noise + sl).masked_fill(~_nucleus(excl, top_ps), float("-inf"))
    return torch.where(temps > 0, order.gather(-1, scores.argmax(-1, keepdim=True))[:, 0],
                       greedy)


#: PRNG fold salts of the speculative accept coin and the residual draw
_ACCEPT_SALT = 0x5BEC
_RESID_SALT = 0x5BED


def nucleus_probs(logits, temp: float, top_p: float) -> np.ndarray:
    """The categorical distribution ``sample_tokens`` draws from, as a dense
    float64 probability vector: the temperature-scaled softmax restricted
    to the smallest descending set whose mass reaches ``top_p`` (its first
    member always kept); tokens outside get exactly 0."""
    scaled = np.asarray(logits, np.float64) / max(float(temp), 1e-6)
    order = np.argsort(-scaled, kind="stable")
    sl = scaled[order]
    e = np.exp(sl - sl.max())
    probs = e / e.sum()
    cut = (np.cumsum(probs) - probs) >= top_p
    cut[0] = False                        # the first member survives even top_p=0
    sl = np.where(cut, -np.inf, sl)
    e = np.exp(sl - sl[0])                # sl[0] is always kept (finite max)
    p_sorted = e / e.sum()
    out = np.zeros_like(p_sorted)
    out[order] = p_sorted
    return out


def speculative_accept(token: int, p: np.ndarray, q: np.ndarray, u: float) -> bool:
    """Accept a draft ``token`` proposed from ``q`` against target ``p`` iff
    ``u <= p(token)/q(token)``; with ``residual_sample`` on rejection the
    emitted token is distributed as ``p``.  A token outside the target
    nucleus is never accepted, even where ``q(token) == 0``."""
    return p[token] > 0.0 and u * q[token] <= p[token]


def residual_sample(p: np.ndarray, q: np.ndarray, r: float) -> int:
    """Inverse-CDF draw from the normalized residual ``max(p - q, 0)``, the
    corrected token after a rejection; a residual that rounding left empty
    falls back to ``p``."""
    res = np.maximum(np.asarray(p, np.float64) - np.asarray(q, np.float64), 0.0)
    if res.sum() <= 1e-12:
        res = np.asarray(p, np.float64)
    nz = np.flatnonzero(res)
    cdf = np.cumsum(res[nz]) / res[nz].sum()
    return int(nz[min(np.searchsorted(cdf, r, side="right"), len(nz) - 1)])


def _spec_uniform(seed: int, count: int, salt: int) -> float:
    """Uniform [0,1) tied to (request seed, token index, salt), on the host:
    the count-folded PRNG of ``sample_tokens``, so acceptance decisions
    replay identically across preemptions."""
    return prng.uniform(prng.fold_in(prng.fold_in(prng.key(seed), count), salt))


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is in scheduler steps.

    ``temperature <= 0`` is greedy argmax; otherwise nucleus sampling from
    the smallest token set whose probability mass reaches ``top_p``, with a
    PRNG keyed on ``seed`` and folded with the token index — the same
    (seed, prompt) always yields the same tokens."""
    uid: int
    prompt: np.ndarray                    # [Sp] int32
    max_new_tokens: int
    arrival: float = 0.0
    temperature: float = 0.0              # 0 → greedy
    top_p: float = 1.0                    # nucleus mass (1 → full softmax)
    seed: int = 0                         # per-request PRNG seed (int32)
    # filled in by the scheduler:
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0                  # prefill-source tokens already cached
    prefill_src: Optional[np.ndarray] = None   # recompute source (None → prompt)
    swapped: Optional[SwappedSeq] = None  # host copy awaiting swap-in
    preempted_at: List[int] = dataclasses.field(default_factory=list)
    #   ^ len(generated) at each preemption (0 = preempted mid-prefill)
    prefix_hit_tokens: int = 0            # prompt tokens served from the prefix
                                          # cache (summed over re-admissions)
    submit_wall: float = 0.0
    first_token_wall: float = 0.0
    first_token_step: int = -1
    finish_step: int = -1
    finish_reason: str = ""               # "eos" | "budget"
    spec_proposed: int = 0                # draft tokens proposed for this request
    spec_accepted: int = 0                # draft tokens that survived verify

    def prefill_source(self) -> np.ndarray:
        """Tokens that must be cached before decode (re)starts: the prompt,
        or — after a preemption — prompt + generated prefix."""
        return self.prompt if self.prefill_src is None else self.prefill_src


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int = 4                    # concurrent sequences per decode step
    block_size: int = 16                  # tokens per pool block
    num_blocks: int = 128                 # pool capacity
    max_new_tokens: int = 64              # hard per-request generation cap
    max_len: int = 256                    # per-sequence token cap (table width)
    eos_id: Optional[int] = None
    prefill_bucket: int = 16              # one-shot prompts pad to a multiple
    prefill_chunk_tokens: int = 0         # per-lane chunk (0 → whole prompt)
    prefill_batch_lanes: int = 0          # lanes per chunked forward (0 → max_slots)
    admission: str = "preempt"            # "preempt" | "watermark"
    cache_dtype: str = "float32"          # pool pages: "float32" | "int8"
    sparse_topk_blocks: int = 0           # block top-k per decode (0 = dense)
    sparse_recent_blocks: int = 2         # newest blocks always attended
    speculate_k: int = 0                  # draft tokens per lane per step (0 = plain)
    draft_rank: int = 0                   # draft joint-factor rank (0 = full)
    eviction: str = "recompute"           # "recompute" | "swap" (pinned host memory)
    prefix_cache: bool = False            # share prompt blocks across requests (COW)

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def chunk_lanes(self) -> int:
        return self.prefill_batch_lanes or self.max_slots


def _prompt_buckets(finished: List[Request], edges: Tuple[int, ...]):
    """Partition finished requests by prompt length → (label, requests)."""
    lo = 0
    for hi in tuple(edges) + (None,):
        label = f"{lo + 1}-{hi}" if hi is not None else f">{lo}"
        yield label, [r for r in finished if lo < len(r.prompt)
                      and (hi is None or len(r.prompt) <= hi)]
        lo = hi if hi is not None else lo


def ttft_by_prompt_bucket(finished: List[Request],
                          edges: Tuple[int, ...] = (16, 64)) -> Dict[str, float]:
    """Mean TTFT (scheduler steps from arrival to first token) per
    prompt-length bucket."""
    out: Dict[str, float] = {}
    for label, rs in _prompt_buckets(finished, edges):
        if rs:
            out[label] = float(np.mean([r.first_token_step - r.arrival for r in rs]))
    return out


def acceptance_by_prompt_bucket(finished: List[Request],
                                edges: Tuple[int, ...] = (16, 64)) -> Dict[str, float]:
    """Draft acceptance rate (accepted / proposed) per prompt-length bucket,
    over the requests that proposed any draft token."""
    out: Dict[str, float] = {}
    for label, rs in _prompt_buckets(finished, edges):
        rs = [r for r in rs if r.spec_proposed]
        if rs:
            out[label] = float(sum(r.spec_accepted for r in rs)
                               / sum(r.spec_proposed for r in rs))
    return out


@dataclasses.dataclass
class ServeReport:
    """End-of-run scheduler metrics.  TTFT = arrival → first token;
    ``_steps`` is in scheduler steps, ``_wall``/``_ms`` in wall time."""
    completed: int = 0
    decode_steps: int = 0                 # decode forwards issued
    prefill_tokens: int = 0               # Σ prompt lengths of finished requests
    prefill_chunks: int = 0               # prefill forwards issued
    prefill_forward_tokens: int = 0       # tokens run through prefill forwards
                                          # (prefix-cache hits skip theirs,
                                          # recomputes add theirs)
    decoded_tokens: int = 0
    wall_s: float = 0.0
    tok_per_s: float = 0.0
    ttft_steps_mean: float = 0.0
    ttft_steps_by_bucket: Dict[str, float] = dataclasses.field(default_factory=dict)
    ttft_wall_p50_ms: float = 0.0
    ttft_wall_p95_ms: float = 0.0
    step_ms_p50: float = 0.0
    step_ms_p95: float = 0.0
    peak_slots: int = 0
    pool_high_water_blocks: int = 0
    pool_block_size: int = 0
    pool_dtype: str = "float32"
    pool_bytes_per_token: int = 0
    pool_allocated_bytes_peak: int = 0
    naive_blocks: int = 0                 # Σ per-request worst-case blocks
    block_reuse_ratio: float = 0.0        # naive / high-water
    admission: str = "preempt"
    preemptions: int = 0
    preempted_requests: int = 0
    swap_outs: int = 0                    # preemptions served by host swap
    swap_ins: int = 0                     # swapped prefixes restored
    swapped_bytes: int = 0                # device → host eviction bytes
    mean_occupancy: float = 0.0           # pool fraction referenced by chains
    mean_occupancy_retained: float = 0.0  # ... counting prefix-cache retained
                                          # (refcount-0) blocks too
    mean_prefill_batch: float = 0.0       # mean lanes per prefill forward
    sparse_topk: int = 0                  # block top-k the run decoded with
    sparse_recent: int = 0                # forced newest-block tail width
    sparse_steps: int = 0                 # decode forwards that ran sparse
    mean_selected_blocks: float = 0.0     # blocks attended per lane-step
    mean_candidate_blocks: float = 0.0    # resident blocks per lane-step
    speculate_k: int = 0                  # draft window the run used
    draft_rank: int = 0                   # draft joint-factor rank (0 = full)
    draft_forwards: int = 0               # draft decode forwards run
    draft_proposed: int = 0               # draft tokens proposed across lanes
    draft_accepted: int = 0               # draft tokens kept after verify
    acceptance_rate: float = 0.0          # accepted / proposed
    mean_accepted: float = 0.0            # accepted draft tokens per window
    tokens_per_forward: float = 0.0       # tokens per lane per decode/verify
                                          # forward (speculative: ~1 + mean_accepted)
    acceptance_by_bucket: Dict[str, float] = dataclasses.field(default_factory=dict)
    prefix_cache: bool = False            # the run shared prompt blocks
    prefix_cache_hits: int = 0            # admissions that reused cached blocks
    prefix_cache_misses: int = 0          # admissions finding nothing cached
    prefix_cache_hit_tokens: int = 0      # prompt tokens skipped at prefill
    prefix_cache_hit_rate: float = 0.0    # hit tokens / tokens presented to lookups
    cow_copies: int = 0                   # copy-on-write block copies
    blocks_retained: int = 0              # refcount-0 cached blocks at the end
    phase_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_wall_ms_total: float = 0.0
    trace_events: int = 0                 # events emitted to the tracer
    trace_dropped: int = 0                # events the ring buffer evicted

    def phase_table(self) -> str:
        total = max(self.step_wall_ms_total, 1e-9)
        parts = [f"{k}={v:.1f}ms({100 * v / total:.0f}%)"
                 for k, v in self.phase_ms.items() if v > 0]
        return " ".join(parts) if parts else "(no phases recorded)"

    def summary(self) -> str:
        bucket = "".join(f" ttft[{k}]={v:.1f}" for k, v in
                         self.ttft_steps_by_bucket.items())
        q8 = ""
        if self.pool_dtype not in ("float32", ""):
            q8 = f" pool[{self.pool_dtype} {self.pool_bytes_per_token}B/tok]"
        sp = ""
        if self.sparse_topk:
            sp = (f" sparse[k={self.sparse_topk}+{self.sparse_recent} "
                  f"sel={self.mean_selected_blocks:.1f}/"
                  f"{self.mean_candidate_blocks:.1f}]")
        spec = ""
        if self.speculate_k:
            spec = (f" spec[k={self.speculate_k},r={self.draft_rank}] "
                    f"acc={self.acceptance_rate:.2f} "
                    f"tok/fwd={self.tokens_per_forward:.2f}")
        pc = ""
        if self.prefix_cache:
            pc = (f" pc[hit={self.prefix_cache_hit_rate:.2f} "
                  f"tok={self.prefix_cache_hit_tokens} cow={self.cow_copies}]")
        return (f"completed={self.completed} steps={self.decode_steps} "
                f"decoded={self.decoded_tokens} tok/s={self.tok_per_s:.1f} "
                f"ttft_steps={self.ttft_steps_mean:.1f}{bucket} "
                f"ttft_ms p50/p95={self.ttft_wall_p50_ms:.0f}/{self.ttft_wall_p95_ms:.0f} "
                f"step_ms p50/p95={self.step_ms_p50:.1f}/{self.step_ms_p95:.1f} "
                f"peak_slots={self.peak_slots} "
                f"blocks high-water/naive={self.pool_high_water_blocks}/"
                f"{self.naive_blocks} reuse×{self.block_reuse_ratio:.2f} "
                f"occ={self.mean_occupancy:.2f} [{self.admission}] "
                f"preempt={self.preemptions}(swap {self.swap_outs}/{self.swap_ins}) "
                f"prefill_batch={self.mean_prefill_batch:.1f}{spec}{pc}{q8}{sp}")


class Scheduler:
    """Continuous-batching serving loop over the paged compressed cache.

    ``params``/``buffers`` must already live on ``device``.  ``tracer`` (a
    ``repro_torch.obs.Tracer``) and ``metrics`` (a ``MetricsRegistry``)
    observe the run.  MoE layers dispatch by ``moe_impl`` in every forward
    (prefill, decode, draft and verify).  ``mesh`` (a ``TPMesh``) shards
    the attention heads over its devices (module docstring); the device is
    then ``mesh.devices[0]`` (``device``, if given, must be it).  Without
    either, ``device`` is ``"cuda"``.
    """

    def __init__(self, params, buffers, cfg: ModelConfig, scfg: SchedulerConfig,
                 device=None, tracer=None, metrics=None, moe_impl: str = "ragged",
                 mesh=None):
        _check_text(cfg)
        moe.check_impl(moe_impl)
        if not cfg.elitekv.enabled:
            raise ValueError("paged serving requires an EliteKV config")
        if scfg.eviction not in ("recompute", "swap"):
            raise ValueError(f"unknown eviction {scfg.eviction!r}")
        if scfg.sparse_topk_blocks < 0 or scfg.sparse_recent_blocks < 0:
            raise ValueError("sparse_topk_blocks and sparse_recent_blocks must be >= 0")
        if scfg.speculate_k < 0 or scfg.draft_rank < 0:
            raise ValueError("speculate_k and draft_rank must be >= 0")
        if scfg.sparse_topk_blocks and scfg.speculate_k:
            raise ValueError("sparse_topk_blocks and speculate_k are mutually "
                             "exclusive: a verify window has no single selection query")
        # a recompute re-prefills densely and cannot reproduce streams whose
        # lower layers attended sparsely; swap restores pages and summaries
        # byte for byte, and full width is dense, so only this one is unsound
        sparse_partial = (0 < scfg.sparse_topk_blocks and
                          scfg.sparse_topk_blocks + scfg.sparse_recent_blocks
                          < scfg.max_blocks_per_seq)
        if sparse_partial and scfg.admission == "preempt" and scfg.eviction == "recompute":
            raise ValueError(
                "partial-width sparse decode needs eviction='swap' (or "
                "admission='watermark'): a recompute re-prefills densely and "
                "cannot reproduce streams generated with sparse attention")
        here = lambda d: torch.empty(0, device=d).device      # "cuda" → "cuda:0"
        if mesh is not None:
            if device is not None and here(device) != here(mesh.devices[0]):
                raise ValueError(f"scheduler device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = here("cuda" if device is None else device)
        self.mesh = mesh
        # every device a forward's shards run on, each once (_sync waits on all)
        self._devices = (self.device,) if mesh is None else tuple(
            dict.fromkeys(map(here, mesh.distinct())))
        if lm.params_device(params) != self.device:
            raise ValueError(f"params live on {lm.params_device(params)}, "
                             f"scheduler device is {self.device}")
        self.params, self.buffers, self.cfg, self.scfg = params, buffers, cfg, scfg
        self.moe_impl = moe_impl
        self.trace = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry()
        self.pool = PagedKVPool(cfg, scfg.num_blocks, scfg.block_size,
                                device=self.device, dtype=scfg.cache_dtype,
                                block_summaries=scfg.sparse_topk_blocks > 0,
                                tracer=self.trace, mesh=mesh)
        self.bm = BlockManager(self.pool, policy=scfg.admission,
                               prefix_cache=scfg.prefix_cache)
        self.slots: List[Optional[Request]] = [None] * scfg.max_slots
        self.waiting: collections.deque = collections.deque()
        self.finished: List[Request] = []
        self.t = 0                          # simulated clock (scheduler steps)
        self._step_wall_ms: List[float] = []
        self._occupancy: List[float] = []   # referenced fill fraction per step
        self._occupancy_retained: List[float] = []   # ... with retained blocks
        self.peak_slots = 0
        self.naive_blocks = 0
        self.prefill_chunks = 0
        self._prefill_lanes_total = 0
        self._prefill_forward_tokens = 0
        self._phase_ms = {p: 0.0 for p in PHASES}
        self._step_wall_ms_total = 0.0
        self._sparse_steps = 0
        self._sparse_selected = self._sparse_candidate = 0
        self._decode_appended = 0           # tokens appended by decode/verify
        self._lane_steps = 0                # Σ live lanes over decode/verify forwards
        self.draft_forwards = self.draft_proposed = self.draft_accepted = 0
        self._spec_windows = 0              # (lane, step) verify windows run
        self._register_metrics()
        # the draft shares the params unless a rank truncation is asked for
        self.draft_params = (lm.make_draft_params(params, cfg, scfg.draft_rank)
                             if scfg.speculate_k > 0 else None)

    def _register_metrics(self) -> None:
        """The reference's metric families.  The prefix-cache and pool
        families are always registered (zero-valued when unused, so an
        export keeps one schema); the sparse family only on sparse runs."""
        m, scfg = self.metrics, self.scfg
        self._m_submitted = m.counter(
            "serve_requests_submitted_total", "requests submitted")
        self._m_completed = m.counter(
            "serve_requests_completed_total", "requests retired (eos|budget)")
        self._m_decoded = m.counter(
            "serve_tokens_decoded_total", "tokens appended by decode/verify")
        self._m_prefill_tokens = m.counter(
            "serve_prefill_tokens_total", "tokens cached by prefill forwards")
        self._m_preemptions = m.counter(
            "serve_preemptions_total", "residents evicted on OutOfBlocks")
        self._m_swap_outs = m.counter(
            "serve_swap_outs_total", "preemptions served by host swap-out")
        self._m_swap_ins = m.counter(
            "serve_swap_ins_total", "swapped prefixes restored to the pool")
        self._m_draft_proposed = m.counter(
            "serve_draft_proposed_total", "speculative draft tokens proposed")
        self._m_draft_accepted = m.counter(
            "serve_draft_accepted_total", "draft tokens that survived verify")
        self._m_blocks_used = m.gauge(
            "serve_pool_blocks_used",
            "pool blocks referenced by live chains (excludes prefix-cache "
            "retained blocks; see serve_prefix_cache_blocks_retained)")
        self._m_slots = m.gauge(
            "serve_slots_occupied", "scheduler slots currently resident")
        self._m_step_ms = m.histogram(
            "serve_step_ms", "decode/verify macro-step wall milliseconds")
        self._m_ttft_ms = m.histogram(
            "serve_ttft_ms", "request arrival to first token, wall ms")
        self._m_phase = {p: m.counter(f"serve_phase_{p}_ms_total",
                                      f"total wall ms spent in the {p} phase")
                         for p in PHASES}
        self._m_pc_hits = m.counter(
            "serve_prefix_cache_hits_total",
            "admissions that reused >=1 cached prefix block")
        self._m_pc_misses = m.counter(
            "serve_prefix_cache_misses_total",
            "admissions whose prompt missed the prefix cache")
        self._m_pc_hit_tokens = m.counter(
            "serve_prefix_cache_hit_tokens_total",
            "prompt tokens served from cached blocks instead of prefill")
        self._m_pc_cow = m.counter(
            "serve_prefix_cache_cow_total",
            "copy-on-write block copies (write into a shared block)")
        self._m_pc_retained = m.gauge(
            "serve_prefix_cache_blocks_retained",
            "zero-refcount cached blocks held in the reclaimable LRU")
        self._m_pc_cached = m.gauge(
            "serve_prefix_cache_blocks_cached",
            "physical blocks with a registered prefix-hash claim")
        self._pool_bpt = self.pool.bytes_per_token()
        m.gauge("serve_pool_quantized",
                "1 when the latent pool stores int8 rows + scales, else 0"
                ).set(1 if self.pool.dtype == torch.int8 else 0)
        m.gauge("serve_pool_bytes_per_token",
                "device bytes per pooled token across all layers and streams"
                ).set(self._pool_bpt)
        self._m_pool_bytes = m.gauge(
            "serve_pool_allocated_bytes",
            "device bytes of pool blocks currently allocated to sequences")
        self._cow_synced = 0                # pool.cow_copies already metered
        if scfg.sparse_topk_blocks > 0:
            m.gauge("serve_sparse_topk",
                    "top-k blocks scored into each sparse decode selection"
                    ).set(scfg.sparse_topk_blocks)
            m.gauge("serve_sparse_recent",
                    "newest blocks always attended by sparse decode"
                    ).set(scfg.sparse_recent_blocks)
            self._m_sparse_steps = m.counter(
                "serve_sparse_steps_total",
                "decode forwards that ran with sparse block selection")
            self._m_sparse_selected = m.counter(
                "serve_sparse_selected_blocks_total",
                "blocks attended across all sparse-decode lanes")
            self._m_sparse_candidate = m.counter(
                "serve_sparse_candidate_blocks_total",
                "resident blocks eligible across all sparse-decode lanes")
            self._m_sparse_hist = m.histogram(
                "serve_sparse_selected_blocks",
                "blocks attended per lane per sparse decode forward")

    # -- helpers ------------------------------------------------------------
    def _sync(self) -> None:
        """Wait for every device of the mesh, so a phase's wall time covers
        its work."""
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @contextlib.contextmanager
    def _phase(self, name: str, **args):
        """Attribute the enclosed wall time to step phase ``name``: into
        ``phase_ms``, the metrics and (when tracing) a span on the
        ``scheduler`` track.  Phases never nest."""
        with self.trace.span(name, track="scheduler", cat="phase", **args):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt_ms = (time.perf_counter() - t0) * 1e3
                self._phase_ms[name] += dt_ms
                self._m_phase[name].inc(dt_ms)

    def _measured_phase_ms(self) -> float:
        return sum(v for k, v in self._phase_ms.items() if k != "other")

    def _stuck_report(self, max_steps: int) -> str:
        """The did-not-drain failure's payload: every resident's and
        waiter's status, and the tracer's recent event tail."""
        lines = [f"scheduler did not drain in {max_steps} steps",
                 f"pool: {self.pool.allocator.num_used}/{self.pool.num_blocks} "
                 f"blocks used, {self.pool.allocator.num_free} free, "
                 f"block_size={self.pool.block_size}"]
        if self.bm.prefix is not None:
            pc = self.bm.prefix
            lines.append(f"prefix cache: {pc.num_cached} cached, {pc.num_retained} "
                         f"retained, hits={pc.hits} misses={pc.misses} "
                         f"cow={self.pool.cow_copies}")
        for i, r in enumerate(self.slots):
            lines.append(f"slot{i}: empty" if r is None else
                         f"slot{i}: uid={r.uid} prefill={r.prefill_pos}/"
                         f"{len(r.prefill_source())} generated="
                         f"{len(r.generated)}/{r.max_new_tokens} "
                         f"pool_len={self.pool.length(r.uid)} "
                         f"blocks={len(self.pool.block_table(r.uid))} "
                         f"preempted={len(r.preempted_at)}x")
        lines += [f"waiting: uid={r.uid} arrival={r.arrival:.1f} "
                  f"prefill_src={len(r.prefill_source())} "
                  f"swapped={r.swapped is not None} "
                  f"preempted={len(r.preempted_at)}x" for r in list(self.waiting)[:8]]
        if len(self.waiting) > 8:
            lines.append(f"waiting: … {len(self.waiting) - 8} more")
        lines.append(self.trace.format_tail(40))
        return "\n".join(lines)

    def _blocks_referenced(self) -> int:
        """Pool blocks referenced by live chains: allocator usage minus the
        refcount-0 blocks the prefix cache only retains (reclaimable, and
        free to admission)."""
        retained = self.bm.prefix.num_retained if self.bm.prefix is not None else 0
        return self.pool.allocator.num_used - retained

    def _record_occupancy(self) -> None:
        self._occupancy.append(self._blocks_referenced() / self.pool.num_blocks)
        self._occupancy_retained.append(self.pool.allocator.num_used / self.pool.num_blocks)

    def _sampling_arrays(self, lanes: Dict[int, Request], counts: Dict[int, int], B: int):
        """Device tensors (temps, top_ps, seeds, counts) [B] for the lanes
        ``{lane: request}`` with token indices ``counts``; other lanes are
        greedy."""
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        cnt = np.zeros((B,), np.int32)
        for i, req in lanes.items():
            temps[i], top_ps[i], seeds[i], cnt[i] = (req.temperature, req.top_p,
                                                     req.seed, counts[i])
        return tuple(self._tensor(a) for a in (temps, top_ps, seeds, cnt))

    # -- request intake -----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.max_new_tokens = min(req.max_new_tokens, self.scfg.max_new_tokens)
        if len(req.prompt) + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(f"request {req.uid}: prompt {len(req.prompt)} + "
                             f"{req.max_new_tokens} new > max_len {self.scfg.max_len}")
        if self._worst_case_blocks(req) > self.scfg.num_blocks:
            raise OutOfBlocks(
                f"request {req.uid} needs {self._worst_case_blocks(req)} blocks "
                f"worst-case but the pool only has {self.scfg.num_blocks} — "
                f"it could never be admitted")
        req.submit_wall = time.perf_counter()
        self.waiting.append(req)
        self.naive_blocks += self._worst_case_blocks(req)
        self._m_submitted.inc()
        self.trace.instant("submit", track="scheduler", cat="request", uid=req.uid,
                           prompt=len(req.prompt), budget=req.max_new_tokens,
                           arrival=req.arrival)

    def _worst_case_blocks(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.scfg.block_size)

    def _first_alloc_tokens(self, req: Request) -> int:
        """Pool tokens the request needs at admission: its swapped-out
        prefix, its first prefill chunk, or (one-shot mode) its whole
        prefill source."""
        if req.swapped is not None:
            return req.swapped.length
        src = len(req.prefill_source())
        chunk = self.scfg.prefill_chunk_tokens
        return min(chunk, src) if chunk > 0 else src

    # -- admission ----------------------------------------------------------
    def _try_admit(self) -> int:
        admitted = 0
        while self.waiting and self.waiting[0].arrival <= self.t:
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                break
            req = self.waiting[0]
            if not self.bm.can_admit(self._first_alloc_tokens(req),
                                     self._worst_case_blocks(req)):
                break                       # head-of-line waits for blocks
            self.waiting.popleft()
            self._admit(slot, req)
            admitted += 1
        return admitted

    def _admit(self, slot: int, req: Request) -> None:
        """Claim a slot, restoring a swapped-out prefix if there is one.
        Otherwise, with the prefix cache on, a request with nothing cached
        yet probes the cache with its prefill source: hit blocks splice into
        its chain and ``prefill_pos`` jumps past them.  Other blocks are
        allocated on demand by the prefill."""
        if req.swapped is not None:
            with self._phase("swap", direction="in", uid=req.uid):
                self.bm.swap_in(req.uid, req.swapped)
            req.swapped = None
            self._m_swap_ins.inc()
        elif self.bm.prefix is not None and req.prefill_pos == 0:
            self._lookup_prefix(req)
        self.bm.register(req.uid, self._worst_case_blocks(req))
        self.slots[slot] = req
        self.trace.begin(f"req{req.uid}", track=f"slot{slot}", cat="request",
                         uid=req.uid)
        self.trace.instant("admit", track="scheduler", cat="request", uid=req.uid,
                           slot=slot, queued_steps=self.t - req.arrival)

    def _lookup_prefix(self, req: Request) -> None:
        """Probe the prefix cache with the request's prefill source and
        splice the hit blocks into its fresh chain (after a recompute
        preemption the source is prompt + generated, so a re-admission can
        hit its own retained blocks)."""
        src = req.prefill_source()
        hit = self.bm.lookup_prefix(req.uid, src)
        if hit:
            req.prefill_pos = hit
            req.prefix_hit_tokens += hit
            self._m_pc_hits.inc()
            self._m_pc_hit_tokens.inc(hit)
            self.trace.instant("prefix_hit", track="scheduler", cat="cache",
                               uid=req.uid, tokens=hit,
                               blocks=hit // self.scfg.block_size)
        else:
            self._m_pc_misses.inc()
            self.trace.instant("prefix_miss", track="scheduler", cat="cache",
                               uid=req.uid, tokens=len(src))

    # -- preemption ---------------------------------------------------------
    def _decode_ready(self, req: Request) -> bool:
        """Prefill source fully cached and the next input token sampled."""
        return bool(req.generated) and req.prefill_pos >= len(req.prefill_source())

    def _youngest_slot(self) -> Optional[int]:
        occ = [(s.arrival, s.uid, i) for i, s in enumerate(self.slots) if s is not None]
        return max(occ)[2] if occ else None

    def _preempt(self, slot: int) -> None:
        """Evict the resident in ``slot`` and requeue it at the head of the
        waiting line.  Recompute eviction frees its blocks and makes prompt +
        generated-so-far its prefill source, whose final logits reproduce
        the token the interrupted decode step would have drawn.  Swap
        eviction copies its cached tokens to host memory — counted from the
        request's state (prompt + generated minus the pending last token,
        or the prefill cursor), not from ``pool.length``, which may hold a
        growth whose write never ran — and restores them at re-admission."""
        req = self.slots[slot]
        req.preempted_at.append(len(req.generated))
        if self.scfg.eviction == "swap":
            if self._decode_ready(req):
                cached = len(req.prompt) + len(req.generated) - 1
                req.prefill_src = np.concatenate(
                    [req.prompt, np.asarray(req.generated[:-1], np.int32)])
                req.prefill_pos = cached
            else:
                cached = req.prefill_pos
            with self._phase("swap", direction="out", uid=req.uid):
                req.swapped = self.bm.preempt_swap_out(req.uid, cached)
            if req.swapped is not None:
                self._m_swap_outs.inc()
        else:
            if req.generated:
                req.prefill_src = np.concatenate(
                    [req.prompt, np.asarray(req.generated, np.int32)])
            req.prefill_pos = 0
            self.bm.preempt_recompute(req.uid)
        self._m_preemptions.inc()
        self.trace.end(f"req{req.uid}", track=f"slot{slot}", cat="request",
                       reason="preempt")
        self.trace.instant("preempt", track="scheduler", cat="request", uid=req.uid,
                           slot=slot, mode=self.scfg.eviction,
                           generated=len(req.generated))
        self.slots[slot] = None
        self.waiting.appendleft(req)

    def _grow_or_preempt(self, req: Request, length: int,
                         write_from: Optional[int] = None) -> bool:
        """Grow ``req``'s chain to ``length`` tokens, preempting the youngest
        resident until the allocation fits.  Returns False iff ``req`` itself
        was the youngest and got evicted.  Terminates: every retry removes one
        resident, and a lone resident's worst case fits (checked at submit).

        ``write_from`` is the copy-on-write barrier: the caller is about to
        write positions ``[write_from, length)``, so every shared block there
        is made private first.  The copy allocates, so it sits inside the
        same retry loop as the growth, and it is issued before the caller's
        scatter."""
        while True:
            try:
                self.bm.grow(req.uid, length)
                if write_from is not None:
                    self.bm.prepare_write(req.uid, write_from, length)
                return True
            except OutOfBlocks:
                slot = self._youngest_slot()
                if slot is None:
                    raise
                victim = self.slots[slot]
                self._preempt(slot)
                if victim is req:
                    return False

    # -- sampling -------------------------------------------------------------
    def _sample_one(self, req: Request, row: torch.Tensor, count: int) -> int:
        """One token from one logits row with ``req``'s sampling settings and
        token index ``count``: the draw the batched decode sampler would
        make.  Serves the token after a prefill and the speculative bonus
        token."""
        if req.temperature <= 0:
            return int(torch.argmax(row))
        return int(sample_tokens(row[None], *self._sampling_arrays({0: req}, {0: count}, 1))[0])

    # -- prefill --------------------------------------------------------------
    def _sample_prefill_token(self, req: Request, last_row: torch.Tensor) -> None:
        """The token after a completed (re)prefill, from its final logits
        row, at token index ``len(generated)``: after a recompute this
        re-draws exactly the token the interrupted decode step would have
        produced."""
        req.generated.append(self._sample_one(req, last_row, len(req.generated)))
        self._m_decoded.inc()               # prefill-sampled tokens count too
        if req.first_token_step < 0:        # TTFT survives preemption
            req.first_token_wall = time.perf_counter()
            req.first_token_step = self.t
            self._m_ttft_ms.observe((req.first_token_wall - req.submit_wall) * 1e3)
            self.trace.instant("first_token", track="scheduler", cat="request",
                               uid=req.uid, step=self.t)

    def _run_oneshot(self, slot: int, req: Request) -> None:
        """Prefill the rest of the source in one call, padded to the bucket.
        From position 0 it is a causal prefill; after a prefix-cache hit
        (``prefill_pos > 0``) the uncovered tail runs as one resumed chunk
        attending to the cached prefix through the block table."""
        src = req.prefill_source()
        sp, pos = len(src), req.prefill_pos
        if not self._grow_or_preempt(req, sp, write_from=pos):
            return                          # req evicted itself — retry later
        n = sp - pos
        pad = -(-n // self.scfg.prefill_bucket) * self.scfg.prefill_bucket
        tokens = np.zeros((1, pad), np.int32)
        tokens[0, :n] = src[pos:]
        sm = self.pool.prefill_slot_mapping(req.uid, pos, n, pad)[None]
        kw = {}
        if pos:
            starts = np.asarray([pos], np.int32)
            kw = dict(chunk_start=starts, prefix_lens=starts,
                      block_tables=self.pool.block_table_array(
                          [req.uid], len(self.pool.block_table(req.uid))),
                      block_size=self.scfg.block_size)
        with self._phase("prefill", lanes=1, tokens=n):
            logits = lm.apply_prefill_paged(
                self.params, self.buffers, self.cfg, self._tensor(tokens),
                self.pool.pages, torch.from_numpy(sm), **kw, moe_impl=self.moe_impl, mesh=self.mesh)
            self._sync()
        self.trace.instant("prefill_chunk", track=f"slot{slot}", cat="request",
                           uid=req.uid, start=pos, n=n)
        self._m_prefill_tokens.inc(n)
        req.prefill_pos = sp
        self.bm.register_prefix(req.uid, src)
        self._prefill_forward_tokens += n
        self.prefill_chunks += 1
        self._prefill_lanes_total += 1
        with self._phase("sample"):
            self._sample_prefill_token(req, logits[0, n - 1])
        self._maybe_finish(slot, req.generated[-1])

    def _prefill_work(self) -> None:
        """Advance mid-prefill residents.  One-shot mode: each pending source
        prefills whole, FCFS.  Chunked mode: the next chunk of up to
        ``chunk_lanes`` lanes (FCFS) in ONE forward, each lane attending to
        its own paged prefix at its own offset.  Freshly written full prompt
        blocks are registered with the prefix cache after every chunk."""
        scfg = self.scfg
        chunk = scfg.prefill_chunk_tokens
        if chunk <= 0:
            while True:
                cand = [(s.arrival, s.uid, i) for i, s in enumerate(self.slots)
                        if s is not None and s.prefill_pos < len(s.prefill_source())]
                if not cand:
                    return
                _, _, slot = min(cand)
                self._run_oneshot(slot, self.slots[slot])
        cand = sorted((s.arrival, s.uid, i) for i, s in enumerate(self.slots)
                      if s is not None and s.prefill_pos < len(s.prefill_source()))
        selected: List[Tuple[int, Request, int, int]] = []
        for _, _, slot in cand:
            if len(selected) >= scfg.chunk_lanes:
                break
            req = self.slots[slot]
            if req is None:                 # evicted by an earlier growth
                continue
            n = min(chunk, len(req.prefill_source()) - req.prefill_pos)
            if self._grow_or_preempt(req, req.prefill_pos + n, write_from=req.prefill_pos):
                selected.append((slot, req, req.prefill_pos, n))
        selected = [(s, r, st, n) for s, r, st, n in selected
                    if self.slots[s] is r]  # drop lanes evicted after selection
        if not selected:
            return
        lanes = scfg.chunk_lanes
        tokens = np.zeros((lanes, chunk), np.int32)
        sms = np.full((lanes, chunk), self.pool.oob_slot, np.int32)
        starts = np.zeros((lanes,), np.int32)
        seq_ids: List[Optional[int]] = [None] * lanes
        for lane, (slot, req, start, n) in enumerate(selected):
            tokens[lane, :n] = req.prefill_source()[start:start + n]
            sms[lane] = self.pool.prefill_slot_mapping(req.uid, start, n, chunk)
            starts[lane] = start            # chunk offset == cached prefix length
            seq_ids[lane] = req.uid
        # the table only needs to be as wide as the longest chain in the call
        width = max(len(self.pool.block_table(r.uid)) for _, r, _, _ in selected)
        bt = self.pool.block_table_array(seq_ids, width)
        n_toks = sum(n for *_, n in selected)
        with self._phase("prefill", lanes=len(selected), tokens=n_toks):
            logits = lm.apply_prefill_paged(
                self.params, self.buffers, self.cfg, self._tensor(tokens),
                self.pool.pages, torch.from_numpy(sms), chunk_start=starts,
                block_tables=bt, prefix_lens=starts,
                block_size=scfg.block_size, moe_impl=self.moe_impl, mesh=self.mesh)
            self._sync()
        self._m_prefill_tokens.inc(n_toks)
        self.prefill_chunks += 1
        self._prefill_lanes_total += len(selected)
        self._prefill_forward_tokens += n_toks
        for lane, (slot, req, start, n) in enumerate(selected):
            self.trace.instant("prefill_chunk", track=f"slot{slot}", cat="request",
                               uid=req.uid, start=start, n=n)
            req.prefill_pos = start + n
            self.bm.register_prefix(req.uid, req.prefill_source()[:req.prefill_pos])
            if req.prefill_pos >= len(req.prefill_source()):
                with self._phase("sample"):
                    self._sample_prefill_token(req, logits[lane, n - 1])
                self._maybe_finish(slot, req.generated[-1])

    # -- retirement -----------------------------------------------------------
    def _maybe_finish(self, slot: int, token: int) -> None:
        req = self.slots[slot]
        if self.scfg.eos_id is not None and token == self.scfg.eos_id:
            req.finish_reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "budget"
        else:
            return
        req.finish_step = self.t
        self.bm.release(req.uid)            # blocks recycle immediately
        self.finished.append(req)
        self.slots[slot] = None
        self._m_completed.inc()
        self.trace.end(f"req{req.uid}", track=f"slot{slot}", cat="request",
                       reason=req.finish_reason)
        self.trace.instant("retire", track="scheduler", cat="request", uid=req.uid,
                           reason=req.finish_reason, tokens=len(req.generated))

    # -- one scheduler iteration ---------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """Admit + prefill + decode once.  Returns False when drained."""
        self._try_admit()
        self._prefill_work()
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        self.peak_slots = max(self.peak_slots, len(occupied))
        self._sample_gauges(len(occupied))
        # decode lanes: decode-ready slots, oldest first — chain growth may
        # preempt the youngest residents (who then sit out this step)
        order = sorted((self.slots[i].arrival, self.slots[i].uid, i)
                       for i in occupied if self._decode_ready(self.slots[i]))
        if self.scfg.speculate_k > 0:
            progressed = self._speculative_step(order)
        else:
            progressed = self._decode_step(order)
        if not progressed:
            if all(s is None for s in self.slots) and not self.waiting:
                return False
            self.t += 1                     # waiting on arrivals or prefill
            return True
        self.t += 1
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def _sample_gauges(self, occupied: int) -> None:
        """Pool and slot gauges and counter samples, once per step.  Used
        blocks are those live chains reference: prefix-cache retained
        blocks are reclaimable, so they show apart."""
        referenced = self._blocks_referenced()
        self._m_blocks_used.set(referenced)
        self._m_slots.set(occupied)
        self.trace.counter("pool_blocks_used", referenced, track="pool")
        alloc_bytes = self.pool.allocator.num_used * self.scfg.block_size * self._pool_bpt
        self._m_pool_bytes.set(alloc_bytes)
        self.trace.counter("pool_allocated_bytes", alloc_bytes, track="pool")
        self.trace.counter("slots_occupied", occupied, track="scheduler")
        pc = self.bm.prefix
        if pc is not None:
            if self.pool.cow_copies > self._cow_synced:
                self._m_pc_cow.inc(self.pool.cow_copies - self._cow_synced)
                self._cow_synced = self.pool.cow_copies
            self._m_pc_retained.set(pc.num_retained)
            self._m_pc_cached.set(pc.num_cached)
            self.trace.counter("prefix_blocks_retained", pc.num_retained, track="pool")

    def _decode_step(self, order) -> bool:
        """One-token decode over every decode-ready lane (one forward), then
        one batched sampling call — the argmax on the device when no lane
        samples.  Returns False when no lane was live."""
        grown: Dict[int, int] = {}          # slot → position of the new token
        for _, _, i in order:
            req = self.slots[i]
            if req is None:
                continue                    # evicted by an older lane's growth
            cur = self.pool.length(req.uid)
            if self._grow_or_preempt(req, cur + 1, write_from=cur):
                grown[i] = cur
        active = [i for i in grown if self.slots[i] is not None]
        self._record_occupancy()
        if not active:
            return False

        B = self.scfg.max_slots
        tokens = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        seq_ids: List[Optional[int]] = [None] * B
        positions = [0] * B
        for i in active:
            req = self.slots[i]
            cur = grown[i]                  # chain already grown above
            tokens[i, 0] = req.generated[-1]
            lengths[i] = cur + 1
            seq_ids[i] = req.uid
            positions[i] = cur
        sm = self.pool.slot_mapping(seq_ids, positions)
        width = max(len(self.pool.block_table(self.slots[i].uid)) for i in active)
        bt = self.pool.block_table_array(seq_ids, width)
        sampled = {i: self.slots[i] for i in active if self.slots[i].temperature > 0}

        t0 = time.perf_counter()
        with self._phase("decode", lanes=len(active)):
            logits = lm.apply_decode_paged(
                self.params, self.buffers, self.cfg, self._tensor(tokens),
                self.pool.pages, torch.from_numpy(sm), self._tensor(bt),
                self._tensor(lengths), self.scfg.block_size,
                self.scfg.sparse_topk_blocks, self.scfg.sparse_recent_blocks,
                moe_impl=self.moe_impl, mesh=self.mesh)
            self._sync()
        with self._phase("sample"):
            if sampled:
                arrays = self._sampling_arrays(
                    sampled, {i: len(r.generated) for i, r in sampled.items()}, B)
                nxt = sample_tokens(logits[:, -1, :], *arrays).cpu().numpy()
            else:
                nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self._step_wall_ms.append((time.perf_counter() - t0) * 1e3)
        self._m_step_ms.observe(self._step_wall_ms[-1])
        self._lane_steps += len(active)
        if self.scfg.sparse_topk_blocks > 0:
            self._count_sparse(lengths[active])
        for i in active:
            tok = int(nxt[i])
            self.slots[i].generated.append(tok)
            self._decode_appended += 1
            self._m_decoded.inc()
            self._maybe_finish(i, tok)
        return True

    # -- speculative decode: draft / verify macro-step -------------------------
    def _speculative_step(self, order) -> bool:
        """Draft + verify for every decode-ready lane:

        1. grow each lane's chain to ``cur + w + 1`` up front (``w = min(k,
           budget left)`` draft slots plus the pending token's), preempting
           as plain decode's growth does, behind the copy-on-write barrier;
        2. build the block table once for the macro-step;
        3. ``k`` batched decode forwards of the draft propose tokens, sampled
           as plain decode would sample them (their streams go into the
           pool, so later proposals attend to earlier ones; a lane whose
           window is shorter sits out as an idle lane);
        4. one verify forward of the full model scores all ``k+1`` window
           positions, overwriting the window's slots with full-model streams;
        5. per lane, keep the accepted prefix plus one corrected or bonus
           token (``_accept_window``), and truncate the chain to what was
           kept.  Sampled lanes need the draft and verify rows on the host:
           they come over in one copy per step.

        Between steps the request/pool invariant is plain decode's (cache =
        prompt + generated[:-1], the last token pending), so preemption,
        swap and recompute work unchanged.  Returns False when no lane was
        live."""
        scfg = self.scfg
        k, B = scfg.speculate_k, scfg.max_slots
        W = k + 1
        windows: Dict[int, Tuple[int, int]] = {}   # slot → (cur, w)
        for _, _, i in order:
            req = self.slots[i]
            if req is None:
                continue                    # evicted by an older lane's growth
            cur = self.pool.length(req.uid)
            w = min(k, req.max_new_tokens - len(req.generated))
            if self._grow_or_preempt(req, cur + w + 1, write_from=cur):
                windows[i] = (cur, w)
        active = [i for i in windows if self.slots[i] is not None]
        self._record_occupancy()
        if not active:
            return False

        t0 = time.perf_counter()
        seq_ids: List[Optional[int]] = [None] * B
        for i in active:
            seq_ids[i] = self.slots[i].uid
        width = max(len(self.pool.block_table(self.slots[i].uid)) for i in active)
        bt = self._tensor(self.pool.block_table_array(seq_ids, width))
        sampled = {i: self.slots[i] for i in active if self.slots[i].temperature > 0}
        drafts: Dict[int, List[int]] = {i: [] for i in active}
        draft_rows: List[torch.Tensor] = []      # [B, V] per draft forward (sampled)
        for j in range(k):
            live = [i for i in active if windows[i][1] > j]
            if not live:
                break
            tokens = np.zeros((B, 1), np.int32)
            lengths = np.zeros((B,), np.int32)
            ids: List[Optional[int]] = [None] * B
            positions = [0] * B
            for i in live:
                cur = windows[i][0]
                tokens[i, 0] = drafts[i][-1] if j else self.slots[i].generated[-1]
                lengths[i] = cur + j + 1
                ids[i] = seq_ids[i]
                positions[i] = cur + j
            sm = self.pool.slot_mapping(ids, positions)
            with self._phase("draft", j=j, lanes=len(live)):
                logits = lm.apply_decode_paged(
                    self.draft_params, self.buffers, self.cfg, self._tensor(tokens),
                    self.pool.pages, torch.from_numpy(sm), bt, self._tensor(lengths),
                    scfg.block_size, moe_impl=self.moe_impl, mesh=self.mesh)
                if sampled:
                    arrays = self._sampling_arrays(
                        sampled, {i: len(r.generated) + j for i, r in sampled.items()}, B)
                    nxt = sample_tokens(logits[:, -1, :], *arrays).cpu().numpy()
                    draft_rows.append(logits[:, -1, :])
                else:
                    nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            self.draft_forwards += 1
            for i in live:
                drafts[i].append(int(nxt[i]))

        tokens = np.zeros((B, W), np.int32)
        sms = np.full((B, W), self.pool.oob_slot, np.int32)
        offs = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i in active:
            req = self.slots[i]
            cur, w = windows[i]
            tokens[i, 0] = req.generated[-1]
            tokens[i, 1:1 + w] = drafts[i]
            sms[i] = self.pool.prefill_slot_mapping(req.uid, cur, w + 1, W)
            offs[i] = cur
            lengths[i] = cur + w + 1
        with self._phase("verify", lanes=len(active)):
            logits = lm.apply_verify_paged(
                self.params, self.buffers, self.cfg, self._tensor(tokens),
                self.pool.pages, torch.from_numpy(sms), bt, self._tensor(offs),
                self._tensor(lengths), scfg.block_size, moe_impl=self.moe_impl, mesh=self.mesh)
            targets = torch.argmax(logits, dim=-1).cpu().numpy()       # [B, W]
            rows = None
            if sampled:                     # verify rows, then draft rows
                rows = torch.cat([logits, torch.stack(draft_rows, 1)], 1).cpu().numpy()
        self._step_wall_ms.append((time.perf_counter() - t0) * 1e3)
        self._m_step_ms.observe(self._step_wall_ms[-1])
        self._lane_steps += len(active)

        with self._phase("accept", lanes=len(active)):
            for i in active:
                req = self.slots[i]
                cur, w = windows[i]
                if req.temperature > 0:
                    out = self._accept_sampled(req, drafts[i], rows[i, :W],
                                               rows[i, W:W + w], logits[i, w])
                else:
                    out = self._accept_greedy(drafts[i], targets[i])
                n_acc = len(out) - 1
                self.bm.truncate(req.uid, cur + n_acc + 1)
                appended = 0
                for tok in out:
                    req.generated.append(tok)
                    appended += 1
                    self._maybe_finish(i, tok)
                    if self.slots[i] is None:
                        break               # EOS or budget mid-window: the rest drops
                self._decode_appended += appended
                self._m_decoded.inc(appended)
                # accepted drafts that an EOS cut off do not count as kept
                kept = min(n_acc, appended)
                req.spec_proposed += w
                req.spec_accepted += kept
                self.draft_proposed += w
                self.draft_accepted += kept
                self._m_draft_proposed.inc(w)
                self._m_draft_accepted.inc(kept)
                self._spec_windows += 1
        return True

    @staticmethod
    def _accept_greedy(drafts: List[int], targets: np.ndarray) -> List[int]:
        """Greedy accept of one lane's window: the drafts that equal the full
        model's argmax ``targets[j]`` (its choice after window token ``j``),
        up to the first that does not, plus one more token — the correction
        there, or the bonus ``targets[len(drafts)]`` when all survived.
        Each appended token is the one plain decode would have produced."""
        out: List[int] = []
        for j, x in enumerate(drafts):
            tgt = int(targets[j])
            out.append(tgt)
            if x != tgt:
                return out
        out.append(int(targets[len(drafts)]))
        return out

    def _accept_sampled(self, req: Request, drafts: List[int], rows: np.ndarray,
                        dlogits: np.ndarray, bonus_row: torch.Tensor) -> List[int]:
        """Rejection-sampling accept of one sampled lane's window.  ``rows[j]``
        are the full model's logits after window token ``j``, ``dlogits[j]``
        the draft's that proposed ``drafts[j]``; proposal ``j`` (token index
        ``len(generated) + j``) survives with probability ``min(1, p/q)`` of
        the two nucleus distributions, else the residual draw replaces it
        and the window ends.  When all survive, the bonus token is drawn
        from ``bonus_row`` exactly as plain decode would draw it."""
        out: List[int] = []
        for j, x in enumerate(drafts):
            t_idx = len(req.generated) + j
            p = nucleus_probs(rows[j], req.temperature, req.top_p)
            q = nucleus_probs(dlogits[j], req.temperature, req.top_p)
            if not speculative_accept(x, p, q, _spec_uniform(req.seed, t_idx, _ACCEPT_SALT)):
                out.append(residual_sample(p, q, _spec_uniform(req.seed, t_idx, _RESID_SALT)))
                return out
            out.append(x)
        out.append(self._sample_one(req, bonus_row, len(req.generated) + len(drafts)))
        return out

    def _count_sparse(self, lengths: np.ndarray) -> None:
        """Blocks attended and resident per live lane of a sparse step, from
        the same arithmetic as the selection (its full width is
        ``min(topk + recent, max_blocks_per_seq)``), so nothing is read
        back from the card."""
        scfg = self.scfg
        width = min(scfg.sparse_topk_blocks + scfg.sparse_recent_blocks,
                    scfg.max_blocks_per_seq)
        n_chain = -(-lengths.astype(np.int64) // scfg.block_size)
        sel = np.minimum(n_chain, width)
        step_sel, step_cand = int(sel.sum()), int(n_chain.sum())
        for v in sel.tolist():
            self._m_sparse_hist.observe(v)
        self._sparse_steps += 1
        self._sparse_selected += step_sel
        self._sparse_candidate += step_cand
        self._m_sparse_steps.inc()
        self._m_sparse_selected.inc(step_sel)
        self._m_sparse_candidate.inc(step_cand)
        self.trace.instant("sparse_select", track="pool", cat="cache",
                           selected=step_sel, candidate=step_cand)

    # -- drive to completion --------------------------------------------------
    def run(self, requests: Optional[List[Request]] = None,
            max_steps: int = 100_000) -> ServeReport:
        for r in requests or []:
            self.submit(r)
        t0 = time.perf_counter()
        steps = 0
        while True:
            s0 = time.perf_counter()
            before = self._measured_phase_ms()
            alive = self.step()
            dt_ms = (time.perf_counter() - s0) * 1e3
            self._step_wall_ms_total += dt_ms
            # residual host time (admission, growth bookkeeping, packing)
            other = max(0.0, dt_ms - (self._measured_phase_ms() - before))
            self._phase_ms["other"] += other
            self._m_phase["other"].inc(other)
            if not alive:
                break
            steps += 1
            if steps > max_steps:
                raise RuntimeError(self._stuck_report(max_steps))
        wall_s = time.perf_counter() - t0
        self.trace.resolve()                # device-timed entries, read once
        return self.report(wall_s)

    def report(self, wall_s: float) -> ServeReport:
        fin = self.finished
        decoded = sum(len(r.generated) for r in fin)
        ttft_steps = [r.first_token_step - r.arrival for r in fin]
        ttft_ms = [(r.first_token_wall - r.submit_wall) * 1e3 for r in fin]
        pct = lambda xs, q: float(np.percentile(xs, q)) if xs else 0.0
        hw = self.pool.allocator.high_water
        bpt = self._pool_bpt
        pc = self.bm.prefix
        return ServeReport(
            completed=len(fin), decode_steps=len(self._step_wall_ms),
            prefill_tokens=sum(len(r.prompt) for r in fin),
            prefill_chunks=self.prefill_chunks,
            prefill_forward_tokens=self._prefill_forward_tokens, decoded_tokens=decoded,
            wall_s=wall_s, tok_per_s=decoded / max(wall_s, 1e-9),
            ttft_steps_mean=float(np.mean(ttft_steps)) if ttft_steps else 0.0,
            ttft_steps_by_bucket=ttft_by_prompt_bucket(fin),
            ttft_wall_p50_ms=pct(ttft_ms, 50), ttft_wall_p95_ms=pct(ttft_ms, 95),
            step_ms_p50=pct(self._step_wall_ms, 50),
            step_ms_p95=pct(self._step_wall_ms, 95),
            peak_slots=self.peak_slots, pool_high_water_blocks=hw,
            pool_block_size=self.scfg.block_size,
            pool_dtype=self.pool.stats().dtype, pool_bytes_per_token=bpt,
            pool_allocated_bytes_peak=hw * self.scfg.block_size * bpt,
            naive_blocks=self.naive_blocks,
            block_reuse_ratio=self.naive_blocks / max(hw, 1),
            admission=self.scfg.admission,
            preemptions=self.bm.preemptions,
            preempted_requests=sum(1 for r in fin if r.preempted_at),
            swap_outs=self.bm.swap_outs, swap_ins=self.bm.swap_ins,
            swapped_bytes=self.bm.swapped_bytes,
            mean_occupancy=float(np.mean(self._occupancy)) if self._occupancy else 0.0,
            mean_occupancy_retained=(float(np.mean(self._occupancy_retained))
                                     if self._occupancy_retained else 0.0),
            mean_prefill_batch=self._prefill_lanes_total / max(self.prefill_chunks, 1),
            sparse_topk=self.scfg.sparse_topk_blocks,
            sparse_recent=self.scfg.sparse_recent_blocks,
            sparse_steps=self._sparse_steps,
            mean_selected_blocks=self._sparse_selected / max(self._lane_steps, 1),
            mean_candidate_blocks=self._sparse_candidate / max(self._lane_steps, 1),
            speculate_k=self.scfg.speculate_k, draft_rank=self.scfg.draft_rank,
            draft_forwards=self.draft_forwards, draft_proposed=self.draft_proposed,
            draft_accepted=self.draft_accepted,
            acceptance_rate=self.draft_accepted / max(self.draft_proposed, 1),
            mean_accepted=self.draft_accepted / max(self._spec_windows, 1),
            tokens_per_forward=self._decode_appended / max(self._lane_steps, 1),
            acceptance_by_bucket=acceptance_by_prompt_bucket(fin),
            prefix_cache=pc is not None,
            prefix_cache_hits=pc.hits if pc else 0,
            prefix_cache_misses=pc.misses if pc else 0,
            prefix_cache_hit_tokens=pc.hit_tokens if pc else 0,
            prefix_cache_hit_rate=pc.hit_tokens / max(pc.lookup_tokens, 1) if pc else 0.0,
            cow_copies=self.pool.cow_copies,
            blocks_retained=pc.num_retained if pc else 0,
            phase_ms=dict(self._phase_ms),
            step_wall_ms_total=self._step_wall_ms_total,
            trace_events=self.trace.emitted if self.trace.enabled else 0,
            trace_dropped=self.trace.dropped if self.trace.enabled else 0)


def generate_paged(params, buffers, cfg: ModelConfig, prompts: np.ndarray,
                   max_new_tokens: int, scfg: Optional[SchedulerConfig] = None,
                   device="cuda") -> Tuple[np.ndarray, ServeReport]:
    """Greedy generation for a batch of equal-length prompts through the
    paged scheduler.  prompts [B, Sp] → tokens [B, max_new_tokens]."""
    prompts = np.asarray(prompts, np.int32)
    B, Sp = prompts.shape
    scfg = scfg or SchedulerConfig(
        max_slots=B, max_new_tokens=max_new_tokens,
        max_len=Sp + max_new_tokens + 1,
        num_blocks=2 * B * (-(-(Sp + max_new_tokens) // 16)), block_size=16)
    sched = Scheduler(params, buffers, cfg, scfg, device=device)
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new_tokens)
            for i in range(B)]
    report = sched.run(reqs)
    out = np.zeros((B, max_new_tokens), np.int32)
    for r in sched.finished:
        out[r.uid, :len(r.generated)] = r.generated
    return out, report
