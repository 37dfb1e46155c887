"""The port's prefix cache and copy-on-write, held to the JAX package's.

* Block hashes are byte for byte the reference's (same root, same sha256
  over int32 tokens), chained and parent-dependent; a partial tail block is
  never hashed.
* With the prefix cache on, greedy and sampled streams equal the JAX
  ``Scheduler``'s, one-shot (the uncovered tail runs as one resumed chunk)
  and chunked, and so do the counters: hits, misses, hit tokens, COW copies
  and retained blocks.
* Cache on == cache off in the port, also under preemption (recompute and
  swap), speculative decode with a truncated draft, the int8 pool and
  partial-width sparse decode with swap eviction (the reference's own
  checks of these, on the port).
* The mechanism: lookups stop one token short of the prompt, LRU retention
  and reclaim order, first claim wins, a COW copy carries the block's
  content (slot leaves and summary rows) and leaves the reader's block
  untouched, a truncate through a shared block un-links it, and an op-fuzz
  keeps the pool exactly conserved after every operation.
"""
import collections

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import cache as jax_cache
from repro.runtime import serve_loop as jax_sl

from repro_torch.configs import get_config
from repro_torch.core.cache import (_HASH_ROOT, BlockManager, OutOfBlocks, PagedKVPool,
                                    PrefixCache, block_hash, prefix_block_hashes)
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from test_torch_sampling import assert_decided, assert_same_streams, record_sampled_margins
from test_torch_serve import port  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def shared_workload(mod, vocab, n_req=5, shared=12, seed=7, temp=0.0, max_new=8,
                    suffixes=None):
    """``n_req`` requests sharing a ``shared``-token prefix, each with a short
    suffix of its own (``suffixes`` sets the lengths; 0 = the bare prefix),
    arriving half a step apart; sampled ones use top_p 0.9 and seed 11 + i
    (the reference tests' workload)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    reqs = []
    for i in range(n_req):
        n_suf = suffixes[i] if suffixes is not None else int(rng.integers(2, 6))
        tail = rng.integers(0, vocab, n_suf).astype(np.int32)
        reqs.append(mod.Request(uid=i, prompt=np.concatenate([head, tail]),
                                max_new_tokens=max_new, arrival=i * 0.5,
                                temperature=temp, top_p=0.9, seed=11 + i))
    return reqs


def scfg_kw(prefix_cache, num_blocks=64, admission="preempt", eviction="recompute",
            chunk=4, spec_k=0, rank=0, **kw):
    return dict(max_slots=2, block_size=4, num_blocks=num_blocks, max_len=48,
                prefill_bucket=4, prefill_chunk_tokens=chunk, admission=admission,
                eviction=eviction, speculate_k=spec_k, draft_rank=rank,
                prefix_cache=prefix_cache, **kw)


def run_port(port, workload, **kw):
    cfg, tp, tb = port
    sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw(**kw)),
                                 device="cpu")
    rep = sched.run(workload(serve_loop, cfg.vocab_size))
    return {r.uid: list(r.generated) for r in sched.finished}, rep, sched


def drained(sched) -> bool:
    """Every block is free or retained by the cache once the stream drains."""
    retained = sched.bm.prefix.num_retained if sched.bm.prefix else 0
    return sched.pool.allocator.num_free + retained == sched.pool.num_blocks


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(0, 4), (3, 4), (13, 4), (64, 16), (50, 7)])
def test_block_hashes_are_reference_bytes(n, bs):
    toks = (np.arange(n, dtype=np.int64) * 7919 % 32000).astype(np.int32)
    assert _HASH_ROOT == jax_cache._HASH_ROOT
    got = prefix_block_hashes(toks, bs)
    assert got == jax_cache.prefix_block_hashes(toks, bs)
    assert len(got) == n // bs
    if got:
        assert got[0] == block_hash(_HASH_ROOT, toks[:bs]) == \
            jax_cache.block_hash(jax_cache._HASH_ROOT, toks[:bs])


def test_hash_chain_is_parent_dependent():
    x = np.arange(13, dtype=np.int32)
    a = prefix_block_hashes(x, 4)
    assert prefix_block_hashes(x[:15], 4) == a              # the tail is not hashed
    assert a[2] == block_hash(a[1], x[8:12])
    y = x.copy()
    y[0] += 1
    hy = prefix_block_hashes(y, 4)
    assert hy[0] != a[0] and hy[1] != a[1]                 # same block-1 tokens


# ---------------------------------------------------------------------------
# streams and counters against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_prefix_cache_streams_match_reference(chunk, temp, tiny_elite_cfg, tiny_elite_model,
                                              port):
    kw = scfg_kw(True, chunk=chunk)
    jsched = jax_sl.Scheduler(*tiny_elite_model, tiny_elite_cfg, jax_sl.SchedulerConfig(**kw))
    margins = []
    record_sampled_margins(jsched, margins)
    jrep = jsched.run(shared_workload(jax_sl, tiny_elite_cfg.vocab_size, temp=temp))
    got, rep, sched = run_port(port, lambda m, v: shared_workload(m, v, temp=temp),
                               prefix_cache=True, chunk=chunk)
    if temp == 0:
        assert_decided(margins)
    assert_same_streams(got, {r.uid: list(r.generated) for r in jsched.finished}, margins)
    for field in ("completed", "decode_steps", "prefill_chunks", "prefix_cache_hits",
                  "prefix_cache_misses", "prefix_cache_hit_tokens", "cow_copies",
                  "blocks_retained"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.prefix_cache_hit_rate == pytest.approx(jrep.prefix_cache_hit_rate)
    assert rep.mean_occupancy_retained == pytest.approx(jrep.mean_occupancy_retained)
    assert rep.prefix_cache_hits > 0 and rep.prefix_cache_hit_tokens > 0
    assert [r.prefix_hit_tokens for r in sched.finished] == \
        [r.prefix_hit_tokens for r in jsched.finished]
    assert "pc[" in rep.summary() and drained(sched)
    # the tokens prefilled drop by exactly the hit tokens
    _, off, _ = run_port(port, lambda m, v: shared_workload(m, v, temp=temp),
                         prefix_cache=False, chunk=chunk)
    assert rep.prefill_tokens == off.prefill_tokens == off.prefill_forward_tokens
    assert rep.prefill_forward_tokens == off.prefill_forward_tokens - rep.prefix_cache_hit_tokens
    assert off.prefix_cache is False and off.cow_copies == 0 and "pc[" not in off.summary()


@pytest.mark.parametrize("chunk", [0, 6])
def test_cache_on_matches_off_sampled(chunk, port):
    wl = lambda m, v: shared_workload(m, v, temp=0.8)
    base, base_rep, _ = run_port(port, wl, prefix_cache=False, chunk=chunk)
    out, rep, sched = run_port(port, wl, prefix_cache=True, chunk=chunk)
    assert out == base and rep.completed == base_rep.completed == 5
    assert rep.prefix_cache_hits > 0 and drained(sched)


def test_block_boundary_prompt_lengths(port):
    """Prompts ending on a block boundary, one past it, one short of the
    next, and the bare shared prefix twice: the final prompt token is
    always prefilled, and streams equal cache-off."""
    wl = lambda m, v: shared_workload(m, v, suffixes=[0, 1, 3, 4, 0])
    base, _, _ = run_port(port, wl, prefix_cache=False)
    out, rep, sched = run_port(port, wl, prefix_cache=True)
    assert out == base and rep.prefix_cache_hits > 0
    assert all(r.prefix_hit_tokens < len(r.prompt) for r in sched.finished)
    assert drained(sched)


@pytest.mark.parametrize("eviction", ["recompute", "swap"])
def test_preemption_with_prefix_cache(eviction, port):
    """A tiny pool preempts while prefixes are shared: eviction never frees
    or rolls back a block another chain reads, and streams equal an ample
    cache-off pool's."""
    wl = lambda m, v: shared_workload(m, v)
    base, base_rep, _ = run_port(port, wl, prefix_cache=False, admission="watermark")
    assert base_rep.preemptions == 0
    out, rep, sched = run_port(port, wl, prefix_cache=True, num_blocks=10,
                               eviction=eviction)
    assert out == base and rep.preemptions > 0 and drained(sched)
    if eviction == "swap":
        assert rep.swap_outs > 0 and rep.swap_ins == rep.swap_outs


def test_speculative_with_prefix_cache(port):
    """A rejected verify window rolls back through shared blocks (un-links,
    never frees); greedy streams equal plain cache-off decode."""
    wl = lambda m, v: shared_workload(m, v)
    base, _, _ = run_port(port, wl, prefix_cache=False)
    out, rep, sched = run_port(port, wl, prefix_cache=True, spec_k=2, rank=16)
    assert out == base and rep.draft_forwards > 0 and rep.prefix_cache_hits > 0
    assert rep.acceptance_rate < 1.0 and drained(sched)


def test_int8_prefix_cache_invariant(port):
    wl = lambda m, v: shared_workload(m, v)
    base, _, _ = run_port(port, wl, prefix_cache=False, cache_dtype="int8")
    out, rep, sched = run_port(port, wl, prefix_cache=True, cache_dtype="int8")
    assert out == base and rep.pool_dtype == "int8"
    assert rep.prefix_cache_hits > 0 and rep.prefix_cache_hit_tokens > 0 and drained(sched)


def test_sparse_prefix_cache_invariant(port):
    """Partial-width sparse decode with swap eviction: a shared block's
    summary rows are what a re-prefill would write, so selection and
    streams are unchanged by the cache."""
    wl = lambda m, v: shared_workload(m, v)
    kw = dict(sparse_topk_blocks=2, sparse_recent_blocks=1, eviction="swap")
    base, _, _ = run_port(port, wl, prefix_cache=False, **kw)
    out, rep, sched = run_port(port, wl, prefix_cache=True, **kw)
    assert out == base and rep.sparse_steps > 0
    assert rep.prefix_cache_hits > 0 and rep.mean_selected_blocks < rep.mean_candidate_blocks


def test_serve_cli_prefix_cache_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "4", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "48", "--prompt-len", "6",
                      "--new-tokens", "4", "--prefill-chunk", "8", "--prefix-cache",
                      "--shared-prefix", "12"])
    out = capsys.readouterr().out
    assert rep.completed == 4 and rep.prefix_cache_hit_tokens > 0
    assert "prefix cache: hit_rate=" in out and "pc[" in out


# ---------------------------------------------------------------------------
# the mechanism
# ---------------------------------------------------------------------------

def _cfg():
    return get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=64).with_elitekv(
        elite_r=2, d_ckv=8)


def test_lookup_caps_final_token_and_refreshes_lru():
    pool = PagedKVPool(_cfg(), 8, 4, device="cpu")
    bm = BlockManager(pool, prefix_cache=True)
    toks = np.arange(12, dtype=np.int32)
    bm.grow(0, 12)
    assert bm.register_prefix(0, toks) == 3
    assert bm.lookup_prefix(1, toks) == 8                  # not 12
    assert bm.lookup_prefix(2, np.arange(13, dtype=np.int32)) == 12
    assert pool._refcount[pool.block_table(0)[0]] == 3
    for sid in (0, 1, 2):
        bm.release(sid)
    assert bm.prefix.num_retained == 3 and pool.allocator.num_free == 5
    assert bm.lookup_prefix(3, np.arange(9, dtype=np.int32)) == 8
    assert bm.prefix.num_retained == 1                     # two back in a chain
    bm.grow(4, 6 * 4)                                      # reclaims the last one
    assert bm.prefix.reclaimed == 1
    assert set(pool.block_table(3)).isdisjoint(pool.block_table(4))


def test_lru_order_and_first_claim():
    pc = PrefixCache()
    for b in (1, 2, 3):
        assert pc.claim(bytes([b]) * 32, b) and pc.retain(b)
    pc.retain(1)                                            # 1 becomes the newest
    assert pc.reclaim(2) == [2, 3] and pc.reclaim(5) == [1]
    assert pc.num_retained == pc.num_cached == 0 and pc.reclaimed == 3
    assert pc.claim(b"a" * 32, 7) and not pc.claim(b"a" * 32, 8)
    assert not pc.claim(b"b" * 32, 7)
    pc.invalidate(7)
    assert pc.get(b"a" * 32) is None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cow_copies_block_and_summary_rows(dtype, port):
    cfg, tp, tb = port
    bs, sp = 4, 8
    pool = PagedKVPool(cfg, 8, bs, device="cpu", dtype=dtype, block_summaries=True)
    bm = BlockManager(pool, prefix_cache=True)
    toks = np.arange(sp, dtype=np.int32) % cfg.vocab_size
    pool.ensure_capacity(0, sp)
    lm.apply_prefill_paged(tp, tb, cfg, torch.from_numpy(toks[None]), pool.pages,
                           torch.from_numpy(pool.prefill_slot_mapping(0, 0, sp, sp)[None]))
    bm.register_prefix(0, toks)
    assert bm.lookup_prefix(1, toks) == 4
    b0 = pool.block_table(0)[0]
    pages = pool.pages["p0"]

    def content(block):
        return {n: (a[:, block] if n.endswith(("_blkmean", "_blkmax"))
                    else a[:, block * bs:(block + 1) * bs]).clone() for n, a in pages.items()}

    before = content(b0)
    assert any(float(v.abs().sum()) > 0 for v in before.values())
    bm.prepare_write(1, 0, 4)
    new = pool.block_table(1)[0]
    assert new != b0 and pool.cow_copies == 1 and pool.stats().cow_copies == 1
    assert pool._refcount[b0] == pool._refcount[new] == 1
    assert bm.prefix.is_cached(b0) and not bm.prefix.is_cached(new)
    for n in pages:
        assert torch.equal(content(b0)[n], before[n]), n
        assert torch.equal(content(new)[n], before[n]), n
    bm.prepare_write(0, 0, 4)                              # sole owner: drops the claim
    assert pool.cow_copies == 1 and not bm.prefix.is_cached(b0)


def test_truncate_shared_block_unlinks_not_frees():
    pool = PagedKVPool(_cfg(), 8, 4, device="cpu")
    bm = BlockManager(pool, prefix_cache=True)
    toks = np.arange(12, dtype=np.int32)
    bm.grow(0, 12)
    bm.register_prefix(0, toks)
    assert bm.lookup_prefix(1, toks) == 8
    a, b = pool.block_table(1)
    free_before = pool.allocator.num_free
    assert pool.stats().blocks_shared == 2
    bm.truncate(1, 0)
    assert pool.block_table(1) == [] and pool._refcount[a] == pool._refcount[b] == 1
    assert pool.allocator.num_free == free_before and bm.prefix.num_retained == 0
    bm.release(0)
    assert bm.prefix.num_retained == 3 == pool.stats().blocks_retained
    assert pool.allocator.num_free == free_before


_PC_OPS = st.lists(
    st.tuples(st.sampled_from(["grow", "free", "swap_out", "swap_in", "truncate",
                               "lookup", "register", "write"]),
              st.integers(0, 3), st.integers(1, 40)),
    min_size=1, max_size=50)


@given(ops=_PC_OPS, num_blocks=st.integers(3, 10))
@settings(max_examples=25, deadline=None)
def test_block_manager_prefix_cache_conservation(ops, num_blocks):
    """The reference's op-fuzz on the port's ``BlockManager``: after every
    operation the free list, the chain-referenced blocks and the retained
    blocks partition the pool, refcounts equal chain references, a block a
    write barrier covered is exclusively owned and unclaimed, and the hash
    map stays a bijection over cached blocks."""
    pool = PagedKVPool(_cfg(), num_blocks, 4, device="cpu")
    bm = BlockManager(pool, prefix_cache=True)
    pc = bm.prefix
    swapped = {}
    stream = np.arange(64, dtype=np.int32) % 64            # every sequence's tokens

    def check():
        alloc = pool.allocator
        counts = collections.Counter(b for sid in list(pool._tables)
                                     for b in pool.block_table(sid))
        referenced, retained, free = set(counts), set(pc._lru), set(alloc._free)
        assert alloc.num_free + len(referenced) + len(retained) == num_blocks
        assert not referenced & retained and not referenced & free and not retained & free
        assert dict(counts) == pool._refcount, "refcount drift"
        assert retained <= set(pc._by_block)
        assert len(pc._by_hash) == len(pc._by_block)
        assert set(pc._by_hash.values()) == set(pc._by_block)

    for op, sid, tokens in ops:
        try:
            if op == "grow":
                bm.grow(sid, tokens)
            elif op == "free":
                bm.release(sid)
            elif op == "swap_out":
                s = bm.preempt_swap_out(sid, pool.length(sid))
                if s is not None:
                    swapped[sid] = s
            elif op == "swap_in" and sid in swapped and not pool.block_table(sid) \
                    and pool.length(sid) == 0:
                bm.swap_in(sid, swapped.pop(sid))
            elif op == "truncate":
                bm.truncate(sid, min(tokens, pool.length(sid)))
            elif op == "lookup" and not pool.block_table(sid) and pool.length(sid) == 0:
                bm.lookup_prefix(sid, stream[:tokens])
            elif op == "register":
                bm.register_prefix(sid, stream[:pool.length(sid)])
            elif op == "write" and pool.length(sid) > 0:
                length = pool.length(sid)
                start = tokens % length
                bm.prepare_write(sid, start, length)
                table = pool.block_table(sid)
                for bi in range(start // pool.block_size, len(table)):
                    assert pool._refcount[table[bi]] == 1, "write into a shared block"
                    assert not pc.is_cached(table[bi]), "write into a cached block"
        except OutOfBlocks:
            pass                            # a valid outcome; the state must stay sane
        check()
    for sid in list(pool._tables):
        bm.release(sid)
    check()
    assert pool.allocator.num_free + pc.num_retained == num_blocks
