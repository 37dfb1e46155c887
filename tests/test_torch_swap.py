"""Host-swap eviction in the port, held to the JAX package's.

* A swap-out then swap-in onto another chain restores a sequence's pages
  byte for byte: f32 pages written by a real prefill, and (as a property
  over lengths) int8 codes with their f32 scales and the block-summary rows
  in chain order.  ``swap_in`` raises ``OutOfBlocks`` on a full pool;
  nothing cached is a plain requeue.
* Preempted == undisturbed: greedy and sampled streams on a pool tight
  enough to preempt equal the ample watermark pool's, under recompute and
  swap eviction, and equal the JAX ``Scheduler``'s with the same counters
  (preemptions, swaps, swapped bytes).
* Partial-width sparse decode with preempt admission is accepted with swap
  eviction (and still refused with recompute); its selection is stable
  under swap: streams equal the undisturbed pool's.  The int8 pool too.
* An op-fuzz of grow / free / swap / truncate keeps the allocator exactly
  conserved (the reference's property, on the port).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_config
from repro_torch.core.cache import BlockManager, OutOfBlocks, PagedKVPool
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from test_torch_sampling import match_sampled
from test_torch_serve import port  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=64).with_elitekv(
        elite_r=2, d_ckv=8)


def _live(pool, seq_id, length):
    """{leaf: the sequence's slots in token order, or its chain's summary
    rows}, cloned."""
    slots = torch.from_numpy(pool.flat_slots(seq_id, np.arange(length)))
    chain = torch.tensor(pool.block_table(seq_id)[:-(-length // pool.block_size)])
    return {n: (a[:, chain] if n.endswith(("_blkmean", "_blkmax")) else a[:, slots]).clone()
            for n, a in pool.pages["p0"].items()}


# ---------------------------------------------------------------------------
# the round trip
# ---------------------------------------------------------------------------

def test_swap_roundtrip_restores_prefilled_pages(port):
    cfg, tp, tb = port
    bs, sp = 4, 11
    pool = PagedKVPool(cfg, 16, bs, device="cpu")
    bm = BlockManager(pool)
    pool.ensure_capacity(0, sp)
    tokens = np.zeros((1, 12), np.int32)
    tokens[0, :sp] = np.arange(sp) % cfg.vocab_size
    lm.apply_prefill_paged(tp, tb, cfg, torch.from_numpy(tokens), pool.pages,
                           torch.from_numpy(pool.prefill_slot_mapping(0, 0, sp, 12)[None]))
    before, old = _live(pool, 0, sp), pool.block_table(0)
    assert float(before["k_e"].abs().sum()) > 0
    swapped = bm.preempt_swap_out(0, sp)
    assert swapped.length == sp and pool.block_table(0) == []
    assert bm.preemptions == bm.swap_outs == 1
    assert swapped.nbytes() == bm.swapped_bytes == sp * pool.bytes_per_token()
    host = swapped.leaves()
    assert {n: tuple(t.shape) for n, t in host.items()} == \
        {n: tuple(t.shape) for n, t in before.items()}
    for n in before:
        assert torch.equal(host[n], before[n]), n
    pool.ensure_capacity(99, 2)                    # the restored chain must move
    bm.swap_in(0, swapped)
    assert pool.length(0) == sp and pool.block_table(0) != old and bm.swap_ins == 1
    after = _live(pool, 0, sp)
    for n in before:
        assert torch.equal(after[n], before[n]), n


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@given(length=st.integers(1, 20), seed=st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_swap_roundtrip_byte_exact(dtype, length, seed):
    """Random pages, summaries included: int8 codes and f32 scales and
    summary rows come back bit for bit on a different chain."""
    pool = PagedKVPool(_cfg(), 8, 4, device="cpu", dtype=dtype, block_summaries=True)
    bm = BlockManager(pool)
    pool.ensure_capacity(0, length)
    g = torch.Generator().manual_seed(seed)
    for a in pool.pages["p0"].values():
        a.copy_(torch.randint(-127, 128, a.shape, generator=g, dtype=a.dtype)
                if a.dtype == torch.int8 else torch.rand(a.shape, generator=g) * 2 + 1e-6)
    before, old = _live(pool, 0, length), pool.block_table(0)
    swapped = bm.preempt_swap_out(0, length)
    pool.ensure_capacity(99, 1)                    # force a different chain
    bm.swap_in(0, swapped)
    assert pool.block_table(0) != old
    after = _live(pool, 0, length)
    for n in before:
        assert after[n].dtype == before[n].dtype and torch.equal(after[n], before[n]), n


def test_swap_in_raises_when_pool_full():
    pool = PagedKVPool(_cfg(), 4, 4, device="cpu")
    bm = BlockManager(pool)
    pool.ensure_capacity(0, 12)                    # 3 blocks
    swapped = bm.preempt_swap_out(0, 12)
    pool.ensure_capacity(7, 9)                     # take 3 of 4 blocks
    with pytest.raises(OutOfBlocks):
        bm.swap_in(0, swapped)
    assert bm.preempt_swap_out(1, 0) is None       # nothing cached: a plain requeue
    assert bm.preemptions == 2 and bm.swap_outs == 1


# ---------------------------------------------------------------------------
# preempted == undisturbed, and == the JAX scheduler
# ---------------------------------------------------------------------------

PREEMPT = dict(max_slots=2, block_size=4, num_blocks=9, max_len=48, prefill_bucket=4,
               prefill_chunk_tokens=4)
REQS = dict(n=4, lo=8, hi=18, max_new=10, seed=3, spacing=0.5)


def _port_run(port, temp, **kw):
    from test_torch_sampling import sampled_requests
    cfg, tp, tb = port
    sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**kw), device="cpu")
    rep = sched.run(sampled_requests(serve_loop, cfg.vocab_size, temp=temp, **REQS))
    return {r.uid: r.generated for r in sched.finished}, rep, sched


@pytest.mark.parametrize("eviction", ["recompute", "swap"])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_preempted_streams_match_reference(eviction, temp, tiny_elite_cfg,
                                           tiny_elite_model, port):
    _, rep, sched, _ = match_sampled(
        (*tiny_elite_model, tiny_elite_cfg), port, dict(PREEMPT, eviction=eviction),
        dict(REQS, temp=temp))
    assert rep.preemptions > 0
    assert any(p > 0 for r in sched.finished for p in r.preempted_at)
    if eviction == "swap":
        assert rep.swap_outs > 0 and rep.swap_ins == rep.swap_outs
        assert rep.swapped_bytes > 0 and rep.phase_ms["swap"] > 0
        assert "(swap " in rep.summary()
    assert sched.pool.allocator.num_free == sched.pool.num_blocks
    undisturbed, base, _ = _port_run(port, temp, **dict(PREEMPT, num_blocks=64,
                                                        admission="watermark"))
    assert base.preemptions == 0
    assert {r.uid: r.generated for r in sched.finished} == undisturbed


def test_int8_swap_preempted_equals_undisturbed(port):
    base, _, _ = _port_run(port, 0.8, **dict(PREEMPT, num_blocks=64, admission="watermark",
                                             cache_dtype="int8"))
    out, rep, sched = _port_run(port, 0.8, **dict(PREEMPT, eviction="swap",
                                                  cache_dtype="int8"))
    assert out == base and rep.swap_outs > 0 and rep.pool_dtype == "int8"
    assert sched.pool.allocator.num_free == sched.pool.num_blocks


# ---------------------------------------------------------------------------
# sparse decode with swap eviction
# ---------------------------------------------------------------------------

def test_partial_sparse_needs_swap_with_preempt(port):
    cfg, tp, tb = port
    kw = dict(max_slots=2, block_size=4, num_blocks=16, max_len=64, sparse_topk_blocks=2,
              sparse_recent_blocks=1)
    with pytest.raises(ValueError, match="watermark"):
        serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**kw), device="cpu")
    serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**kw, eviction="swap"),
                         device="cpu")
    with pytest.raises(ValueError, match="eviction"):
        serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(eviction="spill"),
                             device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sparse_selection_stable_under_swap(dtype, port):
    """A genuinely partial selection under forced swaps gives the streams of
    an ample undisturbed pool: swap carries pages and summary rows exactly."""
    kw = dict(PREEMPT, max_len=64, sparse_topk_blocks=2, sparse_recent_blocks=1,
              cache_dtype=dtype)
    base, base_rep, _ = _port_run(port, 0.0, **dict(kw, num_blocks=64, admission="watermark"))
    assert base_rep.preemptions == 0
    assert base_rep.mean_selected_blocks < base_rep.mean_candidate_blocks
    out, rep, sched = _port_run(port, 0.0, **dict(kw, eviction="swap"))
    assert out == base and rep.preemptions > 0
    assert rep.swap_outs > 0 and rep.swap_ins == rep.swap_outs
    assert sched.pool.allocator.num_free == sched.pool.num_blocks


def test_serve_cli_swap_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "4", "--rate", "2.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "9", "--prompt-len", "16",
                      "--new-tokens", "10", "--prefill-chunk", "4", "--eviction", "swap",
                      "--pool-dtype", "int8", "--sparse-topk", "1", "--sparse-recent", "1"])
    out = capsys.readouterr().out
    assert rep.completed == 4 and rep.swap_outs > 0
    assert "preemption [swap]" in out and "host swaps out/in" in out


# ---------------------------------------------------------------------------
# conservation
# ---------------------------------------------------------------------------

_BM_OPS = st.lists(
    st.tuples(st.sampled_from(["grow", "free", "swap_out", "swap_in", "truncate"]),
              st.integers(0, 3), st.integers(1, 40)),
    min_size=1, max_size=40)


@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@given(ops=_BM_OPS, num_blocks=st.integers(2, 8))
@settings(max_examples=25, deadline=None)
def test_block_manager_never_leaks_or_double_frees(ops, num_blocks, pool_dtype):
    pool = PagedKVPool(_cfg(), num_blocks, 4, device="cpu", dtype=pool_dtype)
    bm = BlockManager(pool)
    swapped = {}

    def check():
        alloc = pool.allocator
        assert alloc.num_free + alloc.num_used == num_blocks
        owned = [b for sid in list(pool._tables) for b in pool.block_table(sid)]
        assert len(owned) == len(set(owned)), "chains share a block"
        assert len(owned) == alloc.num_used, "leak or double free"
        assert not set(owned) & set(alloc._free), "owned block on the free list"

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
            elif op == "swap_in" and sid in swapped and not pool.block_table(sid):
                bm.swap_in(sid, swapped.pop(sid))
            elif op == "truncate":
                bm.truncate(sid, min(tokens, pool.length(sid)))
        except OutOfBlocks:
            pass                            # a valid outcome; the state must stay sane
        check()
    for sid in list(pool._tables):
        bm.release(sid)
    assert pool.allocator.num_free == num_blocks
