"""The port's greedy self-speculative decode, held to the JAX package's.

* ``lrd.truncate_joint_rank`` equals the reference's factors (1e-6): ``P Pᵀ``
  does not depend on the signs the SVD picks.  ``make_draft_params`` gives
  the params themselves at full rank and otherwise touches only ``bk``/``bv``.
* ``PagedKVPool.truncate`` rolls a chain back as the reference's does.
* The plain verify versions equal the JAX Pallas verify kernels in
  interpret mode (1e-5, block by block against one softmax), with block
  boundaries inside windows, short windows (pad rows), a ``lengths == 0``
  lane, G 1 and 4, J-LRD and S-LRD, f32 and int8 pages; ``W = 1`` with
  ``q_offsets = lengths - 1`` is decode.
* ``lm.apply_verify_paged`` logits (1e-4) and pages (1e-5) equal the JAX
  forward's after the same writes.
* Greedy speculative streams equal the port's plain streams and the JAX
  ``Scheduler``'s speculative streams, with equal acceptance accounting, for
  window sizes 1, 2, 4 and draft ranks full and 16, one-shot and chunked
  prefill, a pool that preempts, EOS inside a window and the int8 pool.  As
  in ``test_torch_serve.py``, the JAX run records the top-2 margin of every
  logits row a token (or a draft proposal) is taken from, and each margin
  must exceed the logits tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import lrd as jax_lrd
from repro.core import quant as jax_quant
from repro.core.cache import PagedKVPool as JaxPool
from repro.kernels import elite_decode as jax_ed
from repro.models import lm as jax_lm
from repro.runtime import serve_loop as jax_sl

from repro_torch.core import lrd
from repro_torch.core.cache import BlockManager, PagedKVPool
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from test_torch_model import _assert_pages, models  # noqa: F401 (fixture)
from test_torch_serve import LOGIT_TOL, _margin, _requests, port  # noqa: F401 (fixture)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# draft weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [4, 16, 63, 64, 100])
def test_truncate_joint_rank_matches_reference(rank):
    rng = np.random.default_rng(rank)
    bk = rng.standard_normal((64, 2, 56)).astype(np.float32)
    bv = rng.standard_normal((64, 2, 64)).astype(np.float32)
    got = lrd.truncate_joint_rank(bk, bv, rank)
    want = jax_lrd.truncate_joint_rank(bk, bv, rank)
    if rank >= 64:                       # the full rank: the inputs themselves
        assert got[0] is bk and got[1] is bv
    for g, w, x in zip(got, want, (bk, bv)):
        assert g.shape == x.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)


def test_make_draft_params(tiny_elite_cfg, tiny_elite_model, port):
    cfg, tp, tb = port
    d_ckv = cfg.elitekv.d_ckv
    assert lm.make_draft_params(tp, cfg, 0) is tp
    assert lm.make_draft_params(tp, cfg, d_ckv) is tp
    rank = 16
    draft = lm.make_draft_params(tp, cfg, rank)
    jdraft = jax_lm.make_draft_params(tiny_elite_model[0], tiny_elite_cfg, rank)
    for i, (layer, dl) in enumerate(zip(tp["layers"], draft["layers"])):
        bk, bv = dl["attn"]["bk"], dl["attn"]["bv"]
        assert bk.shape == layer["attn"]["bk"].shape and bk.device == layer["attn"]["bk"].device
        assert not torch.allclose(bk, layer["attn"]["bk"])
        M = torch.cat([bk.reshape(d_ckv, -1), bv.reshape(d_ckv, -1)], dim=1).double()
        assert int(torch.linalg.matrix_rank(M, atol=1e-4)) <= rank
        for name, t in (("bk", bk), ("bv", bv)):
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jdraft["blocks"]["p0"]["attn"][name][i]),
                atol=1e-6, rtol=0)
        # every other tensor is the params' own
        assert all(dl["attn"][k] is v for k, v in layer["attn"].items() if k not in ("bk", "bv"))
        assert all(dl[k] is v for k, v in layer.items() if k != "attn")
    assert draft["embed"] is tp["embed"] and draft["lm_head"] is tp["lm_head"]


# ---------------------------------------------------------------------------
# pool rollback
# ---------------------------------------------------------------------------

def test_pool_truncate_frees_tail_blocks(port):
    cfg = port[0]
    pool = PagedKVPool(cfg, num_blocks=8, block_size=4, device="cpu")
    pool.ensure_capacity(0, 15)           # 4 blocks
    assert pool.allocator.num_used == 4
    chain = pool.block_table(0)
    pool.truncate(0, 9)                   # 3 blocks keep the 9 tokens
    assert pool.length(0) == 9
    assert pool.allocator.num_used == 3
    assert pool.block_table(0) == chain[:3]
    pool.truncate(0, 9)                   # idempotent at the same length
    assert pool.allocator.num_used == 3
    pool.truncate(0, 0)                   # the empty chain stays registered
    assert pool.allocator.num_used == 0 and pool.length(0) == 0
    assert pool.block_table(0) == []
    with pytest.raises(AssertionError):
        pool.truncate(0, 5)               # growing is not truncate's job
    pool.truncate(7, 0)                   # an unknown sequence: only 0 ...
    assert 7 not in pool._lengths         # ... and it stays unknown
    with pytest.raises(AssertionError):
        pool.truncate(7, 3)


def test_block_manager_truncate_keeps_residency(port):
    cfg = port[0]
    bm = BlockManager(PagedKVPool(cfg, num_blocks=8, block_size=4, device="cpu"),
                      policy="watermark")
    bm.register(0, 5)
    bm.grow(0, 17)                        # 5 blocks, none still owed
    assert bm.reserved_blocks == 0
    bm.truncate(0, 6)                     # 2 blocks kept, 3 owed again
    assert bm.pool.allocator.num_used == 2 and bm.reserved_blocks == 3
    bm.release(0)
    assert bm.pool.allocator.num_free == 8 and bm.reserved_blocks == 0


# ---------------------------------------------------------------------------
# plain verify versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

SHAPES = [
    (2, 1, 8, 32, 8, False),      # MHA-like, G = 1
    (1, 4, 8, 64, 4, False),      # GQA, G = 4
    (2, 4, 16, 32, 8, True),      # GQA with separate c_k / c_v (S-LRD)
]


def _verify_case(seed, nkv, G, r2, dc, bs, mb, W, windows, separate):
    """Pool of random pages; lane ``b`` has a window of ``n_b`` tokens
    starting at ``q_offsets[b]`` (its chain covers ``q_offsets + n_b``
    tokens), on disjoint random chains padded with block 0."""
    rng = np.random.default_rng(seed)
    B, nh = len(windows), nkv * G
    n_blocks = B * mb + 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = dict(q_e=f(B, W, nh, r2), q_lat=f(B, W, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=f(n_blocks * bs, dc))
    c["c_v"] = f(n_blocks * bs, dc) if separate else c["c_k"]
    perm = np.concatenate([[0], 1 + rng.permutation(n_blocks - 1)])
    bt = np.zeros((B, mb), np.int32)
    offs = np.zeros((B,), np.int32)
    lengths = np.zeros((B,), np.int32)
    used = 0
    for b, (off, n) in enumerate(windows):
        L = off + n if n else 0
        k = -(-L // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
        offs[b], lengths[b] = off, L
    c.update(bt=bt, offs=offs, lengths=lengths)
    return c


def _pages(c, separate, q8):
    """(k_e, c_k, c_v[, three scales]) as numpy, int8 by the reference's
    quantizer when ``q8``."""
    if not q8:
        return [c["k_e"], c["c_k"], c["c_v"]]
    q = {}
    for name in ("k_e", "c_k", "c_v") if separate else ("k_e", "c_k"):
        page, s = jax_quant.quantize_rows(jnp.asarray(c[name]))
        q[name], q[name + "_s"] = np.array(page), np.array(s)
    if not separate:
        q["c_v"], q["c_v_s"] = q["c_k"], q["c_k_s"]
    return [q["k_e"], q["c_k"], q["c_v"], q["k_e_s"], q["c_k_s"], q["c_v_s"]]


def _torch_args(arrays, separate, q8):
    """Torch inputs; under J-LRD c_v (and its scale) is the c_k tensor."""
    t = [torch.from_numpy(a) for a in arrays]
    if not separate:
        t[4] = t[3]
        if q8:
            t[7] = t[6]
    return t


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("nkv,G,r2,dc,bs,separate", SHAPES)
def test_verify_matches_pallas(nkv, G, r2, dc, bs, separate, q8):
    """Windows of W = 3: a dead lane, a full window crossing a block
    boundary, a short window (pad row), a window at position 0, and a
    window ending the chain's last block."""
    mb, W = 4, 3
    windows = [(0, 0), (bs - 1, 3), (bs + 2, 2), (0, 3), (mb * bs - 3, 3)]
    c = _verify_case(7, nkv, G, r2, dc, bs, mb, W, windows, separate)
    arrays = [c["q_e"], c["q_lat"]] + _pages(c, separate, q8) + [c["bt"], c["offs"],
                                                                 c["lengths"]]
    name = "elite_verify_paged" + ("_q8" if q8 else "")
    want = np.asarray(getattr(jax_ed, name)(*map(jnp.asarray, arrays), G, 0.3, bs,
                                            interpret=True))
    got = getattr(ops, name)(*_torch_args(arrays, separate, q8), G, 0.3, bs)
    assert got.dtype == torch.float32 and got.shape == (5, W, nkv * G, dc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0].abs().max()) == 0.0          # dead lane: exact zeros


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_verify_window_of_one_is_decode(q8):
    """W = 1 with q_offsets = lengths - 1 is paged decode: against the
    Pallas decode kernel and the port's plain decode."""
    nkv, G, r2, dc, bs, mb, separate = 2, 4, 16, 32, 8, 4, True
    windows = [(0, 0), (0, 1), (bs - 1, 1), (bs, 1), (2 * bs + 4, 1), (mb * bs - 1, 1)]
    c = _verify_case(8, nkv, G, r2, dc, bs, mb, 1, windows, separate)
    pages = _pages(c, separate, q8)
    sfx = "_q8" if q8 else ""
    dec = [c["q_e"][:, 0], c["q_lat"][:, 0]] + pages + [c["bt"], c["lengths"]]
    want = np.asarray(getattr(jax_ed, "elite_decode_paged" + sfx)(
        *map(jnp.asarray, dec), G, 0.3, bs, interpret=True))
    ver = [c["q_e"], c["q_lat"]] + pages + [c["bt"], c["offs"], c["lengths"]]
    got = getattr(ops, "elite_verify_paged" + sfx)(*_torch_args(ver, separate, q8),
                                                   G, 0.3, bs)
    np.testing.assert_allclose(got[:, 0].numpy(), want, **TOL)
    plain = getattr(ops, "elite_decode_paged" + sfx)(*_torch_args(dec, separate, q8),
                                                      G, 0.3, bs)
    np.testing.assert_allclose(got[:, 0].numpy(), plain.numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the verify forward against the JAX model's
# ---------------------------------------------------------------------------

BS, N_BLOCKS, MB = 4, 16, 6


def test_apply_verify_paged_matches(models):
    """Prefill two prompts, then one verify forward over three lanes: a
    window of 3 crossing a block boundary, an idle lane, and a window of 2
    padded to 3 — logits of every row, and every pool leaf."""
    jcfg, jp, jb, tcfg, tp, tb = models
    rng = np.random.default_rng(3)
    jpool, tpool = JaxPool(jcfg, N_BLOCKS, BS), PagedKVPool(tcfg, N_BLOCKS, BS, device="cpu")
    written = []

    def grow(sid, n):
        jpool.ensure_capacity(sid, n)
        tpool.ensure_capacity(sid, n)

    S, n_valid = 12, [11, 9]
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    for sid, n in enumerate(n_valid):
        grow(sid, n)
    sm = np.stack([tpool.prefill_slot_mapping(sid, 0, n, S) for sid, n in enumerate(n_valid)])
    written += sm[sm < tpool.oob_slot].tolist()
    _, jpool.pages = jax_lm.apply_prefill_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm))
    lm.apply_prefill_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                           torch.from_numpy(sm))

    W, seqs, starts, n_win = 3, [0, None, 1], [11, 0, 9], [3, 0, 2]
    sms = np.full((3, W), tpool.oob_slot, np.int32)
    lengths = np.zeros((3,), np.int32)
    for lane, (sid, st, n) in enumerate(zip(seqs, starts, n_win)):
        if sid is None:
            continue
        grow(sid, st + n)
        sms[lane] = tpool.prefill_slot_mapping(sid, st, n, W)
        lengths[lane] = st + n
    written += sms[sms < tpool.oob_slot].tolist()
    offs = np.asarray(starts, np.int32)
    bt = tpool.block_table_array(seqs, MB)
    assert bt.tolist() == jpool.block_table_array(seqs, MB).tolist()
    toks = rng.integers(0, jcfg.vocab_size, (3, W)).astype(np.int32)
    want, jpool.pages = jax_lm.apply_verify_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sms),
        jnp.asarray(bt), jnp.asarray(offs), jnp.asarray(lengths), block_size=BS)
    got = lm.apply_verify_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                                torch.from_numpy(sms), bt, offs, lengths, BS)
    assert got.shape == (3, W, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    _assert_pages(jpool, tpool, written)


# ---------------------------------------------------------------------------
# the scheduler: speculative == plain == the JAX scheduler's speculative
# ---------------------------------------------------------------------------

BASE = dict(max_slots=2, block_size=4, num_blocks=64, max_len=48, prefill_bucket=4,
            prefill_chunk_tokens=4)
REQS = dict(n=4, lo=8, hi=18, max_new=10, seed=3, spacing=0.5)
CASES = {
    **{f"chunked-k{k}-r{r}": (dict(BASE), k, r) for k in (1, 2, 4) for r in (0, 16)},
    # whole-prompt prefill at admission
    "oneshot-k2-r16": (dict(BASE, prefill_chunk_tokens=0), 2, 16),
    # a 9-block pool: window growth preempts the youngest resident
    "preempt-k2-r16": (dict(BASE, num_blocks=9), 2, 16),
    "preempt-k4-r0": (dict(BASE, num_blocks=9), 4, 0),
    # EOS inside a fully accepted window: the rest of the window drops
    "eos-k4-r0": (dict(BASE), 4, 0),
    "int8-k2-r16": (dict(BASE, cache_dtype="int8"), 2, 16),
    "int8-k4-r0": (dict(BASE, cache_dtype="int8"), 4, 0),
}


def _record_margins(sched, margins):
    """Wrap a JAX scheduler's decode forward (plain and draft), its verify
    forward and its single-row sampler so every logits row a token or a
    proposal is taken from leaves its top-2 margin.  Verify rows past a
    lane's window (padding) are left out."""
    decode, verify, sample_one = sched._decode, sched._verify, sched._sample_one

    def rec_decode(params, buffers, tokens, pages, sm, bt, lengths):
        logits, pages = decode(params, buffers, tokens, pages, sm, bt, lengths)
        rows = np.asarray(logits[:, -1])[np.asarray(lengths) > 0]
        margins.extend(_margin(r) for r in rows)
        return logits, pages

    def rec_verify(params, buffers, tokens, pages, sms, bt, offs, lengths):
        logits, pages = verify(params, buffers, tokens, pages, sms, bt, offs, lengths)
        rows = np.asarray(logits)
        n_win = np.asarray(lengths) - np.asarray(offs)
        for b in np.nonzero(np.asarray(lengths) > 0)[0]:
            margins.extend(_margin(r) for r in rows[b, :n_win[b]])
        return logits, pages

    def rec_sample_one(req, row, count):
        margins.append(_margin(row))
        return sample_one(req, row, count)

    sched._decode, sched._verify, sched._sample_one = rec_decode, rec_verify, rec_sample_one


_PLAIN = {}


def _port_run(port, scfg_kw):
    cfg, tp, tb = port
    sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                 device="cpu")
    rep = sched.run(_requests(serve_loop, cfg.vocab_size, **REQS))
    assert sched.pool.allocator.num_free == sched.pool.num_blocks   # all blocks back
    return {r.uid: r.generated for r in sched.finished}, rep, sched


def _plain(port, scfg_kw):
    """The port's plain greedy streams for a config (cached per config)."""
    key = tuple(sorted(scfg_kw.items()))
    if key not in _PLAIN:
        _PLAIN[key] = _port_run(port, scfg_kw)
    return _PLAIN[key]


def _eos_token(port):
    """A token that first appears at index 2 of some plain stream, so that
    with k = 4 it ends a stream inside its first verify window."""
    streams, _, _ = _plain(port, BASE)
    for toks in streams.values():
        if toks[2] not in toks[:2]:
            return toks[2]
    raise AssertionError("no stream has a fresh token at index 2")


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_streams_match(case, tiny_elite_cfg, tiny_elite_model, port):
    scfg_kw, k, rank = CASES[case]
    if case.startswith("eos"):
        scfg_kw = dict(scfg_kw, eos_id=_eos_token(port))
    plain, prep, _ = _plain(port, scfg_kw)
    spec_kw = dict(scfg_kw, speculate_k=k, draft_rank=rank)

    jsched = jax_sl.Scheduler(*tiny_elite_model, tiny_elite_cfg,
                              jax_sl.SchedulerConfig(**spec_kw))
    margins = []
    _record_margins(jsched, margins)
    jrep = jsched.run(_requests(jax_sl, tiny_elite_cfg.vocab_size, **REQS))
    got, rep, sched = _port_run(port, spec_kw)

    assert min(margins) > LOGIT_TOL, "an argmax too close to call at this tolerance"
    assert got == plain
    assert got == {r.uid: r.generated for r in jsched.finished}
    for field in ("completed", "decode_steps", "draft_forwards", "draft_proposed",
                  "draft_accepted", "prefill_chunks", "preemptions"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.acceptance_by_bucket == pytest.approx(jrep.acceptance_by_bucket)
    assert rep.tokens_per_forward == pytest.approx(jrep.tokens_per_forward)
    assert rep.completed == REQS["n"] and rep.speculate_k == k and rep.draft_rank == rank
    assert rep.draft_proposed > 0
    assert f"spec[k={k},r={rank}]" in rep.summary()
    assert set(rep.phase_ms) == set(serve_loop.PHASES) and rep.phase_ms["verify"] > 0
    if rank == 0:                                    # the draft is the model
        # (an EOS inside a window drops accepted drafts: they are not kept)
        assert rep.acceptance_rate == 1.0 or case.startswith("eos")
        assert rep.tokens_per_forward > 1 and rep.mean_accepted > 0
        assert rep.decode_steps < prep.decode_steps      # fewer forwards
    if case.startswith("preempt"):
        assert rep.preemptions > 0
    if case.startswith("eos"):
        cut = [r for r in sched.finished if r.finish_reason == "eos"]
        assert any(len(r.generated) == 3 for r in cut)
    if case.startswith("int8"):
        assert rep.pool_dtype == "int8"


# ---------------------------------------------------------------------------
# sampled speculative decode
# ---------------------------------------------------------------------------

SAMPLED = {
    "k2": (dict(BASE), 2),
    # window growth preempts; swap eviction restores the prefix exactly
    "preempt-swap-k4": (dict(BASE, num_blocks=9, eviction="swap"), 4),
    "int8-k2": (dict(BASE, cache_dtype="int8"), 2),
}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampled_full_rank_matches_plain(case, tiny_elite_cfg, tiny_elite_model, port):
    """A full-rank draft proposes from the target's own distribution, so
    rejection sampling accepts everything and the bonus token is drawn with
    plain decode's count-folded key: the sampled stream equals plain
    sampled decode's, and the JAX scheduler's speculative one."""
    from test_torch_sampling import match_sampled, sampled_requests
    scfg_kw, k = SAMPLED[case]
    cfg, tp, tb = port
    plain = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                 device="cpu")
    plain.run(sampled_requests(serve_loop, cfg.vocab_size, **REQS))
    spec_kw = dict(scfg_kw, speculate_k=k, draft_rank=0)
    if case == "int8-k2":
        sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**spec_kw),
                                     device="cpu")
        rep = sched.run(sampled_requests(serve_loop, cfg.vocab_size, **REQS))
    else:
        jrep, rep, sched, _ = match_sampled((*tiny_elite_model, tiny_elite_cfg), port,
                                            spec_kw, REQS)
        for field in ("draft_forwards", "draft_proposed", "draft_accepted"):
            assert getattr(rep, field) == getattr(jrep, field), field
    assert {r.uid: r.generated for r in sched.finished} == \
        {r.uid: r.generated for r in plain.finished}
    assert rep.acceptance_rate == 1.0 and rep.draft_proposed > 0
    assert rep.phase_ms["accept"] > 0
    if case.startswith("preempt"):
        assert rep.preemptions > 0 and rep.swap_outs > 0
    assert sched.pool.allocator.num_free == sched.pool.num_blocks


def test_truncated_sampled_is_well_formed(port):
    """A truncated draft changes the sample path (rejection sampling keeps
    the distribution, not the path), but every request completes its
    budget, accounting is conserved and every block comes back."""
    from test_torch_sampling import sampled_requests
    cfg, tp, tb = port
    sched = serve_loop.Scheduler(
        tp, tb, cfg, serve_loop.SchedulerConfig(**BASE, speculate_k=3, draft_rank=16),
        device="cpu")
    rep = sched.run(sampled_requests(serve_loop, cfg.vocab_size, temp=0.9, **REQS))
    assert rep.completed == 4
    assert all(len(r.generated) == 10 for r in sched.finished)
    assert 0 <= rep.draft_accepted < rep.draft_proposed
    assert 1.0 <= rep.tokens_per_forward <= 4.0
    assert all(0 <= t < cfg.vocab_size for r in sched.finished for t in r.generated)
    assert sched.pool.allocator.num_free == sched.pool.num_blocks


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

def test_speculation_with_sparse_decode_raises(port):
    cfg, tp, tb = port
    scfg = serve_loop.SchedulerConfig(speculate_k=2, sparse_topk_blocks=2,
                                      admission="watermark")
    with pytest.raises(ValueError, match="exclusive"):
        serve_loop.Scheduler(tp, tb, cfg, scfg, device="cpu")
    pool = PagedKVPool(cfg, 8, 4, device="cpu", block_summaries=True)
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="exclusive"):
        lm.elite_attention.apply_verify_paged(
            tp["layers"][0]["attn"], cfg, tb["layers"][0], x,
            {k: v[0] for k, v in pool.pages["p0"].items()},
            lm.elite_attention.write_index(torch.full((2,), pool.oob_slot), 32, "cpu"),
            torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 4)


def test_serve_cli_speculates_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "3", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "32", "--prompt-len", "10",
                      "--new-tokens", "6", "--prefill-chunk", "4", "--speculate", "2",
                      "--draft-rank", "16"])
    out = capsys.readouterr().out
    assert "spec[k=2,r=16]" in out and "speculative decode [k=2 rank=16]" in out
    assert rep.completed == 3 and rep.draft_forwards > 0
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                    "--speculate", "2", "--sparse-topk", "2", "--admission", "watermark"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_verify_dispatch_takes_plain_version_on_cpu():
    """CPU tensors run the plain verify and launch nothing."""
    ops.reset_launches()
    c = _verify_case(2, 1, 2, 4, 16, 4, 2, 2, [(3, 2), (0, 1)], False)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    got = ops.elite_verify_paged(t["q_e"], t["q_lat"], t["k_e"], t["c_k"], t["c_k"],
                                 t["bt"], t["offs"], t["lengths"], 2, 0.5, 4)
    want = ref.elite_verify_paged_ref(t["q_e"], t["q_lat"], t["k_e"], t["c_k"], t["c_k"],
                                      t["bt"], t["offs"], t["lengths"], 2, 0.5, 4)
    assert torch.equal(got, want)
    assert not any(ops.launches().values())
