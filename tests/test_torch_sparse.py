"""The port's block-top-k sparse decode, held to the JAX package's.

* ``select_topk_blocks`` returns exactly the reference's ``sel_tables`` and
  ``sel_counts``, ties included: the forced tail (all scoring 1e30), the
  non-resident entries (all -1e30) and blocks with identical summaries go to
  the lower logical index, as ``jax.lax.top_k`` breaks them.
* The block-summary leaves equal the reference's after the same prefill and
  decode writes (1e-5: masked means summed in another order), f32 and int8.
* Greedy streams equal the JAX ``Scheduler``'s for partial-width sparse
  decode under watermark admission, on f32 and int8 pools.
* The port's own invariants: a full-width selection decodes the dense bits
  (logits ``torch.equal``), the unsound partial-sparse-with-recompute
  setting is refused, and summary leaves exist only for sparse decode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jax_ref

from repro_torch.core.cache import BLOCK_SUMMARY_SUFFIXES, PagedKVPool
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from test_torch_quant import drive_pools, models  # noqa: F401 (fixture)
from test_torch_serve import WORKLOADS, _requests, match_reference, port  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _selection_case(kind):
    """(q_lat, blk_mean, blk_max, block_tables, lengths, bs, num_sel, recent)."""
    rng = np.random.default_rng(11)
    B, nh, dc, bs, mb, n_blocks = 5, 4, 16, 4, 8, 40
    lengths = np.asarray([0, 5, 17, 32, 30], np.int32)
    bt = np.zeros((B, mb), np.int32)
    perm = 1 + rng.permutation(n_blocks - 1)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-int(L) // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    bt[4, 2] = bt[4, 5]                  # a physical block twice in one chain
    q = rng.standard_normal((B, nh, dc)).astype(np.float32)
    mean = rng.standard_normal((n_blocks, dc)).astype(np.float32)
    amax = np.abs(rng.standard_normal((n_blocks, dc))).astype(np.float32)
    num_sel, recent = {"random": (4, 1), "forced_tail": (2, 5),
                       "non_resident": (mb, 1), "identical": (3, 1)}[kind]
    if kind == "identical":              # every block scores the same
        mean[:] = mean[0]
        amax[:] = amax[0]
    return q, mean, amax, bt, lengths, bs, num_sel, recent


@pytest.mark.parametrize("kind", ["random", "forced_tail", "non_resident", "identical"])
def test_select_topk_blocks_matches_reference(kind):
    q, mean, amax, bt, lengths, bs, num_sel, recent = _selection_case(kind)
    want_t, want_c = jax_ref.select_topk_blocks(
        jnp.asarray(q), jnp.asarray(mean), jnp.asarray(amax), jnp.asarray(bt),
        jnp.asarray(lengths), bs, num_sel, recent)
    got_t, got_c = ops.select_topk_blocks(
        torch.from_numpy(q), torch.from_numpy(mean), torch.from_numpy(amax),
        torch.from_numpy(bt), torch.from_numpy(lengths), bs, num_sel, recent)
    assert got_t.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    if kind == "non_resident":           # the whole table: the identity selection
        np.testing.assert_array_equal(got_t.numpy(), bt)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_block_summaries_match_reference(models, dtype):
    jpool, tpool, want, got = drive_pools(models, dtype, summaries=True)
    key = "c" if "c" in tpool.pages["p0"] else "c_k"
    for sfx in BLOCK_SUMMARY_SUFFIXES:
        leaf = tpool.pages["p0"][key + sfx]
        assert leaf.dtype == torch.float32
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jpool.pages["p0"][key + sfx]),
                                   atol=1e-5, rtol=1e-5)
    assert tpool.pages["p0"][key + "_blkmax"].any()
    np.testing.assert_allclose(got, want, atol=5e-3 if dtype == "int8" else 1e-4, rtol=0)


SPARSE = dict(admission="watermark", sparse_topk_blocks=1, sparse_recent_blocks=1)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["oneshot", "chunked"])
def test_sparse_streams_match_reference(name, dtype, tiny_elite_cfg, tiny_elite_model,
                                        port):
    scfg_kw, req_kw = WORKLOADS[name]
    jrep, trep, _ = match_reference((*tiny_elite_model, tiny_elite_cfg), port,
                                    dict(scfg_kw, cache_dtype=dtype, **SPARSE), req_kw)
    assert trep.sparse_steps == jrep.sparse_steps == trep.decode_steps > 0
    assert trep.mean_selected_blocks == jrep.mean_selected_blocks
    assert trep.mean_candidate_blocks == jrep.mean_candidate_blocks
    assert trep.mean_selected_blocks < trep.mean_candidate_blocks   # really partial
    assert trep.summary().endswith(
        f"sparse[k=1+1 sel={trep.mean_selected_blocks:.1f}/"
        f"{trep.mean_candidate_blocks:.1f}]")


def _prefilled_pool(port, dtype):
    """A summaries pool holding two prompts (one padded) → (pool, tables,
    lengths) ready for a decode step of both plus an idle lane."""
    cfg, tp, tb = port
    bs = 4
    pool = PagedKVPool(cfg, 16, bs, device="cpu", dtype=dtype, block_summaries=True)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    for sid, n in enumerate([16, 11]):
        pool.ensure_capacity(sid, n + 1)
    sm = np.stack([pool.prefill_slot_mapping(sid, 0, n, 16)
                   for sid, n in enumerate([16, 11])])
    lm.apply_prefill_paged(tp, tb, cfg, torch.from_numpy(toks), pool.pages,
                           torch.from_numpy(sm))
    return pool, pool.block_table_array([0, None, 1], 5), np.asarray([17, 0, 12], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_full_width_sparse_decode_is_dense(port, dtype):
    """topk + recent >= the table width selects the whole chain: the same
    logits and pool contents, bit for bit."""
    cfg, tp, tb = port
    pool, bt, lengths = _prefilled_pool(port, dtype)
    sm = pool.slot_mapping([0, None, 1], [16, 0, 11])
    toks = torch.tensor([[5], [0], [9]], dtype=torch.int32)
    pages = {"p0": {k: v.clone() for k, v in pool.pages["p0"].items()}}
    dense = lm.apply_decode_paged(tp, tb, cfg, toks, pool.pages, torch.from_numpy(sm),
                                  bt, lengths, 4)
    sparse = lm.apply_decode_paged(tp, tb, cfg, toks, pages, torch.from_numpy(sm),
                                   bt, lengths, 4, sparse_topk=bt.shape[1], sparse_recent=2)
    assert torch.equal(sparse, dense)
    for k, v in pool.pages["p0"].items():
        assert torch.equal(pages["p0"][k], v), k


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_full_width_sparse_streams_equal_dense(port, dtype):
    cfg, tp, tb = port
    scfg_kw, req_kw = WORKLOADS["preempt"]
    run = lambda **kw: serve_loop.Scheduler(
        tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw, cache_dtype=dtype, **kw),
        device="cpu")
    reqs = lambda: _requests(serve_loop, cfg.vocab_size, **req_kw)
    dense = run()
    drep = dense.run(reqs())
    width = -(-scfg_kw["max_len"] // scfg_kw["block_size"])
    sparse = run(sparse_topk_blocks=width)   # full width: recompute stays sound
    srep = sparse.run(reqs())
    assert ({r.uid: r.generated for r in sparse.finished}
            == {r.uid: r.generated for r in dense.finished})
    assert srep.preemptions == drep.preemptions > 0
    assert srep.mean_selected_blocks == srep.mean_candidate_blocks > 0


@pytest.mark.parametrize("kw,match", [
    (dict(sparse_topk_blocks=2, sparse_recent_blocks=1), "watermark"),
    (dict(sparse_topk_blocks=2, speculate_k=2), "mutually exclusive"),
    (dict(sparse_topk_blocks=-1), ">= 0"),
])
def test_unsound_sparse_settings_raise(port, kw, match):
    cfg, tp, tb = port
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=4, num_blocks=16,
                                      max_len=64, **kw)
    with pytest.raises(ValueError, match=match):
        serve_loop.Scheduler(tp, tb, cfg, scfg, device="cpu")


def test_summary_leaves_only_with_sparse_decode(port):
    cfg, tp, tb = port
    kw = dict(max_slots=2, block_size=4, num_blocks=16, max_len=64, admission="watermark")
    names = lambda **extra: set(serve_loop.Scheduler(
        tp, tb, cfg, serve_loop.SchedulerConfig(**kw, **extra), device="cpu").pool.pages["p0"])
    assert names() == {"k_e", "c"}
    assert names(sparse_topk_blocks=2) == {"k_e", "c", "c_blkmean", "c_blkmax"}
    assert names(sparse_topk_blocks=2, cache_dtype="int8") == {
        "k_e", "c", "k_e_scale", "c_scale", "c_blkmean", "c_blkmax"}


def test_serve_cli_int8_sparse_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--pool-dtype", "int8", "--sparse-topk", "1", "--sparse-recent", "1",
                      "--admission", "watermark", "--requests", "3", "--rate", "1.0",
                      "--max-slots", "2", "--block-size", "4", "--num-blocks", "32",
                      "--prompt-len", "10", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert rep.completed == 3 and rep.pool_dtype == "int8" and rep.sparse_steps > 0
    assert "pool[int8" in out and "sparse decode [topk=1 recent=1]" in out
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                    "--sparse-topk", "1"])
