"""The port's int8 pool, held to the JAX package's.

* The quantizer equals ``repro.core.quant`` bit for bit on the same f32
  rows, all-zero rows and exact .5 ties included.
* Pool leaves (names, shapes, dtypes, bytes per token) equal the reference
  pool's.
* After the same prefill and decode writes, the int8 pages agree with the
  reference's: scales to rtol 2e-6, dequantized rows within one code step.
  The rows come out of independent f32 matmuls whose results differ by a
  few ulps (a scale, absmax / 127, inherits that: up to 1.25e-6 relative
  here), and a value at a .5 code boundary may round the other way; the
  test bounds how many codes differ.
* Greedy streams equal the JAX ``Scheduler``'s on an int8 pool, and the
  port's own invariants hold inside the int8 world: chunked == one-shot and
  preempted == undisturbed, token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jax_quant
from repro.core.cache import PagedKVPool as JaxPool
from repro.models import lm as jax_lm

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import quant
from repro_torch.core.cache import PagedKVPool
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from test_torch_serve import WORKLOADS, match_reference, port  # noqa: F401 (fixture)

BS, N_BLOCKS, MB = 4, 16, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _rows(shape, seed):
    """Random rows of ``shape`` at mixed magnitudes; row 0 all zero; with a
    row axis, row 1 holds exact .5 ties (absmax 127 → scale exactly 1)."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(1e-3, 30.0, (shape[0],) + (1,) * (len(shape) - 1))
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    x[0] = 0
    if len(shape) > 1:
        ties = np.resize(np.float32([0.5, 1.5, 2.5, -0.5, -2.5, 126.5]), x[1].size)
        ties[-1] = 127.0
        x[1] = ties.reshape(x[1].shape)
    return x


@pytest.mark.parametrize("shape", [(9, 3, 8), (9, 16), (9,)])
def test_quantize_rows_bit_exact(shape):
    x = _rows(shape, seed=len(shape))
    jq, js = jax_quant.quantize_rows(jnp.asarray(x))
    q, s = quant.quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert float(s[0]) > 0 and not q[0].any()          # zero row: positive scale
    if len(shape) > 1:                                 # half to even on the ties
        assert s[1] == 1.0
        want = np.resize([0, 2, 2, 0, -2, 126], q[1].numel())
        want[-1] = 127
        np.testing.assert_array_equal(q[1].reshape(-1).numpy(), want)
    deq = quant.dequantize(q, s)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jax_quant.dequantize(jq, js)))


def test_roundtrip_rows_bit_exact():
    x = _rows((3, 5, 2, 8), seed=7)
    want = np.asarray(jax_quant.roundtrip_rows(jnp.asarray(x), batch_dims=2))
    got = quant.roundtrip_rows(torch.from_numpy(x), batch_dims=2)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_is_int8():
    assert quant.is_int8("int8") and quant.is_int8(torch.int8)
    assert not quant.is_int8("float32") and not quant.is_int8(torch.float32)


def _port_cfg(jcfg):
    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=jcfg.num_layers, vocab_size=jcfg.vocab_size,
        n_kv_heads=jcfg.n_kv_heads)
    e = jcfg.elitekv
    return dataclasses.replace(cfg, elitekv=EliteKVConfig(
        enabled=True, elite_r=e.elite_r, d_ckv=e.d_ckv, d_ck=e.d_ck, d_cv=e.d_cv,
        lrd=e.lrd))


@pytest.fixture(scope="module", params=["joint", "separate"])
def models(request, tiny_elite_cfg):
    """(jax cfg, params, buffers, port cfg, params, buffers), J-LRD or S-LRD."""
    e = tiny_elite_cfg.elitekv
    jcfg = tiny_elite_cfg if request.param == "joint" else dataclasses.replace(
        tiny_elite_cfg, elitekv=dataclasses.replace(e, lrd="separate", d_ck=32, d_cv=48))
    jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jcfg, jp, jb, _port_cfg(jcfg), tp, tb


@pytest.mark.parametrize("summaries", [False, True], ids=["plain", "summaries"])
def test_pool_leaves_match_reference(models, summaries):
    jcfg, _, _, tcfg, _, _ = models
    jpool = JaxPool(jcfg, N_BLOCKS, BS, dtype="int8", block_summaries=summaries)
    tpool = PagedKVPool(tcfg, N_BLOCKS, BS, device="cpu", dtype="int8",
                        block_summaries=summaries)
    want = {k: (a.shape, str(a.dtype)) for k, a in jpool.pages["p0"].items()}
    got = {k: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
           for k, a in tpool.pages["p0"].items()}
    assert got == want
    assert tpool.bytes_per_token() == jpool.bytes_per_token()
    assert tpool.stats().dtype == jpool.stats().dtype == "int8"


def test_int8_bytes_per_token_formula(tiny_elite_cfg):
    """Int8 J-LRD pool: (n_kv·2r + d_ckv) bytes of codes plus two f32 scales
    per token and layer."""
    cfg = _port_cfg(tiny_elite_cfg)
    e = cfg.elitekv
    per_layer = cfg.n_kv_heads * 2 * e.elite_r + e.d_ckv + 2 * 4
    pool = PagedKVPool(cfg, N_BLOCKS, BS, device="cpu", dtype="int8")
    assert pool.bytes_per_token() == cfg.num_layers * per_layer
    f32 = PagedKVPool(cfg, N_BLOCKS, BS, device="cpu")
    assert f32.bytes_per_token() == cfg.num_layers * 4 * (per_layer - 8)
    with pytest.raises(ValueError, match="dtype"):
        PagedKVPool(cfg, N_BLOCKS, BS, device="cpu", dtype="bfloat16")


def drive_pools(models, dtype, summaries):
    """The same one-shot prefill, resumed chunks and decode step through the
    JAX model and the port into pools of ``dtype`` → (jax pool, port pool,
    last logits of each)."""
    jcfg, jp, jb, tcfg, tp, tb = models
    rng = np.random.default_rng(7)
    jpool = JaxPool(jcfg, N_BLOCKS, BS, dtype=dtype, block_summaries=summaries)
    tpool = PagedKVPool(tcfg, N_BLOCKS, BS, device="cpu", dtype=dtype,
                        block_summaries=summaries)

    def grow(sid, n):
        jpool.ensure_capacity(sid, n)
        tpool.ensure_capacity(sid, n)

    S, n_valid = 12, [12, 9]                 # one-shot, the second padded
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    for sid, n in enumerate(n_valid):
        grow(sid, n)
    sm = np.stack([tpool.prefill_slot_mapping(sid, 0, n, S)
                   for sid, n in enumerate(n_valid)])
    _, jpool.pages = jax_lm.apply_prefill_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm))
    lm.apply_prefill_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                           torch.from_numpy(sm))
    C, starts, n_chunk = 4, [12, 9], [4, 3]  # resumed chunks at their offsets
    toks = rng.integers(0, jcfg.vocab_size, (2, C)).astype(np.int32)
    sm = np.full((2, C), tpool.oob_slot, np.int32)
    for sid, (st, n) in enumerate(zip(starts, n_chunk)):
        grow(sid, st + n)
        sm[sid] = tpool.prefill_slot_mapping(sid, st, n, C)
    cs = np.asarray(starts, np.int32)
    bt = tpool.block_table_array([0, 1], MB)
    _, jpool.pages = jax_lm.apply_prefill_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm),
        chunk_start=jnp.asarray(cs), block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray(cs), block_size=BS)
    lm.apply_prefill_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                           torch.from_numpy(sm), chunk_start=cs, block_tables=bt,
                           prefix_lens=cs, block_size=BS)
    lengths = np.asarray([17, 0, 13], np.int32)   # decode: seq 0, idle, seq 1
    grow(0, 17)
    grow(1, 13)
    sm = tpool.slot_mapping([0, None, 1], [16, 0, 12])
    bt = tpool.block_table_array([0, None, 1], MB)
    toks = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    want, jpool.pages = jax_lm.apply_decode_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm),
        jnp.asarray(bt), jnp.asarray(lengths), block_size=BS)
    got = lm.apply_decode_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                                torch.from_numpy(sm), bt, lengths, BS)
    return jpool, tpool, np.asarray(want), got.numpy()


def test_int8_pages_match_reference(models):
    jpool, tpool, want, got = drive_pools(models, "int8", summaries=False)
    jp, tp = jpool.pages["p0"], tpool.pages["p0"]
    n_codes = n_diff = 0
    for name in ("k_e", "c", "c_k", "c_v"):
        if name not in tp:
            continue
        js, ts = np.asarray(jp[name + "_scale"]), tp[name + "_scale"].numpy()
        np.testing.assert_allclose(ts, js, rtol=2e-6, atol=0)
        jq, tq = np.asarray(jp[name]).astype(np.int32), tp[name].numpy().astype(np.int32)
        step = js.reshape(js.shape + (1,) * (jq.ndim - 2))
        deq_err = np.abs(tq * ts.reshape(step.shape) - jq * step)
        assert np.all(deq_err <= step * (1 + 2e-6)), name   # within one code step
        assert np.abs(tq - jq).max() <= 1
        n_codes += jq.size
        n_diff += int((tq != jq).sum())
    # rows of independent f32 matmuls: a code at a .5 boundary may round the
    # other way, rarely (none of 12288 J-LRD / 14336 S-LRD codes when this
    # was written); at most one code in 200 may differ
    assert n_diff <= n_codes // 200, f"{n_diff} of {n_codes} codes differ"
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("name", ["chunked", "preempt"])
def test_int8_streams_match_reference(name, tiny_elite_cfg, tiny_elite_model, port):
    scfg_kw, req_kw = WORKLOADS[name]
    jrep, trep, tsched = match_reference((*tiny_elite_model, tiny_elite_cfg), port,
                                         dict(scfg_kw, cache_dtype="int8"), req_kw)
    assert trep.pool_dtype == jrep.pool_dtype == "int8"
    assert trep.pool_bytes_per_token == jrep.pool_bytes_per_token
    if name == "preempt":
        assert trep.preemptions > 0


def _port_streams(port, req_seed=3, **scfg_kw):
    cfg, tp, tb = port
    kw = dict(max_slots=2, block_size=4, num_blocks=64, max_len=48, prefill_bucket=4,
              cache_dtype="int8")
    sched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**{**kw, **scfg_kw}),
                                 device="cpu")
    rng = np.random.default_rng(req_seed)
    reqs = [serve_loop.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                          int(rng.integers(8, 18)))
                               .astype(np.int32), max_new_tokens=10, arrival=i * 0.5)
            for i in range(4)]
    rep = sched.run(reqs)
    return {r.uid: r.generated for r in sched.finished}, rep


def test_int8_chunked_equals_oneshot(port):
    oneshot, _ = _port_streams(port)
    chunked, rep = _port_streams(port, prefill_chunk_tokens=4)
    assert chunked == oneshot
    assert rep.prefill_chunks > len(oneshot)


def test_int8_preempted_equals_undisturbed(port):
    calm, calm_rep = _port_streams(port, prefill_chunk_tokens=4)
    tight, rep = _port_streams(port, prefill_chunk_tokens=4, num_blocks=9)
    assert calm_rep.preemptions == 0 and rep.preemptions > 0
    assert tight == calm


# the reference's quality wall (tests/test_quant.py): teacher-forced top-1
# agreement of the int8 pool with the f32 pool, and the bytes it saves
TOP1_AGREEMENT_MIN = 0.95
BYTES_RATIO_MAX = 0.55


def test_int8_top1_agreement_and_footprint():
    """The int8 pool's trade on a random ``lm.init`` model of the port:
    teacher-forced per-position argmax over the int8 pool agrees with the
    f32 pool on at least 95% of positions while bytes per token drop to at
    most 0.55 of f32's.  Both pools score the same f32-greedy streams, so
    every position is an independent comparison."""
    cfg = dataclasses.replace(get_config("tinyllama_1_1b").reduced(
        num_layers=2, vocab_size=128), elitekv=EliteKVConfig(enabled=True, elite_r=4,
                                                              d_ckv=64))
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    B, P, new = 4, 16, 12
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)

    def gen(dtype):
        scfg = serve_loop.SchedulerConfig(max_slots=B, max_new_tokens=new, max_len=32,
                                          num_blocks=48, block_size=8, cache_dtype=dtype)
        return serve_loop.generate_paged(params, buffers, cfg, prompts, new, scfg,
                                         device="cpu")

    out_f, rep_f = gen("float32")
    _, rep_q = gen("int8")
    assert rep_q.pool_dtype == "int8" and rep_f.pool_dtype == "float32"
    assert rep_q.pool_bytes_per_token / rep_f.pool_bytes_per_token <= BYTES_RATIO_MAX
    assert rep_q.pool_allocated_bytes_peak < rep_f.pool_allocated_bytes_peak
    full = torch.from_numpy(np.concatenate([prompts, out_f], axis=1).astype(np.int64))
    n = full.shape[1]

    def forced_logits(dtype):
        pool = PagedKVPool(cfg, num_blocks=4 * B, block_size=8, device="cpu", dtype=dtype)
        sms = []
        for b in range(B):
            pool.ensure_capacity(b, n)
            sms.append(pool.prefill_slot_mapping(b, 0, n, n))
        logits = lm.apply_prefill_paged(params, buffers, cfg, full, pool.pages,
                                        torch.from_numpy(np.stack(sms)))
        return logits[:, P - 1:n - 1].numpy()

    l_f, l_q = forced_logits("float32"), forced_logits("int8")
    assert (l_f.argmax(-1) == out_f).all()     # the metric is sound
    assert float((l_f.argmax(-1) == l_q.argmax(-1)).mean()) >= TOP1_AGREEMENT_MIN
