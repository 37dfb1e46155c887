"""The port's sampler, held to the JAX package's.

* ``runtime/prng.py``: keys, ``fold_in``, 32-bit random bits and uniforms
  are bitwise ``jax.random``'s (threefry2x32, partitionable), at shape ``()``
  and ``(V,)``, for int32 seeds at both ends of the range; the Gumbel noise
  is within ``GUMBEL_TOL`` (its two logarithms may round otherwise).
* ``sample_tokens`` draws the reference's token on 64 lanes of random
  logits for every temperature and top-p of a grid; temperature 0 is the
  argmax itself.  The comparison is exact where the draw is decided by more
  than the noise tolerance: the test computes the reference's Gumbel-max
  scores and nucleus boundary and asserts each clears its tolerance.
* ``nucleus_probs``, ``speculative_accept`` and ``residual_sample`` equal
  the reference's; the accept-or-resample rule preserves the target
  distribution and the sampler never leaves the nucleus.
* Sampled streams of the port's ``Scheduler`` equal the JAX ``Scheduler``'s
  token for token, one-shot and chunked.  ``record_sampled_margins`` keeps
  the margin of every JAX draw.  Greedy tokens must clear the logits
  tolerance, as in ``test_torch_serve.py``.  A sampled draw moves with a
  reorder of near-equal logits (the noise follows the sorted position), so
  some draws are not decided at that tolerance: the streams must be equal
  all the same, and a failure counts those draws.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from repro.runtime import serve_loop as jax_sl

from repro_torch.runtime import prng, serve_loop
import sampling_margins
from test_torch_serve import LOGIT_TOL, _margin, port  # noqa: F401 (fixture)

#: |port gumbel - jax gumbel| (values up to ~16, one ulp there is 2e-6)
GUMBEL_TOL = 1e-5
SEEDS = [0, 1, 2**31 - 1, -7]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_bits_and_uniforms_are_jax_bits(seed):
    V = 333
    seeds = torch.tensor([seed] * 4)
    counts = torch.arange(4)
    tk = prng.fold_in(prng.key(seeds), counts)
    bits = prng.random_bits(tk, V)
    unif = prng.uniform(tk, V)
    for c in range(4):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), c)
        hk = prng.fold_in(prng.key(seed), c)
        assert [int(x) for x in np.asarray(jk)] == list(hk) == [int(tk[0][c]), int(tk[1][c])]
        np.testing.assert_array_equal(bits[c].numpy(),
                                      np.asarray(jax.random.bits(jk, (V,))).astype(np.int64))
        assert prng.random_bits(hk, 0) == int(jax.random.bits(jk))
        ju = np.asarray(jax.random.uniform(jk, (V,)))
        assert ju.dtype == np.float32
        np.testing.assert_array_equal(unif[c].numpy().view(np.int32), ju.view(np.int32))
        assert prng.uniform(hk) == float(jax.random.uniform(jk))
        for salt in (0x5BEC, 0x5BED):
            assert serve_loop._spec_uniform(seed, c, salt) == jax_sl._spec_uniform(seed, c, salt)


def test_prng_scalar_tensor_key_and_gumbel():
    seeds = torch.arange(-32, 32) * 104729
    counts = torch.arange(64) % 5
    tk = prng.fold_in(prng.key(seeds), counts)
    scalar = prng.random_bits(tk, 0)
    g = prng.gumbel(tk, 1024)
    for i in range(0, 64, 9):
        jk = jax.random.fold_in(jax.random.PRNGKey(int(seeds[i])), int(counts[i]))
        assert int(scalar[i]) == int(jax.random.bits(jk))
        jg = np.asarray(jax.random.gumbel(jk, (1024,), mode="low"))
        np.testing.assert_allclose(g[i].numpy(), jg, atol=GUMBEL_TOL, rtol=0)
    assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# the batched sampler
# ---------------------------------------------------------------------------

@jax.jit
@jax.vmap
def _jax_pieces(lg, temp, top_p, seed, count):
    """The reference's ``sample_tokens`` sampled branch, up to the argmax:
    → (sorted scaled logits, Gumbel noise by sorted position, excluded mass
    before each position)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), count)
    scaled = lg.astype(jnp.float32) / jnp.maximum(temp, 1e-6)
    sl = scaled[jnp.argsort(-scaled)]
    probs = jax.nn.softmax(sl)
    return sl, jax.random.gumbel(key, sl.shape, sl.dtype), jnp.cumsum(probs) - probs


def jax_margins(logits, temps, top_ps, seeds, counts, logit_tol: float):
    """[(margin, tolerance)] of every sampled lane of a reference draw:
    ``sampling_margins.decided_by`` of the reference's pieces at the logits
    error over the temperature, against the noise's error (twice
    ``GUMBEL_TOL``: winner and rival)."""
    logits = np.asarray(logits, np.float32)
    temps, top_ps = np.asarray(temps, np.float32), np.asarray(top_ps, np.float32)
    sl, g, excl = (torch.from_numpy(np.asarray(a, np.float64)) for a in _jax_pieces(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(seeds, jnp.int32), jnp.asarray(counts, jnp.int32)))
    tau = torch.from_numpy(logit_tol / np.maximum(temps.astype(np.float64), 1e-6))[:, None]
    margins = sampling_margins.decided_by(sl, g, excl, torch.tensor(top_ps), tau)
    return [(float(margins[i]), 2 * GUMBEL_TOL) for i in np.flatnonzero(temps > 0)]


def record_sampled_margins(sched, margins):
    """Wrap a JAX scheduler so every token it takes leaves a (kind, margin,
    tolerance) triple: greedy rows (decode forwards and single rows) their
    top-2 logits gap against ``LOGIT_TOL``, sampled draws ``jax_margins``."""
    decode, sample, sample_one = sched._decode, sched._sample, sched._sample_one

    def rec_decode(params, buffers, tokens, pages, sm, bt, lengths):
        logits, pages = decode(params, buffers, tokens, pages, sm, bt, lengths)
        rows = np.asarray(logits[:, -1])
        for i, n in enumerate(np.asarray(lengths)):
            req = sched.slots[i]
            if n > 0 and req is not None and req.temperature <= 0:
                margins.append(("greedy", _margin(rows[i]), LOGIT_TOL))
        return logits, pages

    def rec_sample(logits, temps, top_ps, seeds, counts):
        margins.extend(("sampled", *m) for m in
                       jax_margins(logits, temps, top_ps, seeds, counts, LOGIT_TOL))
        return sample(logits, temps, top_ps, seeds, counts)

    def rec_sample_one(req, row, count):
        if req.temperature <= 0:
            margins.append(("greedy", _margin(row), LOGIT_TOL))
        return sample_one(req, row, count)

    sched._decode, sched._sample, sched._sample_one = rec_decode, rec_sample, rec_sample_one


def assert_decided(margins, kind="greedy"):
    """Every recorded draw of ``kind`` was decided by more than its
    tolerance."""
    assert any(k == kind for k, *_ in margins)
    close = [(m, tol) for k, m, tol in margins if k == kind and not m > tol]
    assert not close, f"draws too close to call at their tolerance: {close[:4]}"


def assert_same_streams(got, want, margins):
    """Equal streams.  A sampled draw is a discontinuous function of the
    logits (a reorder of near-equal logits moves the noise), so some draws
    are not decided at the logits tolerance; the streams must be equal all
    the same, and a failure says how many such draws the run had."""
    fragile = sum(1 for k, m, tol in margins if k == "sampled" and not m > tol)
    assert got == want, (f"streams differ; {fragile} of "
                         f"{sum(k == 'sampled' for k, *_ in margins)} sampled draws "
                         f"were not decided at the logits tolerance")


@pytest.mark.parametrize("temp", [0.0, 0.3, 1.0, 2.0])
@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1.0])
def test_sample_tokens_matches_reference(temp, top_p):
    rng = np.random.default_rng(int(temp * 10 + top_p * 100))
    B, V = 64, 200
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[:, 7] = logits[:, 9]                    # ties: the stable sort decides
    temps = np.full(B, temp, np.float32)
    top_ps = np.full(B, top_p, np.float32)
    seeds = rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)
    counts = rng.integers(0, 1000, B).astype(np.int32)
    want = np.asarray(jax_sl.sample_tokens(jnp.asarray(logits), jnp.asarray(temps),
                                           jnp.asarray(top_ps), jnp.asarray(seeds),
                                           jnp.asarray(counts)))
    got = serve_loop.sample_tokens(*(torch.from_numpy(a) for a in
                                     (logits, temps, top_ps, seeds, counts)))
    assert got.dtype == torch.int64 and got.shape == (B,)
    if temp == 0:
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    else:
        assert_decided([("sampled", *m) for m in
                        jax_margins(logits, temps, top_ps, seeds, counts, 0.0)], "sampled")
        assert len(set(got.tolist())) > 1          # really sampled
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own margins call the same draws decided
    margins = sampling_margins.sample_margins(*(torch.from_numpy(a) for a in
                                          (logits, temps, top_ps, seeds, counts)))
    assert margins.shape == (B,)
    if temp > 0:
        assert (margins > 2 * GUMBEL_TOL).all()


def test_mixed_greedy_and_sampled_lanes():
    """Greedy lanes of a sampled batch are their argmax; sampled lanes do
    not depend on the other lanes."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((rng.standard_normal((6, 50)) * 2).astype(np.float32))
    temps = torch.tensor([0.0, 0.8, 0.0, 1.5, -1.0, 0.8])
    top_ps = torch.tensor([0.9, 0.9, 0.2, 1.0, 0.5, 0.95])
    seeds = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    counts = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    got = serve_loop.sample_tokens(logits, temps, top_ps, seeds, counts)
    greedy = logits.argmax(-1)
    assert got[[0, 2, 4]].tolist() == greedy[[0, 2, 4]].tolist()
    for i in (1, 3, 5):
        one = serve_loop.sample_tokens(logits[i:i + 1], temps[i:i + 1], top_ps[i:i + 1],
                                       seeds[i:i + 1], counts[i:i + 1])
        assert int(one[0]) == int(got[i])


def test_a_reorder_of_near_equal_logits_moves_the_noise():
    """The noise follows the sorted position, so two logits that swap order
    swap noise: a draw can change under a move far below its score margin.
    ``flip_distance`` finds the move; for a greedy lane it is half the
    top-2 gap."""
    V = 64
    base = torch.linspace(3.0, -3.0, V)
    temps, top_ps = torch.tensor([1.0]), torch.tensor([1.0])
    seeds, counts = torch.tensor([5], dtype=torch.int32), torch.tensor([0], dtype=torch.int32)
    args = (temps, top_ps, seeds, counts)
    winner = int(serve_loop.sample_tokens(base[None], *args)[0])
    order, sl, noise, _ = serve_loop._gumbel_scores(base[None], *args)
    pos = int((order[0] == winner).nonzero())
    nb = pos + 1 if pos + 1 < V else pos - 1       # the winner's sorted neighbour
    near = base.clone()
    near[int(order[0, nb])] = near[winner] + (1e-6 if nb > pos else -1e-6)
    d = sampling_margins.flip_distance(near[None], *args)[0]
    assert 0 < d < 1e-6
    moved = near.clone()
    moved[int(order[0, nb])] = near[winner] - (1e-6 if nb > pos else -1e-6)   # swap back
    a = int(serve_loop.sample_tokens(near[None], *args)[0])
    b = int(serve_loop.sample_tokens(moved[None], *args)[0])
    assert {a, b} <= {winner, int(order[0, nb])}
    if a != b:                                     # the swap moved the draw
        assert sampling_margins.sample_margins(near[None], *args, tol=1e-5)[0] < 0
    greedy = sampling_margins.flip_distance(base[None], torch.tensor([0.0]), *args[1:])[0]
    assert greedy == pytest.approx(float(base[0] - base[1]) / 2, rel=1e-6)


# ---------------------------------------------------------------------------
# the host-side accept path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_accept_functions_match_reference(seed):
    rng = np.random.default_rng(seed)
    V = 40
    tgt, drf = rng.normal(size=V) * 2, rng.normal(size=V) * 2
    for temp, top_p in ((0.7, 0.9), (1.3, 1.0), (0.2, 0.0), (1.0, 0.5)):
        p = serve_loop.nucleus_probs(tgt, temp, top_p)
        q = serve_loop.nucleus_probs(drf, temp, top_p)
        np.testing.assert_array_equal(p, jax_sl.nucleus_probs(tgt, temp, top_p))
        np.testing.assert_array_equal(q, jax_sl.nucleus_probs(drf, temp, top_p))
        for x in range(V):
            for u in (0.0, 0.3, 0.999):
                assert (serve_loop.speculative_accept(x, p, q, u)
                        == jax_sl.speculative_accept(x, p, q, u))
        for r in (0.0, 0.25, 0.5, 0.999999):
            assert serve_loop.residual_sample(p, q, r) == jax_sl.residual_sample(p, q, r)
        assert serve_loop.residual_sample(p, p, 0.5) == jax_sl.residual_sample(p, p, 0.5)


@given(seed=st.integers(0, 200), V=st.sampled_from([3, 4, 6]),
       temp=st.floats(0.3, 2.0), top_p=st.floats(0.3, 1.0))
@settings(max_examples=8, deadline=None)
def test_rejection_sampling_preserves_target_distribution(seed, V, temp, top_p):
    """Accept-or-resample emits tokens distributed as the target nucleus
    distribution, never outside it (the reference's property, on the
    port's functions)."""
    rng = np.random.default_rng(seed)
    p = serve_loop.nucleus_probs(rng.normal(size=V) * 2.0, temp, top_p)
    q = serve_loop.nucleus_probs(rng.normal(size=V) * 2.0, temp, top_p)
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-9)
    assert p.min() >= 0.0 and (p > 0).any()
    N = 4000
    xs = rng.choice(V, size=N, p=q / q.sum())
    us, rs = rng.random(N), rng.random(N)
    out = np.array([x if serve_loop.speculative_accept(x, p, q, u)
                    else serve_loop.residual_sample(p, q, r)
                    for x, u, r in zip(xs, us, rs)])
    assert np.all(p[out] > 0.0)
    emp = np.bincount(out, minlength=V) / N
    assert 0.5 * np.abs(emp - p).sum() < 0.06     # ≈ 4.5 sigma at N=4000, V<=6


@given(seed=st.integers(0, 500), temp=st.floats(0.2, 3.0), top_p=st.floats(0.1, 1.0))
@settings(max_examples=15, deadline=None)
def test_nucleus_probs_matches_sampler_support(seed, temp, top_p):
    """The sampler's draws stay inside ``nucleus_probs``' support, and a
    full nucleus is the plain softmax."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=8) * 3.0
    p = serve_loop.nucleus_probs(logits, temp, top_p)
    n = 64
    draws = serve_loop.sample_tokens(
        torch.tensor(logits, dtype=torch.float32)[None].expand(n, -1),
        torch.full((n,), temp), torch.full((n,), top_p),
        torch.full((n,), seed, dtype=torch.int32), torch.arange(n, dtype=torch.int32))
    assert np.all(p[draws.numpy()] > 0.0)
    if top_p >= 1.0:
        sc = logits / max(temp, 1e-6)
        sm = np.exp(sc - sc.max()) / np.exp(sc - sc.max()).sum()
        np.testing.assert_allclose(p, sm, atol=1e-9)


# ---------------------------------------------------------------------------
# sampled streams against the JAX scheduler
# ---------------------------------------------------------------------------

def sampled_requests(mod, vocab, n, lo, hi, max_new, seed, spacing, temp=0.8, top_p=0.9,
                     greedy_every=0):
    """Seeded requests with per-request sampling seeds; every
    ``greedy_every``-th request is greedy."""
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(lo, hi)))
                        .astype(np.int32), max_new_tokens=max_new, arrival=i * spacing,
                        temperature=0.0 if greedy_every and i % greedy_every == 0 else temp,
                        top_p=top_p, seed=11 + i)
            for i in range(n)]


def match_sampled(jax_model, port, scfg_kw, req_kw):
    """Serve the same sampled requests through both schedulers; assert equal
    streams, each draw decided by more than its tolerance.  → (jax report,
    port report, port scheduler, jax scheduler)."""
    jcfg = jax_model[2]
    jsched = jax_sl.Scheduler(*jax_model, jax_sl.SchedulerConfig(**scfg_kw))
    margins = []
    record_sampled_margins(jsched, margins)
    jrep = jsched.run(sampled_requests(jax_sl, jcfg.vocab_size, **req_kw))
    cfg, tp, tb = port
    tsched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                  device="cpu")
    trep = tsched.run(sampled_requests(serve_loop, cfg.vocab_size, **req_kw))
    if any(r.temperature <= 0 for r in tsched.finished):
        assert_decided(margins)
    assert_same_streams({r.uid: r.generated for r in tsched.finished},
                        {r.uid: r.generated for r in jsched.finished}, margins)
    assert trep.completed == jrep.completed == req_kw["n"]
    for field in ("decode_steps", "prefill_chunks", "preemptions", "swap_outs", "swap_ins",
                  "swapped_bytes", "prefix_cache_hits", "prefix_cache_misses",
                  "prefix_cache_hit_tokens", "cow_copies", "blocks_retained"):
        assert getattr(trep, field) == getattr(jrep, field), field
    return jrep, trep, tsched, jsched


@pytest.mark.parametrize("chunk", [0, 4])
def test_sampled_streams_match_reference(chunk, tiny_elite_cfg, tiny_elite_model, port):
    scfg = dict(max_slots=3, block_size=4, num_blocks=64, max_len=40, prefill_bucket=4,
                prefill_chunk_tokens=chunk)
    _, trep, tsched, _ = match_sampled(
        (*tiny_elite_model, tiny_elite_cfg), port, scfg,
        dict(n=5, lo=5, hi=14, max_new=10, seed=4, spacing=0.5, greedy_every=3))
    assert trep.phase_ms["sample"] > 0
    # a greedy request in a sampled batch is the argmax stream
    greedy = [r for r in tsched.finished if r.temperature == 0]
    assert greedy and all(len(r.generated) == 10 for r in tsched.finished)


def test_serve_cli_samples_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "3", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "32", "--prompt-len", "10",
                      "--new-tokens", "5", "--temperature", "0.8", "--top-p", "0.9",
                      "--sample-seed", "5"])
    assert rep.completed == 3 and "completed=3" in capsys.readouterr().out
    cfg = serve.build_config("tinyllama_1_1b", reduced=True, cache_ratio=0.25)
    reqs = serve.make_stream(cfg, 3, 1.0, 10, 5, seed=0, temperature=0.8, top_p=0.9,
                             sample_seed=5)
    assert [(r.temperature, r.top_p, r.seed) for r in reqs] == [(0.8, 0.9, 5 + i)
                                                                 for i in range(3)]
