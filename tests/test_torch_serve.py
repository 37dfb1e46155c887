"""The port's greedy ``Scheduler`` against the JAX package's, token for token.

Both schedulers serve the same requests with the same weights (carried by
``repro_torch.interop``); the port runs on the CPU with the kernels' plain
versions.  A greedy stream can only be compared exactly where the argmax is
decided by more than the logits tolerance (1e-4), so the JAX run records the
top-1/top-2 margin of every logits row a token was taken from, and the test
asserts each margin exceeds that tolerance.
"""
import numpy as np
import pytest
import torch

import jax
from repro.runtime import serve_loop as jax_sl

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.runtime import serve_loop

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(tiny_elite_cfg, tiny_elite_model):
    params, buffers = tiny_elite_model
    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=tiny_elite_cfg.num_layers, vocab_size=tiny_elite_cfg.vocab_size)
    cfg = cfg.with_elitekv(elite_r=tiny_elite_cfg.elitekv.elite_r,
                           d_ckv=tiny_elite_cfg.elitekv.d_ckv)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, buffers),
                                    tiny_elite_cfg, device="cpu")
    return cfg, tp, tb


def _margin(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def _record_margins(sched, margins):
    """Wrap a JAX scheduler's decode forward and single-row sampler so every
    logits row a greedy token is taken from leaves its top-2 margin."""
    decode, sample_one = sched._decode, sched._sample_one

    def rec_decode(params, buffers, tokens, pages, sm, bt, lengths):
        logits, pages = decode(params, buffers, tokens, pages, sm, bt, lengths)
        rows = np.asarray(logits[:, -1])[np.asarray(lengths) > 0]
        margins.extend(_margin(r) for r in rows)
        return logits, pages

    def rec_sample_one(req, row, count):
        margins.append(_margin(row))
        return sample_one(req, row, count)

    sched._decode, sched._sample_one = rec_decode, rec_sample_one


def _requests(mod, vocab, n, lo, hi, max_new, seed, spacing):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(lo, hi)))
                        .astype(np.int32), max_new_tokens=max_new, arrival=i * spacing)
            for i in range(n)]


WORKLOADS = {
    # whole-prompt prefill at admission, bucketed padding
    "oneshot": (dict(max_slots=2, block_size=4, num_blocks=64, max_len=32,
                     prefill_bucket=4), dict(n=3, lo=5, hi=14, max_new=8, seed=2,
                                             spacing=0.5)),
    # chunk 4, 2 lanes (the reference's phase-breakdown workload)
    "chunked": (dict(max_slots=2, block_size=4, num_blocks=64, max_len=32,
                     prefill_bucket=4, prefill_chunk_tokens=4),
                dict(n=3, lo=6, hi=14, max_new=6, seed=9, spacing=0.5)),
    # a 9-block pool: residents collide and the youngest is recomputed
    "preempt": (dict(max_slots=2, block_size=4, num_blocks=9, max_len=48,
                     prefill_bucket=4, prefill_chunk_tokens=4),
                dict(n=4, lo=8, hi=18, max_new=10, seed=3, spacing=0.5)),
}


def match_reference(jax_model, port, scfg_kw, req_kw):
    """Serve the same requests through the JAX ``Scheduler`` and the port's
    (on the CPU) with the same ``SchedulerConfig`` fields; assert equal
    greedy streams, each token decided by more than the logits tolerance,
    and equal step counts.  → (jax report, port report, port scheduler)."""
    jcfg = jax_model[2]
    jsched = jax_sl.Scheduler(*jax_model, jax_sl.SchedulerConfig(**scfg_kw))
    margins = []
    _record_margins(jsched, margins)
    jrep = jsched.run(_requests(jax_sl, jcfg.vocab_size, **req_kw))
    cfg, tp, tb = port
    tsched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**scfg_kw),
                                  device="cpu")
    trep = tsched.run(_requests(serve_loop, cfg.vocab_size, **req_kw))

    assert min(margins) > LOGIT_TOL, "an argmax too close to call at this tolerance"
    want = {r.uid: r.generated for r in jsched.finished}
    got = {r.uid: r.generated for r in tsched.finished}
    assert got == want
    assert trep.completed == jrep.completed == req_kw["n"]
    assert trep.decode_steps == jrep.decode_steps
    assert trep.prefill_chunks == jrep.prefill_chunks
    assert trep.preemptions == jrep.preemptions
    assert tsched.pool.allocator.num_free == tsched.pool.num_blocks
    return jrep, trep, tsched


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_scheduler_streams_match_reference(name, tiny_elite_cfg, tiny_elite_model, port):
    scfg_kw, req_kw = WORKLOADS[name]
    jrep, trep, tsched = match_reference((*tiny_elite_model, tiny_elite_cfg), port,
                                         scfg_kw, req_kw)
    if name == "preempt":
        assert jrep.preemptions > 0 and trep.preemptions > 0
        assert any(p > 0 for r in tsched.finished for p in r.preempted_at)


def test_generate_paged_matches_reference(tiny_elite_cfg, tiny_elite_model, port):
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, tiny_elite_cfg.vocab_size, (2, 10)).astype(np.int32)
    want, _ = jax_sl.generate_paged(*tiny_elite_model, tiny_elite_cfg, prompts, 6)
    cfg, tp, tb = port
    got, rep = serve_loop.generate_paged(tp, tb, cfg, prompts, 6, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rep.completed == 2 and rep.decoded_tokens == 12


def test_params_on_another_device_raise(port):
    cfg, tp, tb = port
    with pytest.raises(ValueError, match="device"):
        serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(), device="meta")


def test_serve_driver_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--elitekv", "--stream", "--device", "cpu",
                      "--requests", "3", "--rate", "1.0", "--max-slots", "2",
                      "--block-size", "4", "--num-blocks", "32", "--prompt-len", "10",
                      "--new-tokens", "4", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "completed=3" in out and "phases:" in out
    assert rep.completed == 3
