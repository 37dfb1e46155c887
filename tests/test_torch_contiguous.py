"""The port's lockstep serving over a contiguous cache, held to the JAX
package: the ``rope_elite`` and ``elite_decode`` kernels' plain versions
against the Pallas kernels in interpret mode, EliteKV (J-LRD, S-LRD) and
baseline GQA logits through prefill and decode, ``generate`` token streams
and ``ServeStats``, and the port's own invariants (cache-on == cache-off,
contiguous == paged).

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays; weights cross through ``repro_torch.interop``.  Tolerance is 1e-5
absolute and relative in f32: the same math, summed in another order (the
port attends through its kernels' plain versions where the reference uses
XLA einsums; cos/sin of the two libraries differ in the last ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EliteKVConfig as JaxEliteKVConfig
from repro.core import elite_attention as jax_ea
from repro.core.cache import cache_ratio as jax_cache_ratio
from repro.core.cache import measured_cache_bytes as jax_measured_cache_bytes
from repro.core import rope as jax_rope
from repro.kernels import elite_decode as jax_ed
from repro.kernels import rope_elite as jax_re
from repro.models import lm as jax_lm
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.runtime import serve_loop as jax_sl

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import elite_attention, rope
from repro_torch.core.cache import cache_ratio, measured_cache_bytes
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.runtime import serve_loop

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


# ---------------------------------------------------------------------------
# rope_elite
# ---------------------------------------------------------------------------

def _rope_case(seed, B, S, H, r, per_lane=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, 2 * r)).astype(np.float32)
    # chunk 0 of a head runs at frequency 1.0, so angles reach ~4000 rad
    freqs = np.exp(-rng.uniform(0, 4, (H, r))).astype(np.float32)
    freqs[:, 0] = 1.0
    shape = (B, S) if per_lane else (S,)
    pos = rng.integers(0, 4096, shape).astype(np.int32)
    return x, pos, freqs


@pytest.mark.parametrize("S,H,r", [(16, 4, 4), (32, 2, 8), (8, 32, 8)])
def test_rope_elite_matches_pallas(S, H, r):
    x, pos, freqs = _rope_case(0, 2, S, H, r)
    jx, jp, jf = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(freqs)
    kernel = np.asarray(jax_re.rope_elite(jx, jp, jf, interpret=True))
    model = np.asarray(jax_rope.apply_elite_rope(jx, jp, jf))
    got = ops.rope_elite(_t(x), _t(pos), _t(freqs)).numpy()
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, model, **TOL)
    assert ops.launches()["rope_elite"] == 0          # the CPU runs the plain math


@pytest.mark.parametrize("pos_dtype", [np.int32, np.int64])
def test_rope_elite_per_lane_positions_and_strided_input(pos_dtype):
    """Positions [B,S] (the paged paths') of either int type, on the
    ``q[..., :2r]`` view of a wider projection, as ``_project_q`` hands it."""
    x, pos, freqs = _rope_case(1, 3, 5, 4, 4, per_lane=True)
    want = np.asarray(jax_rope.apply_elite_rope(jnp.asarray(x), jnp.asarray(pos),
                                                jnp.asarray(freqs)))
    wide = torch.cat([_t(x), torch.ones(3, 5, 4, 24)], dim=-1)
    got = rope.apply_elite_rope(wide[..., :8], _t(pos.astype(pos_dtype)), _t(freqs))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope_matches(per_lane):
    """The full RoPE is rope_elite with chunk_freqs broadcast over heads."""
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 6, 3, 32
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 2048, (B, S) if per_lane else (S,)).astype(np.int32)
    want = np.asarray(jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = rope.apply_rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jc, js = jax_rope.cos_sin(jnp.asarray(pos), jax_rope.chunk_freqs(D))
    tc, ts = rope.cos_sin(_t(pos), rope.chunk_freqs(D, device="cpu"))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


# ---------------------------------------------------------------------------
# elite_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nkv,G,r2,dc,separate", [
    (2, 1, 8, 32, False),      # MHA-like
    (1, 4, 8, 64, False),      # GQA, G = 4
    (2, 4, 16, 32, True),      # GQA with separate c_k / c_v (S-LRD)
])
def test_elite_decode_matches_pallas(nkv, G, r2, dc, separate):
    rng = np.random.default_rng(3)
    S = 24
    lengths = np.asarray([0, 1, 5, S - 3, S, 9, S + 4], np.int32)   # ragged, empty, past S
    B, nh = len(lengths), nkv * G
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q_e, q_lat, k_e, c_k = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc)
    c_v = f(B, S, dc) if separate else c_k
    scale = 0.3
    want = np.asarray(jax_ed.elite_decode(
        *(jnp.asarray(a) for a in (q_e, q_lat, k_e, c_k, c_v, lengths)), G, scale,
        block_s=S, interpret=True))
    tc_k = _t(c_k)
    got = ops.elite_decode(_t(q_e), _t(q_lat), _t(k_e), tc_k,
                           _t(c_v) if separate else tc_k, _t(lengths), G, scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0].abs().max()) == 0.0          # empty lane: exact zeros


# ---------------------------------------------------------------------------
# the model over a contiguous cache
# ---------------------------------------------------------------------------

KINDS = {
    "jlrd": JaxEliteKVConfig(enabled=True, elite_r=4, d_ckv=64),
    "slrd": JaxEliteKVConfig(enabled=True, elite_r=4, lrd="separate", d_ck=32, d_cv=32),
    "gqa": None,
}


def _port_cfg(jcfg):
    """The port's config with the reference config's values."""
    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=jcfg.num_layers, vocab_size=jcfg.vocab_size,
        n_kv_heads=jcfg.n_kv_heads)
    e = jcfg.elitekv
    if not e.enabled:
        return cfg
    return dataclasses.replace(cfg, elitekv=EliteKVConfig(
        enabled=True, elite_r=e.elite_r, d_ckv=e.d_ckv, lrd=e.lrd, d_ck=e.d_ck,
        d_cv=e.d_cv))


def _models(kind, tiny_cfg):
    """(kind, jax cfg, jax params, buffers, port cfg, port params, buffers)
    on the shared tiny config (G = 1)."""
    e = KINDS[kind]
    jcfg = tiny_cfg if e is None else dataclasses.replace(tiny_cfg, elitekv=e)
    jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return kind, jcfg, jp, jb, _port_cfg(jcfg), tp, tb


@pytest.fixture(scope="module", params=list(KINDS))
def models(request, tiny_cfg):
    """EliteKV J-LRD, S-LRD or baseline GQA."""
    return _models(request.param, tiny_cfg)


@pytest.fixture(scope="module", params=["jlrd", "slrd"])
def elite_models(request, tiny_cfg):
    """EliteKV only: the paths the baseline has no counterpart of."""
    return _models(request.param, tiny_cfg)


def _assert_cache(jcache, tcache):
    assert tcache["index"] == int(jcache["index"])
    jleaves = jcache["blocks"]["p0"]
    assert set(jleaves) == set(tcache["blocks"]["p0"])
    for name, arr in jleaves.items():
        np.testing.assert_allclose(tcache["blocks"]["p0"][name].numpy(), np.asarray(arr),
                                   **TOL)


def test_prefill_and_decode_logits_match(models):
    kind, jcfg, jp, jb, tcfg, tp, tb = models
    rng = np.random.default_rng(4)
    B, Sp, n_dec = 2, 7, 3
    toks = rng.integers(0, jcfg.vocab_size, (B, Sp + n_dec)).astype(np.int32)
    jcache = jax_lm.init_cache(jcfg, B, Sp + n_dec, dtype=jnp.float32)
    tcache = lm.init_cache(tcfg, B, Sp + n_dec, device="cpu")
    want, jcache = jax_lm.apply_prefill(jp, jb, jcfg, {"tokens": jnp.asarray(toks[:, :Sp])},
                                        jcache)
    got = lm.apply_prefill(tp, tb, tcfg, _t(toks[:, :Sp]), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache(jcache, tcache)
    for t in range(Sp, Sp + n_dec):           # teacher-forced decode steps
        want, jcache = jax_lm.apply_decode(jp, jb, jcfg,
                                           {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache)
        got = lm.apply_decode(tp, tb, tcfg, _t(toks[:, t:t + 1]), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache(jcache, tcache)


def test_cache_on_equals_cache_off(models):
    """Prefill then decode reproduce the whole-sequence forward's logits."""
    kind, jcfg, jp, jb, tcfg, tp, tb = models
    rng = np.random.default_rng(5)
    B, Sp, n_dec = 2, 5, 4
    toks = _t(rng.integers(0, jcfg.vocab_size, (B, Sp + n_dec)).astype(np.int32))
    full = lm.apply_train(tp, tb, tcfg, toks)
    cache = lm.init_cache(tcfg, B, Sp + n_dec, device="cpu")
    rows = [lm.apply_prefill(tp, tb, tcfg, toks[:, :Sp], cache)]
    rows += [lm.apply_decode(tp, tb, tcfg, toks[:, t:t + 1], cache)
             for t in range(Sp, Sp + n_dec)]
    torch.testing.assert_close(torch.cat(rows, dim=1), full, **TOL)


def test_layer_decode_matches_the_pallas_kernel_path(elite_models):
    """One layer's absorbed decode against the reference's
    ``apply_decode(use_kernel=True)``: the Pallas ``elite_decode`` in
    interpret mode over the same cache."""
    kind, jcfg, jp, jb, tcfg, tp, tb = elite_models
    rng = np.random.default_rng(6)
    B, Sp, max_len = 2, 7, 10      # the logits test's shapes, whose JAX compiles are reused
    toks = rng.integers(0, jcfg.vocab_size, (B, Sp)).astype(np.int32)
    jcache = jax_lm.init_cache(jcfg, B, max_len, dtype=jnp.float32)
    _, jcache = jax_lm.apply_prefill(jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jcache)
    p0 = jax.tree.map(lambda t: t[0], jp["blocks"]["p0"])
    b0 = jax.tree.map(lambda t: t[0], jb["blocks"]["p0"])
    c0 = jax.tree.map(lambda t: t[0], jcache["blocks"]["p0"])
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    hn = jax_rmsnorm(p0["attn_norm"], jnp.asarray(x), jcfg.norm_eps)
    want, _ = jax_ea.apply_decode(p0["attn"], jcfg, b0, hn, Sp, c0, use_kernel=True)
    tcache = {k: _t(np.asarray(v)) for k, v in c0.items()}
    got = elite_attention.apply_decode(tp["layers"][0]["attn"], tcfg, tb["layers"][0],
                                       _t(np.asarray(hn)), Sp, tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name, arr in tcache.items():          # row Sp written in place
        assert arr[:, Sp].abs().max() > 0 and not arr[:, Sp + 1:].any(), name


def test_generate_matches_reference(models):
    kind, jcfg, jp, jb, tcfg, tp, tb = models
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    want, jstats = jax_sl.generate(jp, jb, jcfg, jnp.asarray(prompts), 8)
    got, tstats = serve_loop.generate(tp, tb, tcfg, prompts, 8, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    for field in dataclasses.fields(jstats):
        assert getattr(tstats, field.name) == getattr(jstats, field.name), field.name
    assert len(tstats.step_ms) == 8


def test_contiguous_equals_paged(elite_models):
    kind, jcfg, jp, jb, tcfg, tp, tb = elite_models
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (3, 11))
    got, _ = serve_loop.generate(tp, tb, tcfg, prompts, 7, device="cpu")
    paged, _ = serve_loop.generate_paged(tp, tb, tcfg, prompts, 7, device="cpu")
    np.testing.assert_array_equal(got, paged)


def test_cache_accounting(models):
    """Measured bytes and the cache ratio equal the reference's."""
    kind, jcfg, jp, jb, tcfg, tp, tb = models
    want = jax_measured_cache_bytes(jax_lm.init_cache(jcfg, 3, 10, dtype=jnp.float32), 3, 10)
    assert measured_cache_bytes(lm.init_cache(tcfg, 3, 10, device="cpu"), 3, 10) == want
    jbase = dataclasses.replace(jcfg, elitekv=JaxEliteKVConfig())
    assert cache_ratio(tcfg, _port_cfg(jbase)) == jax_cache_ratio(jcfg, jbase)


def test_baseline_weights_cross_unchanged(tiny_cfg):
    jp, jb = jax_lm.init(jax.random.PRNGKey(1), tiny_cfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), tiny_cfg, device="cpu")
    assert tb == {"layers": [{}] * tiny_cfg.num_layers}
    for i, layer in enumerate(tp["layers"]):
        assert set(layer["attn"]) == {"wq", "wk", "wv", "wo"}
        for name, t in layer["attn"].items():
            want = np.asarray(jp["blocks"]["p0"]["attn"][name][i])
            np.testing.assert_array_equal(t.numpy(), want)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elitekv", [True, False], ids=["elitekv", "baseline"])
def test_serve_batch_mode_on_cpu(capsys, elitekv):
    from repro_torch.launch import serve
    out, stats = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "5"]
                            + (["--elitekv"] if elitekv else []))
    text = capsys.readouterr().out
    ratio = ("128 vs baseline 512 → ratio 0.250" if elitekv
             else "512 vs baseline 512 → ratio 1.000")
    assert f"cache floats/token: {ratio}" in text
    assert "tok/s" in text and "measured attention cache" in text and "req1:" in text
    assert out.shape == (2, 5) and stats.decoded_tokens == 10


def test_stream_without_elitekv_is_refused():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--stream", "--device", "cpu"])
