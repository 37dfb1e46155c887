"""The port's conversion pipeline (RoPElite search, J-LRD / S-LRD, model
surgery, GQA pooling), held to the JAX package's ``core/ropelite.py``,
``core/lrd.py`` and ``core/convert.py``.

Baseline weights are the JAX model's, carried across by
``repro_torch.interop``; calibration tokens come from the reference's
``make_inputs``.  Tolerances:

* search sets: equal, except where a pick is a tie — the two candidates'
  distances, recomputed in float64, within 1e-6 relative; that head is
  then compared no further (``conversion_checks.compare_sets``);
* ``score_distance``: 1e-5 relative (f32 sums of |Δs| over S² pairs);
* J-LRD / S-LRD: factor products A·B within 1e-5 (SVD signs are free, so
  factors are not compared), reconstruction errors within 1e-6 relative,
  the S-LRD split exactly;
* converted logits: 1e-4 absolute, ``tests/test_torch_model.py``'s;
* the exact-rank conversion against the baseline with RoPE restricted to
  the elite sets (``conversion_checks.subset_rope_logits``): 1e-3, the
  reference test's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import make_inputs
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.core import convert as jax_convert
from repro.core import lrd as jax_lrd
from repro.core import ropelite as jax_ropelite
from repro.models import lm as jax_lm

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import convert, lrd, rope, ropelite
from repro_torch.core.cache import PagedKVPool
from repro_torch.models import lm
from conversion_checks import compare_sets, subset_rope_logits

LOGIT_TOL = dict(atol=1e-4, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    """The port's baseline config with the reference config's values."""
    return get_config(jcfg.name).reduced(num_layers=jcfg.num_layers,
                                         vocab_size=jcfg.vocab_size,
                                         n_kv_heads=jcfg.n_kv_heads)


@pytest.fixture(scope="module", params=[1, 2], ids=["G4", "G2"])
def baseline(request, tiny_cfg):
    """(jax cfg, jax params, buffers, port cfg, port params, buffers, tokens)
    of a baseline model: 4 query heads over 4 kv heads (G = 1) or 2 (G = 2)."""
    jcfg = dataclasses.replace(tiny_cfg, n_kv_heads=4 // request.param)
    jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    batch = make_inputs(jcfg, 2, 24, "train", seed=3)
    return jcfg, jp, jb, _port_cfg(jcfg), tp, tb, batch


def _tokens(batch):
    return torch.from_numpy(np.asarray(batch["tokens"]).astype(np.int64))


def _layer_qk(jp, jb, jcfg, batch, layer):
    caps = jax_lm.capture_attn_inputs(jp, jb, jcfg, batch)
    lp = jax.tree.map(lambda t: t[layer], jp["blocks"]["p0"]["attn"])
    return jax_ropelite._layer_qk(lp, jcfg, caps["p0"][layer])


def test_capture_attn_inputs_match(baseline):
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    want = jax_lm.capture_attn_inputs(jp, jb, jcfg, batch)["p0"]
    got = lm.capture_attn_inputs(tp, tb, cfg, _tokens(batch))
    assert list(got) == list(range(jcfg.num_layers))
    for li, x in got.items():
        np.testing.assert_allclose(x.numpy(), np.asarray(want[li]), atol=1e-5, rtol=0)


def test_apply_rope_subset_matches():
    """Per-head masks [H, C] and one shared mask [C], positions [S] and
    [B, S]: the masked-frequency rotation equals the reference's
    ``cos·m + (1 − m)`` bit for bit or within 1e-6."""
    from repro.core import rope as jax_rope
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 9, 3, 16
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    for mask in (rng.random((H, D // 2)) < 0.4, rng.random(D // 2) < 0.5):
        for pos in (np.arange(S, dtype=np.int32) * 7,
                    rng.integers(0, 4000, (B, S)).astype(np.int32)):
            want = np.asarray(jax_rope.apply_rope_subset(
                jnp.asarray(x), jnp.asarray(pos), 5e6, jnp.asarray(mask)))
            got = rope.apply_rope_subset(torch.from_numpy(x), torch.from_numpy(pos), 5e6,
                                         torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
            # masked chunks pass through exactly
            m = np.broadcast_to(mask, (H, D // 2))
            keep = np.repeat(~m, 2, axis=-1)
            assert np.array_equal(got.numpy()[..., keep], x[..., keep])


@pytest.mark.parametrize("method", ["greedy", "uniform", "contribution"])
def test_search_sets_match_reference(baseline, method):
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    want = jax_ropelite.search_model(jp, jb, jcfg, batch, r=4, method=method)
    got = ropelite.search_model(tp, tb, cfg, _tokens(batch), r=4, method=method)
    assert sorted(got) == sorted(want) == list(range(jcfg.num_layers))
    for li in got:
        assert got[li].dtype == torch.int32 and got[li].shape == (cfg.n_kv_heads, 4)
        if method == "greedy":
            q, k = _layer_qk(jp, jb, jcfg, batch, li)
            compare_sets(f"layer {li}", got[li], np.asarray(want[li]),
                         torch.from_numpy(np.asarray(q)), torch.from_numpy(np.asarray(k)),
                         jcfg.rope_theta, jcfg.q_group)
        else:
            np.testing.assert_array_equal(got[li].numpy(), np.asarray(want[li]))


def test_greedy_first_pick_is_bruteforce_argmin(baseline):
    """r = 1 greedy == exhaustive search over single chunks per kv head,
    the distances from the port's ``score_distance``."""
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    q, k = (torch.from_numpy(np.asarray(t)) for t in _layer_qk(jp, jb, jcfg, batch, 0))
    pos = torch.arange(q.shape[1])
    got = ropelite.greedy_search_layer(q, k, pos, cfg.rope_theta, cfg.q_group, r=1)
    C = cfg.head_dim // 2
    dists = torch.stack([
        ropelite.score_distance(q, k, pos, cfg.rope_theta, cfg.q_group,
                                torch.full((cfg.n_kv_heads, 1), c, dtype=torch.int32))
        .reshape(cfg.n_kv_heads, cfg.q_group).sum(-1) for c in range(C)])
    brute = dists.argmin(0)
    for h in range(cfg.n_kv_heads):
        if got[h, 0] != brute[h]:
            a, b = dists[got[h, 0], h], dists[brute[h], h]
            assert abs(float(a - b)) <= 1e-5 * float(max(a, b))


def test_score_distance_matches(baseline):
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    q, k = _layer_qk(jp, jb, jcfg, batch, 1)
    rng = np.random.default_rng(4)
    C = cfg.head_dim // 2
    idx = np.stack([rng.permutation(C)[:4] for _ in range(cfg.n_kv_heads)]).astype(np.int32)
    pos = np.arange(q.shape[1])
    for causal in (True, False):
        want = np.asarray(jax_ropelite.score_distance(
            q, k, jnp.asarray(pos), jcfg.rope_theta, jcfg.q_group, jnp.asarray(idx),
            causal=causal))
        got = ropelite.score_distance(torch.from_numpy(np.asarray(q)),
                                      torch.from_numpy(np.asarray(k)), torch.from_numpy(pos),
                                      cfg.rope_theta, cfg.q_group, torch.from_numpy(idx),
                                      causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(0)
    d, nkv, d_nope, dh = 64, 2, 12, 16
    wk = (rng.standard_normal((d, nkv, d_nope)) / 8).astype(np.float32)
    wv = (rng.standard_normal((d, nkv, dh)) / 8).astype(np.float32)
    return wk, wv


@pytest.mark.parametrize("rank", [4, 16, 56])
def test_jlrd_products_and_error_match(mats, rank):
    wk, wv = mats
    ja, jbk, jbv = (np.asarray(t) for t in jax_lrd.jlrd(jnp.asarray(wk), jnp.asarray(wv),
                                                        rank))
    a, bk, bv = lrd.jlrd(torch.from_numpy(wk), wv, rank)
    assert a.shape == (64, rank) and bk.shape == (rank, 2, 12) and bv.shape == (rank, 2, 16)
    for x, y in ((bk, jbk), (bv, jbv)):
        np.testing.assert_allclose(np.einsum("dc,chn->dhn", a, x),
                                   np.einsum("dc,chn->dhn", ja, y), atol=1e-5, rtol=0)
    W = np.concatenate([wk.reshape(64, -1), wv.reshape(64, -1)], 1)
    B = np.concatenate([bk.reshape(rank, -1), bv.reshape(rank, -1)], 1)
    jB = np.concatenate([jbk.reshape(rank, -1), jbv.reshape(rank, -1)], 1)
    got, want = lrd.reconstruction_error(W, a, B), jax_lrd.reconstruction_error(W, ja, jB)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    A2, B2 = lrd.svd_lowrank(W, rank)
    jA2, jB2 = jax_lrd.svd_lowrank(jnp.asarray(W), rank)
    np.testing.assert_allclose(A2 @ B2, np.asarray(jA2) @ np.asarray(jB2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ranks", [(4, 8), (12, 20), (24, 32)])
def test_slrd_products_match(mats, ranks):
    wk, wv = mats
    want = [np.asarray(t) for t in jax_lrd.slrd(jnp.asarray(wk), jnp.asarray(wv), *ranks)]
    got = lrd.slrd(wk, torch.from_numpy(wv), *ranks)
    for (a, b), (ja, jb_) in (((got[0], got[2]), (want[0], want[2])),
                              ((got[1], got[3]), (want[1], want[3]))):
        assert a.shape == ja.shape and b.shape == jb_.shape
        np.testing.assert_allclose(np.einsum("dc,chn->dhn", a, b),
                                   np.einsum("dc,chn->dhn", ja, jb_), atol=1e-5, rtol=0)


@pytest.mark.parametrize("budget,align", [(24, 1), (40, 4), (9, 1)])
def test_optimal_slrd_split_matches(mats, budget, align):
    wk, wv = mats
    assert lrd.optimal_slrd_split(wk, wv, budget, align) == \
        jax_lrd.optimal_slrd_split(jnp.asarray(wk), jnp.asarray(wv), budget, align)


def _elitekv(lrd_kind, d_ckv=48):
    kw = dict(enabled=True, elite_r=4, d_ckv=d_ckv, lrd=lrd_kind, d_ck=24, d_cv=32)
    return EliteKVConfig(**kw), JaxEliteKV(**kw)


@pytest.mark.parametrize("lrd_kind", ["joint", "separate"])
def test_convert_model_logits_match(baseline, lrd_kind):
    """The reference's elite sets, converted by both packages: the same
    buffers (elite thetas) and weights up to SVD signs, and logits of the
    converted models within 1e-4."""
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    ek, jek = _elitekv(lrd_kind)
    sets = jax_ropelite.search_model(jp, jb, jcfg, batch, r=4)
    ep, eb, ecfg = jax_convert.convert_model(jp, jb, jcfg, sets, jek)
    tsets = {li: torch.from_numpy(np.asarray(s)) for li, s in sets.items()}
    gp, gb, gcfg = convert.convert_model(tp, tb, cfg, tsets, ek)
    assert gcfg.elitekv == ek and not cfg.elitekv.enabled
    for li in range(jcfg.num_layers):
        np.testing.assert_array_equal(gb["layers"][li]["elite_freqs"].numpy(),
                                      np.asarray(eb["blocks"]["p0"]["elite_freqs"][li]))
        for name in ("wq", "wk_e", "wo"):
            np.testing.assert_array_equal(
                gp["layers"][li]["attn"][name].numpy(),
                np.asarray(ep["blocks"]["p0"]["attn"][name][li]))
    want, _ = jax_lm.apply_train(ep, eb, ecfg, batch)
    got = lm.apply_train(gp, gb, gcfg, _tokens(batch))
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)


def test_exact_rank_matches_partial_rope_baseline(baseline):
    """Full-rank J-LRD conversion == the baseline with RoPE restricted to the
    elite sets, through ``apply_train`` and one paged prefill, within 1e-3
    (the only difference EliteKV introduces before truncation)."""
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    tokens = _tokens(batch)
    sets = ropelite.search_model(tp, tb, cfg, tokens, r=4)
    nkv, dh = cfg.n_kv_heads, cfg.head_dim
    full = nkv * (dh - 8) + nkv * dh
    ek = EliteKVConfig(enabled=True, elite_r=4, d_ckv=min(full, cfg.d_model))
    gp, gb, gcfg = convert.convert_model(tp, tb, cfg, sets, ek)
    want = subset_rope_logits(tp, cfg, sets, tokens)
    V = cfg.vocab_size
    got = lm.apply_train(gp, gb, gcfg, tokens)
    np.testing.assert_allclose(got[..., :V].numpy(), want[..., :V].numpy(), atol=1e-3,
                               rtol=1e-3)
    B, S = tokens.shape
    pool = PagedKVPool(gcfg, num_blocks=B * -(-S // 8), block_size=8, device="cpu")
    sms = []
    for b in range(B):
        pool.ensure_capacity(b, S)
        sms.append(pool.prefill_slot_mapping(b, 0, S, S))
    paged = lm.apply_prefill_paged(gp, gb, gcfg, tokens, pool.pages,
                                   torch.from_numpy(np.stack(sms)))
    np.testing.assert_allclose(paged[..., :V].numpy(), want[..., :V].numpy(), atol=1e-3,
                               rtol=1e-3)


def test_elitekv_from_baseline_matches_reference(baseline):
    """Search + convert end to end in both packages: the same sets (up to
    ties) and, where they agree, converted logits within 1e-4."""
    jcfg, jp, jb, cfg, tp, tb, batch = baseline
    ek, jek = _elitekv("joint", d_ckv=32)
    ep, eb, ecfg = jax_convert.elitekv_from_baseline(jp, jb, jcfg, batch, jek)
    gp, gb, gcfg = convert.elitekv_from_baseline(tp, tb, cfg, _tokens(batch), ek)
    same = all(np.array_equal(gb["layers"][li]["elite_freqs"].numpy(),
                              np.asarray(eb["blocks"]["p0"]["elite_freqs"][li]))
               for li in range(jcfg.num_layers))
    assert same, "the searches disagree on these inputs (a tie): pick other inputs"
    want, _ = jax_lm.apply_train(ep, eb, ecfg, batch)
    got = lm.apply_train(gp, gb, gcfg, _tokens(batch))
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)
    # the converted model serves: a paged decode after a paged prefill
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("new_kv", [4, 2, 1])
def test_to_gqa_matches_reference(tiny_cfg, new_kv):
    jcfg = tiny_cfg
    jp, jb = jax_lm.init(jax.random.PRNGKey(1), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    cfg = _port_cfg(jcfg)
    want, wcfg = jax_convert.to_gqa(jp, jcfg, new_kv)
    got, gcfg = convert.to_gqa(tp, cfg, new_kv)
    assert gcfg.n_kv_heads == wcfg.n_kv_heads == new_kv
    for li in range(jcfg.num_layers):
        for name in ("wk", "wv"):
            np.testing.assert_allclose(got["layers"][li]["attn"][name].numpy(),
                                       np.asarray(want["blocks"]["p0"]["attn"][name][li]),
                                       atol=1e-7, rtol=1e-6)
    batch = make_inputs(wcfg, 2, 12, "train", seed=5)
    wl, _ = jax_lm.apply_train(want, jb, wcfg, batch)
    gl = lm.apply_train(got, tb, gcfg, _tokens(batch))
    V = cfg.vocab_size
    np.testing.assert_allclose(gl[..., :V].numpy(), np.asarray(wl)[..., :V], **LOGIT_TOL)
