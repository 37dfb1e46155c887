"""Training and conversion of MoE, Mamba and hybrid stacks in the port,
held to the JAX package on the CPU (weights made by the reference's
``init`` and carried by ``repro_torch.interop``; inputs numpy, seeded).
Reduced widths; the scan runs ``ssm_chunk=4`` over 16 positions, so every
Mamba layer crosses four chunks.

* ``lm.loss_fn``: loss, ``ce`` and ``aux`` and the gradient of every leaf
  under ``moe_impl`` "ragged" and "dense" against ``jax.value_and_grad``
  of the reference's ``loss_fn`` (1e-4 of a leaf's largest + 1e-7, PR
  22's tolerance), for Qwen3-MoE and one period of Jamba (EliteKV),
  Falcon-Mamba and Arctic (``dense_residual``, baseline);
* one ``make_train_step`` with ``TrainConfig.moe_impl``, f32 and int8
  moments: Qwen3-MoE (f32) against the reference's jitted step, the
  others against the reference's jitted ``adamw.update`` of the
  reference's gradients (the reference step's two parts; its whole jitted
  Jamba step costs ~30 s to compile here).  A weight whose gradient is at least 1e-4 is
  held to 1e-6, any other to ``2·lr`` (a first Adam step moves a weight by
  about ``lr`` times its gradient's sign); int8 codes may be one apart;
* the scan's per-chunk recompute: gradients bitwise equal to
  ``ssm_unroll=True``'s under every remat policy (nested in the layer's
  checkpoint), and fewer bytes kept for the backward, counted by a
  ``saved_tensors_hooks`` pack hook over distinct storages;
* conversion: ``capture_attn_inputs`` keyed by absolute layer index
  (reference ``p{pos}`` entry ``s`` is layer ``s·P + pos``; two periods of
  Jamba put attention at 3 and 11) within 1e-5 of the largest magnitude
  (layer 11's input, after ten Mamba and five MoE layers of f32, differs
  by up to 1.1e-5 on rows of ~4); ``search_model`` sets equal
  to the reference's for greedy, uniform and contribution; the converted
  model's logits within 1e-4, its cache bytes per token and parameter
  count equal; Falcon-Mamba converts to itself with ``{}``;
* ``generate`` and the ``Scheduler`` with ``moe_impl="dense"`` give
  ``"ragged"``'s tokens, a token excused only at a near-tie (top-2 margin
  under 1e-4) or a router gap under ``ROUTE_GAP``; "ep" is refused;
* ``launch/train.py --moe-impl dense`` trains a reduced Qwen3-MoE.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.core import convert as jax_convert
from repro.core import ropelite as jax_ropelite
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.runtime import train_loop as jax_train

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import convert, ropelite
from repro_torch.launch import serve, train
from repro_torch.models import lm, mamba
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import items, map_tree
from routing_margins import ROUTE_GAP, min_gap_per_token, recorded_gaps

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STEP_TOL, BIG, LR = 1e-6, 1e-4, 1e-3
FLIP_FRAC = 1e-3         # share of int8 moment codes allowed one apart
LOGIT_TOL = dict(atol=1e-4, rtol=0)
NEAR_TIE = 1e-4
S = 16
ONE_PERIOD = dict(num_layers=8)       # Jamba: attention at 3, MoE at odd positions
# (arch, reduced overrides, EliteKV attention)
ARCHS = {"qwen3": ("qwen3_moe_235b", {}, True),
         "jamba": ("jamba_v0_1_52b", ONE_PERIOD, True),
         "falcon": ("falcon_mamba_7b", {}, False),
         "arctic": ("arctic_480b", {}, False)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _cfgs(arch, elitekv, **over):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**over), ssm_chunk=4)
    cfg = dataclasses.replace(get_config(arch).reduced(**over), ssm_chunk=4)
    if elitekv:
        jcfg, cfg = jcfg.with_elitekv(), cfg.with_elitekv()
    return jcfg, cfg


def _models(arch, elitekv, seed=0, **over):
    jcfg, cfg = _cfgs(arch, elitekv, **over)
    jp, jb = jax_lm.init(jax.random.PRNGKey(seed), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jcfg, jp, jb, cfg, tp, tb


def _batch(vocab, B=2, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in jb.items()}
    return jb, tb


def _port_tree(jtree, cfg):
    return interop.params_tree_from_reference(jax.tree.map(np.asarray, jtree), cfg, "cpu")


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _grads(params, buffers, cfg, batch, moe_impl, **kw):
    """(loss, aux dict, {leaf name: gradient}) of the port's ``loss_fn``."""
    params = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = lm.loss_fn(params, buffers, cfg, batch, moe_impl=moe_impl, **kw)
    names, leaves = zip(*items(params))
    return loss.detach(), aux, dict(zip(names, torch.autograd.grad(loss, leaves)))


@pytest.fixture(scope="module")
def reference():
    """Per arch, built once: the models, a batch and the reference's loss,
    metrics and gradients (``jax.value_and_grad`` of ``loss_fn``,
    ragged)."""
    cache = {}

    def get(key):
        if key not in cache:
            arch, over, elitekv = ARCHS[key]
            jcfg, jp, jb, cfg, tp, tb = _models(arch, elitekv, **over)
            jbatch, tbatch = _batch(cfg.vocab_size)
            (jloss, jaux), jg = jax.jit(jax.value_and_grad(
                lambda p: jax_lm.loss_fn(p, jb, jcfg, jbatch, moe_impl="ragged"),
                has_aux=True))(jp)
            cache[key] = dict(jcfg=jcfg, jp=jp, jb=jb, cfg=cfg, tp=tp, tb=tb,
                              jbatch=jbatch, tbatch=tbatch, loss=float(jloss),
                              ce=float(jaux["ce"]), aux=float(jaux["aux"]),
                              grads=dict(items(_port_tree(jg, cfg))))
        return cache[key]
    return get


# -- 1. loss and gradients ---------------------------------------------------------

GRAD_CASES = [(k, impl) for k in ARCHS for impl in ("ragged", "dense")
              if not (k == "falcon" and impl == "dense")]


@pytest.mark.parametrize("key,impl", GRAD_CASES, ids=[f"{k}-{i}" for k, i in GRAD_CASES])
def test_loss_and_gradients_match_reference(reference, key, impl):
    """Loss, ce and the balance loss, and every leaf's gradient, through
    ``moe_impl`` against the reference's ``loss_fn`` and its gradient."""
    r = reference(key)
    with recorded_gaps([]) as calls:
        loss, aux, grads = _grads(r["tp"], r["tb"], r["cfg"], r["tbatch"], impl)
    assert all(float(c.min()) > ROUTE_GAP for c in calls)   # no flip to excuse
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), r["ce"], rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"]), r["aux"], rtol=1e-6)
    assert (r["aux"] > 0) == (r["cfg"].n_experts > 0)
    assert sorted(grads) == sorted(r["grads"])
    for name, g in grads.items():
        w = r["grads"][name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (name, err)
    if r["cfg"].n_experts:                  # every expert weight got its gradient
        assert any(float(g.abs().max()) > 0 for n, g in grads.items() if "w_gate" in n)


# -- 2. one train step -----------------------------------------------------------

def _check_step(tp1, tst1, want_p, want_st, grad, md, cfg):
    for name, p in items(tp1):
        assert not p.requires_grad
        d = np.abs(_np(p) - want_p[name].numpy())
        big = np.abs(grad[name].numpy()) >= BIG
        assert d[big].max(initial=0) <= STEP_TOL, name
        assert d.max() <= 2 * LR, name
    flips = total = 0
    for mom in ("m", "v"):
        want = dict(items(_port_tree(want_st[mom], cfg)))
        for name, got in items(tst1[mom]):
            w = want[name]
            if md == "int8" and not name.endswith("/s"):
                d = np.abs(got.numpy().astype(int) - w.numpy().astype(int))
                assert d.max() <= 1, name
                flips += int((d == 1).sum())
            else:
                scale = float(np.abs(_np(w)).max()) if md == "int8" else 1.0
                assert np.abs(_np(got) - _np(w)).max() <= STEP_TOL * max(scale, 1.0), \
                    (mom, name)
            total += got.numel()
    assert flips <= FLIP_FRAC * total, (flips, total)


STEP_CASES = [("qwen3", "float32", "ragged"), ("qwen3", "int8", "dense"),
              ("jamba", "float32", "ragged"), ("falcon", "int8", "ragged")]


@pytest.mark.parametrize("key,md,impl", STEP_CASES, ids=["-".join(c) for c in STEP_CASES])
def test_one_train_step_matches_reference(reference, key, md, impl):
    r = reference(key)
    jcfg, cfg = r["jcfg"], r["cfg"]
    opt = dict(moment_dtype=md)
    ttc = train_loop.TrainConfig(optimizer=AdamWConfig(**opt), lr=LR, moe_impl=impl)
    tst = train_loop.init_opt_state(r["tp"], ttc)
    tp1, tst1, tm = train_loop.make_train_step(cfg, ttc)(r["tp"], r["tb"], tst, r["tbatch"])
    jtc = jax_train.TrainConfig(optimizer=jax_adamw.AdamWConfig(**opt), lr=LR,
                                moe_impl=impl)
    jst = jax_train.init_opt_state(r["jp"], jtc)
    if (key, md) == ("qwen3", "float32"):
        jp1, jst1, jm = jax.jit(jax_train.make_train_step(jcfg, jtc))(
            r["jp"], r["jb"], jst, r["jbatch"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    else:   # the reference step's update, on the reference's gradients
        jg = jax.tree.map(jnp.asarray, _reference_tree(r["grads"], r["jp"], cfg))
        jp1, jst1, jm = jax.jit(functools.partial(jax_adamw.update, cfg=jtc.optimizer))(
            jg, jst, r["jp"], jnp.asarray(LR, jnp.float32))
        np.testing.assert_allclose(float(tm["loss"]), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(tst1["step"]) == int(jst1["step"]) == 1
    _check_step(tp1, tst1, dict(items(_port_tree(jp1, cfg))), jst1, r["grads"], md, cfg)


def _reference_tree(flat, jtree, cfg):
    """Port-layout leaves ``flat`` {name: tensor} back into the reference's
    stacked ``blocks/p{pos}`` structure of ``jtree``."""
    P = cfg.block_period

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if path[0] != "blocks":
            return flat["/".join(path)].numpy()
        pos, rest = int(path[1][1:]), "/".join(path[2:])
        return np.stack([flat[f"layers/{s * P + pos}/{rest}"].numpy()
                         for s in range(node.shape[0])])
    return build(jtree, ())


# -- 3. the scan's per-chunk recompute --------------------------------------------

def _saved_bytes(fn):
    """(fn(), bytes of the distinct storages autograd kept for the backward
    in it, as a pack hook outside every checkpoint sees them)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def test_scan_recompute_keeps_fewer_bytes_and_the_same_bits():
    """``ssm_scan`` over 4 chunks under grad: the outputs and gradients are
    the unrolled scan's bit for bit (and the no-grad forward's), and the
    bytes kept for the backward fall from every chunk's expansions to the
    chunks' inputs and carries."""
    g = torch.Generator().manual_seed(0)
    B, di, N = 2, 32, 4
    args = [torch.rand(B, S, di, generator=g), torch.randn(B, S, di, generator=g),
            torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)]
    A, D = -torch.rand(di, N, generator=g), torch.randn(di, generator=g)
    with torch.no_grad():
        y0, h0 = mamba.ssm_scan(*args, A, D, chunk=4)
    out = {}
    for unroll in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in args]
        (y, h), nbytes = _saved_bytes(lambda: mamba.ssm_scan(*leaves, A, D, chunk=4,
                                                             unroll=unroll))
        assert torch.equal(y, y0) and torch.equal(h, h0), unroll
        gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
        out[unroll] = nbytes, torch.autograd.grad((y * gy).sum() + h.sum(), leaves)
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    # unrolled: several [B, chunk, di, N] f32 expansions per chunk (dA, dBx,
    # each round's pairs); recomputed: the inputs and the 4 chunks' carries
    expansion = B * 4 * di * N * 4
    assert out[True][0] >= 4 * 4 * expansion, out
    carries = 4 * B * di * N * 4
    assert out[False][0] <= sum(a.nbytes for a in args + [A, D]) + carries, out


@pytest.mark.parametrize("key,policy", [("falcon", "full"), ("falcon", "dots"),
                                        ("falcon", "none"), ("jamba", "full")])
def test_scan_recompute_gradients_equal_unrolled(key, policy):
    """``loss_fn`` gradients with the per-chunk checkpoint (nested in the
    layer's checkpoint under the "full" and "dots" policies) equal
    ``ssm_unroll=True``'s bit for bit; without the layer remat the scan's
    recompute keeps fewer bytes."""
    arch, over, elitekv = ARCHS[key]
    _, cfg = _cfgs(arch, elitekv, **over)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg.vocab_size, seed=1)
    out = {}
    for unroll in (False, True):
        c = dataclasses.replace(cfg, ssm_unroll=unroll, remat_policy=policy)
        out[unroll], nbytes = _saved_bytes(lambda: _grads(params, buffers, c, batch,
                                                          "ragged"))
        out[unroll] = out[unroll] + (nbytes,)
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][2].items():
        assert torch.equal(g, out[True][2][name]), name
    if policy == "none":
        assert out[False][3] < out[True][3] / 2, (out[False][3], out[True][3])
    else:                   # the layer checkpoint keeps only each layer's input
        assert out[False][3] == out[True][3]


# -- 4. conversion ---------------------------------------------------------------

# (arch, overrides): two periods of Jamba (attention at 3 and 11), Qwen3-MoE
# (all attention, MoE FFNs), Falcon-Mamba (no attention)
CONV = {"jamba": ("jamba_v0_1_52b", {}), "qwen3": ("qwen3_moe_235b", {}),
        "falcon": ("falcon_mamba_7b", {})}


@pytest.fixture(scope="module")
def baselines():
    cache = {}

    def get(key):
        if key not in cache:
            arch, over = CONV[key]
            jcfg, jp, jb, cfg, tp, tb = _models(arch, False, seed=2, **over)
            toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S))
            cache[key] = (jcfg, jp, jb, cfg, tp, tb, {"tokens": jnp.asarray(toks)},
                          torch.from_numpy(toks.astype(np.int64)), {})
        return cache[key]
    return get


@pytest.mark.parametrize("key", list(CONV))
def test_capture_attn_inputs_keyed_by_absolute_layer(baselines, key):
    jcfg, jp, jb, cfg, tp, tb, jbatch, toks, _ = baselines(key)
    want = jax_lm.capture_attn_inputs(jp, jb, jcfg, jbatch, moe_impl="dense")
    got = lm.capture_attn_inputs(tp, tb, cfg, toks, moe_impl="dense")
    P = cfg.block_period
    unstacked = {s * P + int(p[1:]): np.asarray(x[s]) for p, x in want.items()
                 for s in range(x.shape[0])}
    assert list(got) == sorted(unstacked) == list(cfg.attn_layer_indices)
    if key == "jamba":
        assert list(got) == [3, 11]
    for li, x in got.items():
        tol = 1e-5 * max(1.0, float(np.abs(unstacked[li]).max()))
        np.testing.assert_allclose(x.numpy(), unstacked[li], atol=tol, rtol=0)
    ragged = lm.capture_attn_inputs(tp, tb, cfg, toks)
    assert list(ragged) == list(got)
    for li, x in ragged.items():
        tol = 1e-5 * max(1.0, float(got[li].abs().max()))
        np.testing.assert_allclose(x.numpy(), got[li].numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("key,method", [(k, m) for k in ("jamba", "qwen3")
                                        for m in ("greedy", "uniform", "contribution")])
def test_search_model_sets_match_reference(baselines, key, method):
    jcfg, jp, jb, cfg, tp, tb, jbatch, toks, sets = baselines(key)
    want = jax_ropelite.search_model(jp, jb, jcfg, jbatch, r=4, method=method)
    sets[method] = want
    got = ropelite.search_model(tp, tb, cfg, toks, r=4, method=method)
    assert list(got) == sorted(want) == list(cfg.attn_layer_indices)
    for li, s in got.items():
        np.testing.assert_array_equal(s.numpy(), np.asarray(want[li]))


@pytest.mark.parametrize("key", ["jamba", "qwen3"])
def test_converted_hybrid_and_moe_match_reference(baselines, key):
    """``convert_model`` on the reference's greedy sets: converted
    attention layers, Mamba layers and MoE FFNs passed through (the
    baseline's tensors), logits within 1e-4, and the converted config's
    cache bytes per token and parameter count equal the reference's;
    ``elitekv_from_baseline`` gives the same model."""
    jcfg, jp, jb, cfg, tp, tb, jbatch, toks, found = baselines(key)
    e = dict(enabled=True, elite_r=4, d_ckv=32)
    sets = found.get("greedy") or jax_ropelite.search_model(jp, jb, jcfg, jbatch, r=4)
    jcp, jcb, jccfg = jax_convert.convert_model(jp, jb, jcfg, sets, JaxEliteKV(**e))
    cp, cb, ccfg = convert.elitekv_from_baseline(tp, tb, cfg, toks, EliteKVConfig(**e))
    assert ccfg.kv_cache_bytes_per_token() == jccfg.kv_cache_bytes_per_token()
    assert ccfg.param_count() == jccfg.param_count()
    for li, (layer, base) in enumerate(zip(cp["layers"], tp["layers"])):
        if cfg.layer_kind(li) == "attn":
            assert set(layer["attn"]) == {"wq", "wk_e", "wo", "a_kv", "bk", "bv"}
            np.testing.assert_array_equal(
                cb["layers"][li]["elite_freqs"].numpy(),
                np.asarray(jcb["blocks"][f"p{li % cfg.block_period}"]["elite_freqs"]
                           [li // cfg.block_period]))
        else:
            assert layer["attn"] is base["attn"] and cb["layers"][li] == {}
        assert layer.get("ffn") is base.get("ffn")
    want, _ = jax_lm.apply_train(jcp, jcb, jccfg, jbatch)
    got = lm.apply_train(cp, cb, ccfg, toks)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)


def test_falcon_mamba_converts_to_itself(baselines):
    jcfg, jp, jb, cfg, tp, tb, jbatch, toks, _ = baselines("falcon")
    for method in ("greedy", "uniform", "contribution"):
        assert ropelite.search_model(tp, tb, cfg, toks, r=4, method=method) == {}
    assert jax_ropelite.search_model(jp, jb, jcfg, jbatch, r=4) == {}
    cp, cb, ccfg = convert.elitekv_from_baseline(tp, tb, cfg, toks,
                                                 EliteKVConfig(enabled=True, elite_r=4,
                                                               d_ckv=32))
    assert all(a is b for a, b in zip(cp["layers"], tp["layers"]))
    assert ccfg.kv_cache_bytes_per_token() == 0 and ccfg.param_count() == cfg.param_count()
    assert torch.equal(lm.apply_train(cp, cb, ccfg, toks), lm.apply_train(tp, tb, cfg, toks))


# -- 5. serving and the launcher ----------------------------------------------------

def _excused(tp, tb, cfg, context) -> str:
    """Why ``context``'s next token may go either way ("near-tie" or
    "routing"), else ''."""
    with recorded_gaps([]) as calls:
        logits = lm.apply_train(tp, tb, cfg, torch.from_numpy(
            np.asarray(context, np.int64)[None]), moe_impl="dense")
    top = torch.topk(logits[0, -1].double(), 2).values
    if float(top[0] - top[1]) < NEAR_TIE:
        return "near-tie"
    if calls and float(min_gap_per_token(calls, len(context)).min()) < ROUTE_GAP:
        return "routing"
    return ""


def _same_streams(label, tp, tb, cfg, prompts, got, want) -> int:
    excused = 0
    for uid, w in want.items():
        g = got[uid]
        diff = [t for t, (a, b) in enumerate(zip(g, w)) if a != b]
        if not diff:
            assert len(g) == len(w), (label, uid)
            continue
        t = diff[0]
        why = _excused(tp, tb, cfg, list(prompts[uid]) + list(w[:t]))
        assert why, f"{label} request {uid}: token {t} is {g[t]} against {w[t]}"
        excused += 1
    print(f"{label}: {len(want)} streams equal, {excused} excused (near-tie or routing)")
    return excused


@pytest.mark.parametrize("arch,over", [("qwen3_moe_235b", {}),
                                       ("jamba_v0_1_52b", ONE_PERIOD)],
                         ids=["qwen3", "jamba"])
def test_generate_dense_equals_ragged(arch, over):
    _, cfg = _cfgs(arch, True, **over)
    params, buffers = lm.init(cfg, seed=3, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 10))
    out = {impl: serve_loop.generate(params, buffers, cfg, prompts, 8, device="cpu",
                                     moe_impl=impl)[0] for impl in ("dense", "ragged")}
    _same_streams(f"generate {arch}", params, buffers, cfg, prompts,
                  {b: list(out["ragged"][b]) for b in range(3)},
                  {b: list(out["dense"][b]) for b in range(3)})
    with pytest.raises(ValueError, match="item 15"):
        serve_loop.generate(params, buffers, cfg, prompts, 2, device="cpu", moe_impl="ep")


def test_scheduler_dense_equals_ragged():
    _, cfg = _cfgs("qwen3_moe_235b", True)
    params, buffers = lm.init(cfg, seed=5, device="cpu")
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=4, num_blocks=64, max_len=32,
                                      prefill_bucket=4, prefill_chunk_tokens=4)
    rng = np.random.default_rng(6)
    prompts = {i: rng.integers(0, cfg.vocab_size, int(rng.integers(5, 14))).astype(np.int32)
               for i in range(3)}
    streams = {}
    for impl in ("dense", "ragged"):
        sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu", moe_impl=impl)
        sched.run([serve_loop.Request(uid=i, prompt=p, max_new_tokens=6, arrival=i * 0.5)
                   for i, p in prompts.items()])
        streams[impl] = {r.uid: r.generated for r in sched.finished}
    _same_streams("Scheduler qwen3", params, buffers, cfg, prompts, streams["ragged"],
                  streams["dense"])
    with pytest.raises(ValueError, match="item 15"):
        serve_loop.Scheduler(params, buffers, cfg, scfg, device="cpu", moe_impl="ep")


def test_launchers_take_moe_impl(capsys):
    history = train.main(["--arch", "qwen3_moe_235b", "--reduced", "--device", "cpu",
                          "--moe-impl", "dense", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--log-every", "1"])
    assert [s for s, _ in history] == [0, 1] and all(np.isfinite(l) for _, l in history)
    serve.main(["--arch", "qwen3_moe_235b", "--reduced", "--elitekv", "--device", "cpu",
                "--moe-impl", "dense", "--batch", "2", "--prompt-len", "6",
                "--new-tokens", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out
    for main in (train.main, serve.main):
        with pytest.raises(ValueError, match="item 15"):
            main(["--arch", "qwen3_moe_235b", "--reduced", "--device", "cpu",
                  "--moe-impl", "ep"])
