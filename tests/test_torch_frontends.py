"""The vision and audio frontends in the port, held to the JAX package.

InternVL2-2B puts ``n_frontend_tokens`` precomputed patch embeddings before
its text; MusicGen-large takes precomputed frame embeddings, has no token
embedding and always an LM head.  Reduced configs of both (InternVL2 keeps
its two query heads per kv head); weights from the reference's ``lm.init``
through ``repro_torch.interop``; batches from the reference's
``make_inputs(seed)``.  Tolerances, f32 on both sides:

* logits 1e-4 absolute (``tests/test_torch_model.py``'s), pool pages 1e-5;
* the loss 1e-5 relative; gradients per leaf ``1e-4 · max|g_ref| + 1e-7``
  (``tests/test_torch_train.py``'s); one train step as there;
* captured attention inputs 1e-5 absolute; search sets equal; the
  converted factors' products ``a_kv · bk`` / ``a_kv · bv`` 1e-5 (SVD signs
  are free), the permuted ``wq``/``wk_e`` 1e-6, ``elite_freqs`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import make_inputs as jax_make_inputs
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.core import convert as jax_convert
from repro.core import ropelite as jax_ropelite
from repro.core.cache import PagedKVPool as JaxPool
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.runtime import serve_loop as jax_sl
from repro.runtime import train_loop as jax_train

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config, make_inputs
from repro_torch.core import convert, ropelite
from repro_torch.core.cache import PagedKVPool
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import items, map_tree

LOGIT_TOL = dict(atol=1e-4, rtol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STEP_TOL, BIG, LR = 1e-6, 1e-4, 1e-3
FRONTENDS = ("internvl2_2b", "musicgen_large")
FIELDS = ("name", "family", "num_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "d_head", "rope_theta", "norm_eps", "tie_embeddings",
          "padded_vocab", "head_dim", "q_group", "frontend", "n_frontend_tokens")
ELITE = dict(enabled=True, elite_r=4, d_ckv=32, lrd="joint")
B, S = 2, 14                       # S counts every position, patches included


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, elitekv=False, **knobs):
    """(reference cfg, port cfg), reduced; InternVL2 keeps G = 2."""
    kw = dict(n_kv_heads=2) if arch == "internvl2_2b" else {}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**kw), **knobs)
    tcfg = dataclasses.replace(get_config(arch).reduced(**kw), **knobs)
    if elitekv:
        jcfg = dataclasses.replace(jcfg, elitekv=JaxEliteKV(**ELITE))
        tcfg = dataclasses.replace(tcfg, elitekv=EliteKVConfig(**ELITE))
    return jcfg, tcfg


def _models(jcfg, seed=0):
    jp, jb = jax_lm.init(jax.random.PRNGKey(seed), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jp, jb, tp, tb


def _torch(batch):
    """A reference batch → the port's: ids int64, embeddings f32."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())
    return out


def _slice(batch, lo, hi):
    """Positions [lo, hi) of a batch's text (or frames)."""
    key = "frames" if "frames" in batch else "tokens"
    return {key: batch[key][:, lo:hi]}


# -- configs and inputs ---------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_config_fields_and_param_count_match_reference(arch):
    for got, want in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (arch, f)
        assert got.param_count() == want.param_count()
        for ratio in (0.25, 0.5):
            e = convert.pick_dims(got, ratio, align=16)
            je = jax_convert.pick_dims(want, ratio, align=16)
            assert (e.elite_r, e.d_ckv) == (je.elite_r, je.d_ckv)
            assert got.with_elitekv(elite_r=e.elite_r, d_ckv=e.d_ckv).param_count() == \
                want.with_elitekv(elite_r=je.elite_r, d_ckv=je.d_ckv).param_count()
    cfg = get_config(arch)
    if arch == "internvl2_2b":
        assert (cfg.n_frontend_tokens, cfg.reduced().n_frontend_tokens, cfg.padded_vocab,
                cfg.q_group) == (256, 8, 92672, 2)
    else:
        assert (cfg.frontend, cfg.n_frontend_tokens, cfg.padded_vocab, cfg.head_dim) == \
            ("audio", 0, 2048, 64)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FRONTENDS + ("tinyllama_1_1b",))
def test_make_inputs_draws_the_reference_arrays(arch, kind):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = jax_make_inputs(jcfg, 3, 12, kind, seed=5)
    got = make_inputs(tcfg, 3, 12, kind, seed=5)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, np.asarray(want[k]))
    if arch == "internvl2_2b":
        assert got["patch_embeds"].shape == (3, 8, 128) and got["tokens"].shape == (3, 4)


def test_port_init_and_interop_carry_the_frontends_params():
    """An audio model has no ``embed`` and an ``lm_head``; a vision model
    both; the port's init builds the reference's leaves at its shapes."""
    for arch in FRONTENDS:
        jcfg, tcfg = _cfgs(arch, elitekv=True)
        jp, jb, tp, tb = _models(jcfg)
        audio = arch == "musicgen_large"
        assert ("embed" in jp) == ("embed" in tp) == (not audio)
        assert "lm_head" in jp and "lm_head" in tp
        np.testing.assert_array_equal(tp["lm_head"]["w"].numpy(),
                                      np.asarray(jp["lm_head"]["w"]))
        ip, ib = lm.init(tcfg, seed=3, device="cpu")
        shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
        assert shapes(ip) == shapes(tp) and shapes(ib) == shapes(tb)


# -- forwards -----------------------------------------------------------------

@pytest.mark.parametrize("elitekv", [False, True], ids=["baseline", "elitekv"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_apply_train_and_contiguous_cache_match_reference(arch, elitekv):
    """Whole-sequence logits over patches + text (or frames); a contiguous
    prefill of all but the last position, then one decode step, give the
    reference's whole-sequence rows."""
    jcfg, tcfg = _cfgs(arch, elitekv)
    jp, jb, tp, tb = _models(jcfg)
    jbatch = jax_make_inputs(jcfg, B, S, "train", seed=1)
    batch = _torch(jbatch)
    want, _ = jax_lm.apply_train(jp, jb, jcfg, jbatch)
    want = np.asarray(want)
    got = lm.apply_train(tp, tb, tcfg, batch)
    V = tcfg.vocab_size
    assert got.shape == want.shape == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(got[..., :V].numpy(), want[..., :V], **LOGIT_TOL)
    nv = tcfg.n_frontend_tokens
    n_text = S - nv
    pre = dict(_slice(batch, 0, n_text - 1), **({"patch_embeds": batch["patch_embeds"]}
                                                 if nv else {}))
    cache = lm.init_cache(tcfg, B, S, device="cpu")
    logits = lm.apply_prefill(tp, tb, tcfg, pre, cache)
    assert cache["index"] == S - 1
    dec = lm.apply_decode(tp, tb, tcfg, _slice(batch, n_text - 1, n_text), cache)
    np.testing.assert_allclose(logits[..., :V].numpy(), want[:, :S - 1, :V], **LOGIT_TOL)
    np.testing.assert_allclose(dec[..., :V].numpy(), want[:, S - 1:, :V], **LOGIT_TOL)


def _assert_pages(jpool, tpool):
    for name, arr in jpool.pages["p0"].items():
        np.testing.assert_allclose(tpool.pages["p0"][name].numpy(), np.asarray(arr),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_paged_prefill_with_patches_and_decode_match_reference(arch):
    """EliteKV: one paged prefill of patches + text (or frames), the second
    lane padded, then two decode steps, against the reference's paged
    entries on the same pool bookkeeping."""
    jcfg, tcfg = _cfgs(arch, elitekv=True)
    jp, jb, tp, tb = _models(jcfg)
    bs, nb, mb = 4, 24, 6
    jpool, tpool = JaxPool(jcfg, nb, bs), PagedKVPool(tcfg, nb, bs, device="cpu")
    jbatch = jax_make_inputs(jcfg, B, S, "prefill", seed=2)
    n_valid = [S, S - 3]
    for sid, n in enumerate(n_valid):
        jpool.ensure_capacity(sid, n)
        tpool.ensure_capacity(sid, n)
    sm = np.stack([tpool.prefill_slot_mapping(sid, 0, n, S) for sid, n in enumerate(n_valid)])
    want, jpool.pages = jax_lm.apply_prefill_paged(jp, jb, jcfg, jbatch, jpool.pages,
                                                   jnp.asarray(sm))
    got = lm.apply_prefill_paged(tp, tb, tcfg, _torch(jbatch), tpool.pages,
                                 torch.from_numpy(sm))
    V = tcfg.vocab_size
    assert got.shape[1] == S
    np.testing.assert_allclose(got[0, :, :V].numpy(), np.asarray(want)[0, :, :V], **LOGIT_TOL)
    np.testing.assert_allclose(got[1, :S - 3, :V].numpy(), np.asarray(want)[1, :S - 3, :V],
                               **LOGIT_TOL)
    _assert_pages(jpool, tpool)
    lengths = list(n_valid)
    for step in range(2):
        step_in = (jax_make_inputs(jcfg, B, 1, "prefill", seed=10 + step)
                   if arch == "musicgen_large"
                   else {"tokens": jnp.asarray(np.random.default_rng(step).integers(
                       0, jcfg.vocab_size, (B, 1)), jnp.int32)})
        lengths = [n + 1 for n in lengths]
        for sid, n in enumerate(lengths):
            jpool.ensure_capacity(sid, n)
            tpool.ensure_capacity(sid, n)
        sm = tpool.slot_mapping([0, 1], [n - 1 for n in lengths])
        bt = tpool.block_table_array([0, 1], mb)
        ln = np.asarray(lengths, np.int32)
        want, jpool.pages = jax_lm.apply_decode_paged(
            jp, jb, jcfg, step_in, jpool.pages, jnp.asarray(sm), jnp.asarray(bt),
            jnp.asarray(ln), block_size=bs)
        got = lm.apply_decode_paged(tp, tb, tcfg, _torch(step_in), tpool.pages,
                                    torch.from_numpy(sm), bt, ln, bs)
        np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                                   **LOGIT_TOL)
        _assert_pages(jpool, tpool)


# -- training -------------------------------------------------------------------

LOSS_CASES = {
    "vision-elitekv": ("internvl2_2b", True, {}),
    "vision-loss-chunk": ("internvl2_2b", False, dict(loss_chunk=2)),   # skipped: nv > 0
    "audio-elitekv": ("musicgen_large", True, {}),
    "audio-loss-chunk": ("musicgen_large", True, dict(loss_chunk=7)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_gradients_match_reference(case):
    arch, elitekv, knobs = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(arch, elitekv, **knobs)
    jp, jb, tp, tb = _models(jcfg)
    jbatch = jax_make_inputs(jcfg, B, S, "train", seed=3)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jb, jcfg, jbatch), has_aux=True)(jp)
    params = map_tree(lambda p: p.requires_grad_(True), tp)
    loss, aux = lm.loss_fn(params, tb, tcfg, _torch(jbatch))
    names, leaves_ = zip(*items(params))
    grads = torch.autograd.grad(loss, leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]), rtol=1e-5)
    want = dict(items(interop.params_tree_from_reference(
        jax.tree.map(np.asarray, jgrads), tcfg, "cpu")))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (name, err)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_step_with_grad_accum_matches_reference(arch):
    """One AdamW step over 2 microbatches of a batch with patches (or
    frames): loss, grad norm and every weight as the reference's step
    (a weight within 1e-6 where its gradient is >= 1e-4, else 2·lr)."""
    jcfg, tcfg = _cfgs(arch, elitekv=True)
    jp, jb, tp, tb = _models(jcfg, seed=1)
    jbatch = jax_make_inputs(jcfg, 4, S, "train", seed=4)
    jtc = jax_train.TrainConfig(optimizer=jax_adamw.AdamWConfig(), lr=LR, grad_accum=2)
    ttc = train_loop.TrainConfig(optimizer=AdamWConfig(), lr=LR, grad_accum=2)
    jp1, _, jm = jax.jit(jax_train.make_train_step(jcfg, jtc))(
        jp, jb, jax_train.init_opt_state(jp, jtc), jbatch)
    tp1, _, tm = train_loop.make_train_step(tcfg, ttc)(
        tp, tb, train_loop.init_opt_state(tp, ttc), _torch(jbatch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jg = jax.grad(lambda p: jax_lm.loss_fn(p, jb, jcfg, jbatch)[0])(jp)
    to_port = lambda t: dict(items(interop.params_tree_from_reference(
        jax.tree.map(np.asarray, t), tcfg, "cpu")))
    grad, want_p = to_port(jg), to_port(jp1)
    for name, p in items(tp1):
        d = np.abs(p.detach().numpy() - want_p[name].numpy())
        big = np.abs(grad[name].numpy()) >= BIG
        assert d[big].max(initial=0) <= STEP_TOL, name
        assert d.max() <= 2 * LR, name


def test_train_launcher_trains_internvl2_on_text_and_refuses_audio():
    from repro_torch.launch import train
    hist = train.main(["--arch", "internvl2_2b", "--reduced", "--elitekv", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1"])
    assert len(hist) == 2 and all(np.isfinite(l) for _, l in hist)
    with pytest.raises(ValueError, match="no token embedding"):
        train.main(["--arch", "musicgen_large", "--reduced", "--device", "cpu"])


# -- conversion -------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_capture_attn_inputs_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, jb, tp, tb = _models(jcfg)
    jbatch = jax_make_inputs(jcfg, B, S, "prefill", seed=6)
    want = jax_lm.capture_attn_inputs(jp, jb, jcfg, jbatch)["p0"]
    got = lm.capture_attn_inputs(tp, tb, tcfg, _torch(jbatch))
    assert list(got) == list(range(jcfg.num_layers))
    assert got[0].shape == (B, S, tcfg.d_model)
    for li, x in got.items():
        np.testing.assert_allclose(x.numpy(), np.asarray(want[li]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_search_and_conversion_on_a_calibration_batch_match_reference(arch):
    """``elitekv_from_baseline`` on a batch of patches + text (or frames):
    the greedy sets equal, the factors as stated above, and the converted
    model's logits within 1e-4."""
    jcfg, tcfg = _cfgs(arch)
    jp, jb, tp, tb = _models(jcfg)
    jbatch = jax_make_inputs(jcfg, B, 24, "prefill", seed=7)
    batch = _torch(jbatch)
    want_sets = jax_ropelite.search_model(jp, jb, jcfg, jbatch, r=4)
    got_sets = ropelite.search_model(tp, tb, tcfg, batch, r=4)
    assert sorted(got_sets) == sorted(want_sets) == list(range(jcfg.num_layers))
    for li in got_sets:
        np.testing.assert_array_equal(got_sets[li].numpy(), np.asarray(want_sets[li]))
    e = dict(enabled=True, elite_r=4, d_ckv=32)
    jcp, jcb, jccfg = jax_convert.elitekv_from_baseline(jp, jb, jcfg, jbatch, JaxEliteKV(**e))
    cp, cb, ccfg = convert.elitekv_from_baseline(tp, tb, tcfg, batch, EliteKVConfig(**e))
    for li, layer in enumerate(cp["layers"]):
        ja = jax.tree.map(lambda t: np.asarray(t[li]), jcp["blocks"]["p0"]["attn"])
        a = {k: v.numpy() for k, v in layer["attn"].items()}
        for k in ("wq", "wk_e", "wo"):
            np.testing.assert_allclose(a[k], ja[k], atol=1e-6, rtol=0)
        for k in ("bk", "bv"):
            prod = lambda a_, b_: np.einsum("dc,c...->d...", a_.astype(np.float64), b_)
            np.testing.assert_allclose(prod(a["a_kv"], a[k]), prod(ja["a_kv"], ja[k]),
                                       atol=1e-5, rtol=0)
        np.testing.assert_array_equal(cb["layers"][li]["elite_freqs"].numpy(),
                                      np.asarray(jcb["blocks"]["p0"]["elite_freqs"][li]))
    want, _ = jax_lm.apply_train(jcp, jcb, jccfg, jbatch)
    got = lm.apply_train(cp, cb, ccfg, batch)
    V = tcfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "falcon_mamba_7b"])
def test_conversion_of_a_stack_with_mamba_layers_is_refused(arch):
    """Not refused any more: the search and ``convert_model`` key layers by
    absolute index, so one period of Jamba gets a set for its attention
    layer 3 only and Falcon-Mamba none, and the converted model keeps every
    Mamba layer's tensors and serves (``tests/test_torch_moe_mamba_train.py``
    holds both to the reference)."""
    cfg = get_config(arch).reduced(num_layers=get_config(arch).block_period)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 8)))
    sets = ropelite.search_model(params, buffers, cfg, toks, r=2)
    assert list(sets) == list(cfg.attn_layer_indices) == ([3] if cfg.n_attn_layers else [])
    cp, cb, ccfg = convert.convert_model(params, buffers, cfg, sets,
                                         EliteKVConfig(**dict(ELITE, elite_r=2)))
    for i, (layer, base) in enumerate(zip(cp["layers"], params["layers"])):
        assert (layer["attn"] is base["attn"]) == (cfg.layer_kind(i) == "ssm")
        assert bool(cb["layers"][i]) == (cfg.layer_kind(i) == "attn")
    logits = lm.apply_train(cp, cb, ccfg, toks)
    assert logits.shape == (1, 8, cfg.padded_vocab) and bool(torch.isfinite(logits).all())


# -- serving ----------------------------------------------------------------------

def _margin(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def test_internvl2_serves_text_prompts_as_the_reference():
    """Text prompts, no patches: the port's ``generate`` gives the JAX
    ``generate``'s tokens (every greedy pick's top-2 margin over the logit
    tolerance), and the port's paged ``Scheduler`` gives its own
    ``generate``'s streams."""
    jcfg, tcfg = _cfgs("internvl2_2b", elitekv=True)
    jp, jb, tp, tb = _models(jcfg)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    want, _ = jax_sl.generate(jp, jb, jcfg, jnp.asarray(prompts), 8)
    got, _ = serve_loop.generate(tp, tb, tcfg, prompts, 8, device="cpu")
    seqs = np.concatenate([prompts, np.asarray(want)], axis=1).astype(np.int64)
    rows, _ = jax_lm.apply_train(jp, jb, jcfg, {"tokens": jnp.asarray(seqs[:, :-1])})
    rows = np.asarray(rows)[:, prompts.shape[1] - 1:, :jcfg.vocab_size]
    assert min(_margin(r) for r in rows.reshape(-1, rows.shape[-1])) > LOGIT_TOL["atol"]
    np.testing.assert_array_equal(got, np.asarray(want))
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=4, num_blocks=32, max_len=24,
                                      prefill_chunk_tokens=4)
    paged, rep = serve_loop.generate_paged(tp, tb, tcfg, prompts, 8, scfg, device="cpu")
    np.testing.assert_array_equal(paged, got)
    assert rep.completed == 3


def test_audio_model_is_refused_by_the_serving_tiers():
    """MusicGen has no token embedding: ``generate``, the ``Scheduler`` and
    ``launch/serve.py`` refuse it with ``ValueError`` (the reference fails
    with ``KeyError`` on the missing frames); its entry points serve
    frames."""
    _, tcfg = _cfgs("musicgen_large", elitekv=True)
    params, buffers = lm.init(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no token embedding"):
        serve_loop.generate(params, buffers, tcfg, np.zeros((1, 4), np.int32), 2,
                            device="cpu")
    with pytest.raises(ValueError, match="no token embedding"):
        serve_loop.Scheduler(params, buffers, tcfg, serve_loop.SchedulerConfig(),
                             device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="no token embedding"):
        serve.main(["--arch", "musicgen_large", "--reduced", "--elitekv", "--device", "cpu"])
    jcfg, _ = _cfgs("musicgen_large", elitekv=True)
    jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(KeyError):
        jax_sl.generate(jp, jb, jcfg, jnp.zeros((1, 4), jnp.int32), 2)
