"""The port's training, held to the JAX package's.

The same weights (carried by ``repro_torch.interop``) and the same numpy
batches go through the reference's ``lm.loss_fn`` / ``make_train_step`` /
``train`` and the port's.  Tolerances, f32 on both sides, the same math
summed in another order (fused against unfused einsums, JAX's sorted-leaf
order of the global norm against the port's per-layer leaves):

* gradients: per leaf, ``max|Δ| <= 1e-4 · max|g_ref| + 1e-7``;
* one AdamW step from zero moments moves a weight by about ``lr`` times
  the sign of its gradient, so a weight is held to 1e-6 where its
  gradient is at least 1e-4, and to ``2·lr`` elsewhere, where a gradient
  near zero may take either sign;
* moments: f32 to 1e-6; bf16 to 1e-6 or one bf16 step, int8 codes equal or
  one apart, where the two sides round a value on either side of a
  boundary (at most 0.1% of the entries);
* a 20-step loss curve: 1e-3 absolute per step.

The rotation's transpose (the kernel's backward mode) is held to the
plain forward's autograd here; on the card ``tests/test_torch_cuda.py``
holds the kernel to it.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro.runtime import train_loop as jax_train

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import items, map_tree

ROOT = Path(__file__).resolve().parents[1]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STEP_TOL = 1e-6          # a weight whose gradient is >= BIG, and the moments
BIG = 1e-4
FLIP_FRAC = 1e-3         # share of entries allowed one rounding step apart
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(kind: str, **knobs):
    """(reference cfg, port cfg): reduced TinyLlama, 2 layers, 4/2 heads of
    32, vocab 256; EliteKV J-LRD or S-LRD at r = 4, or the baseline; the
    training knobs on both."""
    jcfg = jax_get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=256,
                                                   n_kv_heads=2)
    tcfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=256, n_kv_heads=2)
    if kind != "baseline":
        e = dict(enabled=True, elite_r=4, d_ckv=32, d_ck=16, d_cv=24,
                 lrd="joint" if kind == "jlrd" else "separate")
        jcfg = dataclasses.replace(jcfg, elitekv=JaxEliteKV(**e))
        tcfg = dataclasses.replace(tcfg, elitekv=EliteKVConfig(**e))
    return dataclasses.replace(jcfg, **knobs), dataclasses.replace(tcfg, **knobs)


def _models(jcfg, tcfg, seed=0):
    jp, jb = jax_lm.init(jax.random.PRNGKey(seed), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jp, jb, tp, tb


def _batch(vocab, B=2, S=16, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    if masked:
        mask[0, :3] = 0.0
        mask[-1, -2:] = 0.0
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
          "labels": torch.from_numpy(toks[:, 1:].astype(np.int64)),
          "loss_mask": torch.from_numpy(mask)}
    return jb, tb


def _port_tree(jtree, cfg):
    """A reference params-shaped tree of JAX arrays in the port's layout."""
    return interop.params_tree_from_reference(jax.tree.map(np.asarray, jtree), cfg, "cpu")


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


# -- 1. gradients of every leaf ------------------------------------------------

GRAD_CASES = {
    "jlrd-ce-full": ("jlrd", dict()),
    "jlrd-chunk8-none": ("jlrd", dict(loss_chunk=8, remat_policy="none")),
    "jlrd-dots": ("jlrd", dict(remat_policy="dots")),
    "jlrd-noremat-attnchunk4": ("jlrd", dict(remat=False, attn_chunk_q=4)),
    "slrd-chunk8-full": ("slrd", dict(loss_chunk=8)),
    "baseline-ce-full": ("baseline", dict()),
    "baseline-chunk8-attnchunk8": ("baseline", dict(loss_chunk=8, attn_chunk_q=8)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_of_every_leaf_match_reference(case):
    kind, knobs = GRAD_CASES[case]
    jcfg, tcfg = _cfgs(kind, **knobs)
    jp, jb, tp, tb = _models(jcfg, tcfg)
    jbatch, tbatch = _batch(jcfg.vocab_size)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jb, jcfg, jbatch), has_aux=True)(jp)
    params = map_tree(lambda p: p.requires_grad_(True), tp)
    loss, aux = lm.loss_fn(params, tb, tcfg, tbatch)
    names, leaves_ = zip(*items(params))
    grads = torch.autograd.grad(loss, leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]), rtol=1e-5)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    want = dict(items(_port_tree(jgrads, tcfg)))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (name, err)


def test_remat_policies_give_the_same_gradients():
    """full, dots and none recompute differently but give one gradient
    (the same ops on the same inputs: bitwise on the CPU)."""
    out = {}
    for policy in ("full", "dots", "none"):
        _, tcfg = _cfgs("jlrd", remat_policy=policy)
        _, _, tp, tb = _models(*_cfgs("jlrd"))
        params = map_tree(lambda p: p.requires_grad_(True), tp)
        loss, _ = lm.loss_fn(params, tb, tcfg, _batch(tcfg.vocab_size)[1])
        out[policy] = torch.autograd.grad(loss, [t for _, t in items(params)])
    for policy in ("dots", "none"):
        for a, b in zip(out["full"], out[policy]):
            assert torch.equal(a, b), policy


# -- 2. one train step ---------------------------------------------------------

STEP_CASES = {
    "f32": dict(),
    "bf16": dict(moment_dtype="bfloat16"),
    "int8": dict(moment_dtype="int8"),
    "accum2": dict(grad_accum=2),
    "compress": dict(grad_compression=True),
}


def _flips(got, want, step):
    """Entries not within STEP_TOL, each of which must be one rounding
    ``step`` (an array, or per-entry) apart."""
    d = np.abs(got - want)
    off = d > STEP_TOL
    assert np.all(d[off] <= np.broadcast_to(step, d.shape)[off] * 1.001 + STEP_TOL)
    return int(off.sum())


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_train_step_matches_reference(case):
    kw = STEP_CASES[case]
    opt = {k: v for k, v in kw.items() if k == "moment_dtype"}
    tkw = {k: v for k, v in kw.items() if k != "moment_dtype"}
    jcfg, tcfg = _cfgs("jlrd")
    jp, jb, tp, tb = _models(jcfg, tcfg, seed=1)
    jbatch, tbatch = _batch(jcfg.vocab_size, B=4, seed=2, masked=False)
    jtc = jax_train.TrainConfig(optimizer=jax_adamw.AdamWConfig(**opt), lr=LR, **tkw)
    ttc = train_loop.TrainConfig(optimizer=AdamWConfig(**opt), lr=LR, **tkw)
    jst = jax_train.init_opt_state(jp, jtc)
    jp1, jst1, jm = jax.jit(jax_train.make_train_step(jcfg, jtc))(jp, jb, jst, jbatch)
    tst = train_loop.init_opt_state(tp, ttc)
    tp1, tst1, tm = train_loop.make_train_step(tcfg, ttc)(tp, tb, tst, tbatch)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert int(tst1["step"]) == int(jst1["step"]) == 1
    jg = jax.grad(lambda p: jax_lm.loss_fn(p, jb, jcfg, jbatch)[0])(jp)
    grad = dict(items(_port_tree(jg, tcfg)))
    want_p = dict(items(_port_tree(jp1, tcfg)))
    exempt = {}
    if "grad_compression" in tkw:                  # an int8 code of the grads that
        jerr = dict(items(_port_tree(jst1["err"], tcfg)))   # moved changes the step
        for name, e in items(tst1["err"]):
            exempt[name] = np.abs(_np(e) - jerr[name].numpy()) > STEP_TOL
        n_ex = sum(int(x.sum()) for x in exempt.values())
        assert n_ex <= FLIP_FRAC * sum(x.size for x in exempt.values()), n_ex
    for name, p in items(tp1):
        assert not p.requires_grad
        got, want = _np(p), want_p[name].numpy()
        d = np.abs(got - want)
        big = np.abs(grad[name].numpy()) >= BIG
        ok = exempt.get(name, np.zeros(d.shape, bool))
        assert d[big & ~ok].max(initial=0) <= STEP_TOL, name
        assert d.max() <= 2 * LR, name
    md = opt.get("moment_dtype", "float32")
    flips = total = 0
    for mom in ("m", "v"):
        jmom = jax.tree.map(np.asarray, jst1[mom])
        want = dict(items(interop.params_tree_from_reference(jmom, tcfg, "cpu")))
        for name, got in items(tst1[mom]):
            w = want[name]
            if md == "int8":
                if name.endswith("/s"):
                    np.testing.assert_allclose(_np(got), _np(w), rtol=1e-5, atol=1e-12)
                    continue
                d = np.abs(got.numpy().astype(int) - w.numpy().astype(int))
                assert d.max() <= 1, name
                flips += int((d == 1).sum())
            elif md == "bfloat16":
                g32, w32 = _np(got), _np(w)
                ulp = np.abs(w32) * 2.0 ** -7          # one bf16 step at |w|
                flips += _flips(g32, w32, ulp)
            else:
                d = np.abs(_np(got) - _np(w))
                ok = exempt.get(name, np.zeros(d.shape, bool))
                assert d[~ok].max(initial=0) <= STEP_TOL, (mom, name)
            total += got.numel()
    assert flips <= FLIP_FRAC * max(total, 1), (flips, total)
    if "grad_compression" in tkw:
        jerr = dict(items(_port_tree(jst1["err"], tcfg)))
        for name, e in items(tst1["err"]):
            d = np.abs(_np(e) - jerr[name].numpy())
            # where a code moved, the residual moves by one quantization step
            assert d[~exempt[name]].max(initial=0) <= STEP_TOL, name


# -- 3. a loss curve -----------------------------------------------------------

def test_twenty_step_loss_curve_matches_reference():
    jcfg, tcfg = _cfgs("jlrd")
    jp, jb, tp, tb = _models(jcfg, tcfg, seed=3)
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2, seed=5)
    _, _, jh = jax_train.train(jp, jb, jcfg, jax_train.TrainConfig(lr=LR),
                               iter(JaxPipeline(JaxDataConfig(**dc))), 20, log_every=1)
    _, _, th = train_loop.train(tp, tb, tcfg, train_loop.TrainConfig(lr=LR),
                                TokenPipeline(DataConfig(**dc), device="cpu"), 20,
                                log_every=1)
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(20))
    np.testing.assert_allclose([l for _, l in th], [l for _, l in jh], atol=1e-3, rtol=0)
    assert th[-1][1] < th[0][1]


# -- 4. the optimizer and schedules ---------------------------------------------

SCHEDULES = [("constant", dict(lr=3e-4)), ("cosine", dict(peak=3e-4, warmup=10, total=110)),
             ("cosine", dict(peak=1.0, warmup=7, total=57, floor_frac=0.05)),
             ("wsd", dict(peak=1e-3, warmup=10, stable=20, decay=10))]


@pytest.mark.parametrize("i", range(len(SCHEDULES)), ids=[s[0] for s in SCHEDULES])
def test_schedules_match_reference(i):
    """Equal f32 values, but for the cosine's cos: XLA's f32 cos and
    torch's differ by one ulp on some arguments, which the schedule scales
    by its amplitude."""
    name, kw = SCHEDULES[i]
    jf, tf = jax_schedule.get(name, **kw), schedule.get(name, **kw)
    steps = range(0, 130)
    want = np.array([np.asarray(jf(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([tf(torch.tensor(s, dtype=torch.int32)).numpy() for s in steps])
    assert got.dtype == want.dtype == np.float32
    if name == "cosine":        # a one-ulp cos (≤ 2^-24 absolute) times the amplitude
        np.testing.assert_allclose(got, want, rtol=0, atol=kw["peak"] * 2.0 ** -23)
    else:
        np.testing.assert_array_equal(got, want)


def test_int8_quant_codes_match_reference():
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32) * 5
    x[3] = 0.0                                     # an all-zero row: scale floor
    jq = jax_adamw._quant(jnp.asarray(x))
    tq = adamw._quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    assert tq["q"].dtype == torch.int8
    err = (adamw._dequant(tq) - torch.from_numpy(x)).abs() / tq["s"]
    assert float(err.max()) <= 0.5 + 1e-3          # round-to-nearest bound


def _rosenbrockish(params):
    return torch.sum((params["w"] - 3.0) ** 2) + torch.sum((params["b"] + 1.0) ** 2)


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges(mdtype):
    cfg = AdamWConfig(moment_dtype=mdtype, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
    st = adamw.init(params, cfg)
    loss0 = float(_rosenbrockish(params))
    for _ in range(200):
        leaf = map_tree(lambda p: p.detach().requires_grad_(True), params)
        g = dict(zip(("b", "w"), torch.autograd.grad(_rosenbrockish(leaf),
                                                     [leaf["b"], leaf["w"]])))
        params, st, _ = adamw.update(g, st, params, 0.05, cfg)
    assert float(_rosenbrockish(params)) < loss0 * 0.01, mdtype


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16", "int8"])
def test_adamw_updates_match_reference(mdtype):
    """Five updates with clipping, decay and ``update_chunk`` on random
    grads, against the reference's ``adamw.update``."""
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 3, 8), "b": (8,), "c": (5, 7)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jcfg = jax_adamw.AdamWConfig(moment_dtype=mdtype, update_chunk=2)
    tcfg = AdamWConfig(moment_dtype=mdtype, update_chunk=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jax_adamw.init(jp, jcfg), adamw.init(tp, tcfg)
    for i in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in shapes.items()}
        jp, js, jm = jax_adamw.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                                      jnp.float32(0.01), jcfg)
        tp, ts, tm = adamw.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                                  torch.tensor(0.01), tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-5)
    assert int(ts["step"]) == 5


# -- 5. the token pipeline -----------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic", "file"])
def test_pipeline_batches_match_reference(kind, tmp_path):
    from repro.data.pipeline import write_token_shards as jax_write
    from repro_torch.data.pipeline import write_token_shards
    kw = dict(vocab_size=300, seq_len=12, batch_size=3, seed=4)
    if kind == "file":
        toks = np.random.default_rng(0).integers(0, 10_000, 9000).astype(np.int32)
        jax_write(toks, str(tmp_path / "j"), shard_size=4096)
        write_token_shards(toks, str(tmp_path / "t"), shard_size=4096)
        assert sorted(p.name for p in (tmp_path / "j").iterdir()) == \
            sorted(p.name for p in (tmp_path / "t").iterdir())
    jpipe = JaxPipeline(JaxDataConfig(**kw, kind=kind, path=str(tmp_path / "j")))
    tpipe = TokenPipeline(DataConfig(**kw, kind=kind, path=str(tmp_path / "t")),
                          device="cpu")
    for _ in range(4):
        j, t = next(jpipe), next(tpipe)
        assert t["tokens"].dtype == t["labels"].dtype == torch.int64
        assert t["loss_mask"].dtype == torch.float32
        for k in ("tokens", "labels", "loss_mask"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert tpipe.state.to_dict() == jpipe.state.to_dict()


def test_pipeline_resume_equals_replay():
    cfg = DataConfig(vocab_size=64, seq_len=8, batch_size=2, seed=3)
    p1 = TokenPipeline(cfg, device="cpu")
    seq = [next(p1)["tokens"] for _ in range(5)]
    p2 = TokenPipeline(cfg, device="cpu")
    for _ in range(2):
        next(p2)
    p3 = TokenPipeline(cfg, state=PipelineState(**p2.state.to_dict()), device="cpu")
    for want in seq[2:]:
        assert torch.equal(next(p3)["tokens"], want)
    # the O(1) seek the train loop uses on restart
    p4 = TokenPipeline(cfg, device="cpu")
    p4.state.step += 3
    assert torch.equal(next(p4)["tokens"], seq[3])
    b = next(TokenPipeline(cfg, device="cpu"))
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- 9. the rotation's transpose is its gradient --------------------------------

@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
@pytest.mark.parametrize("rows", [(4, 8, 1), (1, 8, 4)], ids=["elite", "full_rope"])
def test_rotation_transpose_is_its_gradient(rows, per_lane):
    """``rope_elite_qk_ref(transpose=True)`` on the outputs' gradients
    equals autograd through the plain forward, the strided ``q[..., :2r]``
    view included (its gradient lands in the projection's slice)."""
    R, qpr, kpr = rows
    rng = np.random.default_rng(7)
    B, S, r = 2, 9, 4
    proj = torch.from_numpy(rng.standard_normal((B, S, R * qpr, 2 * r + 6)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((B, S, R * kpr, 2 * r)).astype(
        np.float32)).requires_grad_(True)
    pos = torch.from_numpy(rng.integers(0, 900, (B, S) if per_lane else (S,)))
    freqs = torch.from_numpy(rng.uniform(1e-3, 1.0, (R, r)).astype(np.float32))
    q = proj[..., :2 * r]
    qo, ko = ref.rope_elite_qk_ref(q, k, pos, freqs, qpr, kpr)
    gq = torch.from_numpy(rng.standard_normal(qo.shape).astype(np.float32))
    gk = torch.from_numpy(rng.standard_normal(ko.shape).astype(np.float32))
    d_proj, d_k = torch.autograd.grad((qo * gq).sum() + (ko * gk).sum(), (proj, k))
    tq, tk = ref.rope_elite_qk_ref(gq, gk, pos, freqs, qpr, kpr, transpose=True)
    torch.testing.assert_close(d_proj[..., :2 * r], tq, atol=1e-6, rtol=1e-6)
    assert not d_proj[..., 2 * r:].any()
    torch.testing.assert_close(d_k, tk, atol=1e-6, rtol=1e-6)
    # the transpose undoes the rotation (an orthogonal map)
    back, _ = ref.rope_elite_qk_ref(qo.detach(), ko.detach(), pos, freqs, qpr, kpr,
                                    transpose=True)
    torch.testing.assert_close(back, q.detach(), atol=1e-5, rtol=1e-5)


# -- 10. serving after training --------------------------------------------------

def test_serving_weights_that_require_grad_builds_no_graph():
    """Weights taken in the middle of training (leaves that require grad)
    serve the tokens of their detached copy, through the Scheduler and
    ``generate``, and leave no tensor with a grad_fn in the pool."""
    _, tcfg = _cfgs("jlrd")
    params, buffers = lm.init(tcfg, seed=4, device="cpu")
    params, _, _ = train_loop.train(
        params, buffers, tcfg, train_loop.TrainConfig(lr=LR),
        TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, batch_size=2,
                                 seed=6), device="cpu"), 2, log_every=0)
    assert not any(p.requires_grad for _, p in items(params))
    live = map_tree(lambda p: p.detach().clone().requires_grad_(True), params)
    prompts = np.random.default_rng(8).integers(0, tcfg.vocab_size, (3, 12))
    scfg = serve_loop.SchedulerConfig(max_slots=3, block_size=4, num_blocks=32,
                                      max_len=32, prefill_chunk_tokens=8)
    want, _ = serve_loop.generate_paged(params, buffers, tcfg, prompts, 6, scfg, device="cpu")
    sched = serve_loop.Scheduler(live, buffers, tcfg, scfg, device="cpu")
    sched.run([serve_loop.Request(uid=i, prompt=prompts[i], max_new_tokens=6)
               for i in range(3)])
    got = np.stack([r.generated for r in sorted(sched.finished, key=lambda r: r.uid)])
    np.testing.assert_array_equal(got, want)
    for name, t in items(sched.pool.pages):
        assert t.grad_fn is None and not t.requires_grad, name
    g_want, _ = serve_loop.generate(params, buffers, tcfg, prompts, 6, device="cpu")
    g_got, _ = serve_loop.generate(live, buffers, tcfg, prompts, 6, device="cpu")
    np.testing.assert_array_equal(g_got, g_want)


# -- 11. the entry points ----------------------------------------------------------

def test_launch_train_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--reduced", "--elitekv", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--schedule", "cosine"]
    hist = train.main(argv)
    out = capsys.readouterr().out.splitlines()
    steps = [l for l in out if l.startswith("step ")]
    assert [l.split()[1] for l in steps] == ["0", "1", "2"]
    assert hist[-1][0] == 2 and any("final loss" in l for l in out)
    assert "elitekv=True" in out[0]
    # a restart to 4 steps resumes from the committed step 2: step 2 again
    train.main(argv[:5] + ["4"] + argv[6:])
    again = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split()[1] for l in again] == ["2", "3"]
    assert again[0].split()[:4] == steps[2].split()[:4]      # the same loss


@pytest.mark.parametrize("name,argv,want", [
    ("torch_quickstart", [], "OK"),
    ("torch_convert_and_uptrain", ["--pretrain-steps", "4", "--uptrain-steps", "2",
                                   "--layers", "2", "--dim", "64"], "paper Fig. 6"),
])
def test_training_examples_run_on_cpu(name, argv, want, capsys):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", *argv])
    assert want in capsys.readouterr().out
