"""The port's checkpointer, fault runner and restart, held to the JAX
package's contract: every case of ``tests/test_checkpoint_fault.py`` in
the port, restart == uninterrupted bit for bit on the CPU, and a
checkpoint written by the JAX ``train`` resumed by the port, whose losses
equal the JAX run continued within the 20-step curve's 1e-3
(``tests/test_torch_train.py``)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.runtime import train_loop as jax_train

from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.runtime.fault import (FaultTolerantRunner, HeartbeatMonitor,
                                       InjectedFault, StragglerPolicy)
from repro_torch.tree import items

LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def state():
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    opt = {"step": torch.tensor(5, dtype=torch.int32),
           "m": {"w": torch.zeros(2, 3), "b": torch.zeros(3)}}
    return params, opt


def test_roundtrip(tmp_path, state):
    params, opt = state
    ck = Checkpointer(str(tmp_path))
    ck.save(params, opt, {"step": 10, "loss": 1.5})
    p2, o2, extra = ck.restore_latest(device="cpu")
    assert extra["step"] == 10 and extra["loss"] == 1.5
    assert torch.equal(p2["w"], params["w"]) and torch.equal(o2["m"]["w"], opt["m"]["w"])
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 5


def test_uncommitted_checkpoint_ignored(tmp_path, state):
    params, opt = state
    ck = Checkpointer(str(tmp_path))
    ck.save(params, opt, {"step": 1})
    # a crash mid-save at step 2: a directory without _COMMITTED
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    assert ck.committed_steps() == [1]
    _, _, extra = ck.restore_latest(device="cpu")
    assert extra["step"] == 1


def test_keep_last_prunes(tmp_path, state):
    params, opt = state
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(params, opt, {"step": s})
    assert ck.committed_steps() == [3, 4]


def test_restore_keeps_the_structure(tmp_path):
    """The port's trees (dicts, the list of layers, int8 ``{q, s}`` and
    bf16 leaves) come back with their structure, dtypes and bits."""
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=256).with_elitekv(
        elite_r=4, d_ckv=32)
    params, _ = lm.init(cfg, seed=0, device="cpu")
    for md in ("bfloat16", "int8"):
        opt = adamw.init(params, adamw.AdamWConfig(moment_dtype=md))
        ck = Checkpointer(str(tmp_path / md))
        ck.save(params, opt, {"step": 7})
        p2, o2, extra = ck.restore(7, device="cpu")
        assert extra["step"] == 7 and isinstance(p2["layers"], list)
        for (ka, a), (kb, b) in zip(items({"p": params, "o": opt}),
                                    items({"p": p2, "o": o2})):
            assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
        _, onp, _ = ck.restore(7, as_numpy=True)
        m = onp["m"]["layers"]["0"]["attn"]["wq"]
        if md == "bfloat16":               # 2-byte records, as JAX's bf16 reads back
            assert (m.dtype.kind, m.dtype.itemsize) == ("V", 2)
        else:
            assert m["q"].dtype == np.int8
    manifest = json.loads((tmp_path / "int8" / "step_00000007" / "manifest.json")
                          .read_text())
    assert "opt/m/embed/table/q" in manifest["keys"]


# ---------------------------------------------------------------------------

def test_fault_runner_recovers_exact_state():
    """Training interrupted by injected faults ends in the same state as an
    uninterrupted run (checkpoint/restart + deterministic data)."""

    def make(fault_steps):
        ck = {"state": None, "step": 0}
        faults = set(fault_steps)

        def step_fn(s, i):
            return s + (i + 1)

        def save_fn(s, i):
            ck["state"], ck["step"] = s, i

        def restore_fn():
            return None if ck["state"] is None else (ck["state"], ck["step"])

        def hook(i):
            if i in faults:
                faults.remove(i)
                raise InjectedFault(f"boom at {i}")

        return FaultTolerantRunner(step_fn, save_fn, restore_fn, ckpt_every=3,
                                   fault_hook=hook)

    clean, _ = make([]).run(0, 20)
    r = make([5, 11, 17])
    faulty, _ = r.run(0, 20)
    assert faulty == clean
    assert r.restarts == 3
    assert r.steps_replayed > 0


def test_fault_runner_gives_up():
    def hook(i):
        raise InjectedFault("always")

    r = FaultTolerantRunner(lambda s, i: s, lambda s, i: None, lambda: None,
                            ckpt_every=1, max_restarts=3, fault_hook=hook)
    with pytest.raises(InjectedFault):
        r.run(0, 5)
    assert r.restarts == 4


def test_heartbeat_and_straggler():
    t = {"now": 0.0}
    mon = HeartbeatMonitor(hosts=4, deadline_s=10, clock=lambda: t["now"])
    for step in range(8):
        t["now"] += 1.0
        for h in range(4):
            if h == 3 and step >= 4:
                continue  # host 3 dies at step 4
            mon.beat(h, duration_s=2.0 if h != 2 else 4.5)   # host 2 straggles
    t["now"] += 12.0
    assert 3 in mon.dead_hosts()
    mon.evict(3)
    assert 3 not in mon.alive_hosts
    assert StragglerPolicy(threshold=1.5, min_obs=5).stragglers(mon) == [2]


# ---------------------------------------------------------------------------

def _tiny(elitekv=True):
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=128)
    return cfg.with_elitekv(elite_r=4, d_ckv=64) if elitekv else cfg


def _data(cfg, seed=1):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2,
                                    seed=seed), device="cpu")


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_restart_equals_uninterrupted_bitwise(tmp_path, moments):
    """6 steps straight against 4 steps with a checkpoint every 2, then a
    restart to 6: the same losses and weights, bit for bit on the CPU."""
    cfg = _tiny()
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    tc = train_loop.TrainConfig(lr=LR, optimizer=adamw.AdamWConfig(moment_dtype=moments))
    p1, o1, h1 = train_loop.train(params, buffers, cfg, tc, _data(cfg), 6, log_every=1)
    ck = Checkpointer(str(tmp_path / "ck"))
    train_loop.train(params, buffers, cfg, tc, _data(cfg), 4, checkpointer=ck,
                     ckpt_every=2, log_every=1)
    p3, o3, h3 = train_loop.train(params, buffers, cfg, tc, _data(cfg), 6,
                                  checkpointer=ck, ckpt_every=2, log_every=1)
    assert [s for s, _ in h3] == [4, 5]
    assert h3 == h1[4:]
    for (ka, a), (kb, b) in zip(items({"p": p1, "o": o1}), items({"p": p3, "o": o3})):
        assert ka == kb and torch.equal(a, b), ka
    assert not any(p.requires_grad for _, p in items(p3))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX ``train`` runs 4 steps and checkpoints; the port reads that
    checkpoint (numpy trees through ``interop``) and takes steps 4-6, which
    equal the JAX run continued from it, within 1e-3 per step's loss."""
    jcfg = dataclasses.replace(
        jax_get_config("tinyllama_1_1b").reduced(num_layers=2, vocab_size=128),
        elitekv=JaxEliteKV(enabled=True, elite_r=4, d_ckv=64))
    tcfg = _tiny()
    jp, jb = jax_lm.init(jax.random.PRNGKey(2), jcfg)
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2, seed=3)
    jtc = jax_train.TrainConfig(lr=LR)
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    jax_train.train(jp, jb, jcfg, jtc, iter(JaxPipeline(JaxDataConfig(**dc))), 4,
                    checkpointer=jck, ckpt_every=4, log_every=1)
    # the port reads step 4 before the JAX run writes more
    p_np, o_np, extra = Checkpointer(str(tmp_path / "jax")).restore_latest(as_numpy=True)
    assert extra["step"] == 4
    params = interop.params_tree_from_reference(p_np, tcfg, "cpu")
    opt = interop.opt_state_from_reference(o_np, tcfg, "cpu")
    _, buffers = interop.from_reference(jax.tree.map(np.asarray, jp),
                                        jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    assert int(opt["step"]) == 4
    _, _, jh = jax_train.train(jp, jb, jcfg, jtc, iter(JaxPipeline(JaxDataConfig(**dc))), 7,
                               checkpointer=jck, ckpt_every=0, log_every=1)
    data = TokenPipeline(DataConfig(**dc), device="cpu")
    data.state.step += 4
    step = train_loop.make_train_step(tcfg, train_loop.TrainConfig(lr=LR))
    losses = []
    for _ in range(3):
        params, opt, m = step(params, buffers, opt, next(data))
        losses.append(float(m["loss"]))
    assert [s for s, _ in jh] == [4, 5, 6]
    np.testing.assert_allclose(losses, [l for _, l in jh], atol=1e-3, rtol=0)


def test_jax_int8_and_bf16_moments_carry_across():
    """The reference's int8 and bf16 AdamW state through
    ``opt_state_from_reference``: codes, scales and bf16 bits unchanged,
    the stacked layers unstacked."""
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"p0": {"attn": {"wq": (2, 8, 4, 6)}}}, "embed": {"table": (16, 8)}}
    jp = jax.tree.map(lambda s: jax.numpy.asarray(rng.standard_normal(s), "float32"),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    g = jax.tree.map(lambda p: p * 0.01, jp)
    cfg = _tiny()
    for md in ("int8", "bfloat16"):
        acfg = jax_adamw.AdamWConfig(moment_dtype=md)
        _, st, _ = jax_adamw.update(g, jax_adamw.init(jp, acfg), jp, 1e-3, acfg)
        opt = interop.opt_state_from_reference(jax.tree.map(np.asarray, st), cfg, "cpu")
        assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
        want = st["m"]["blocks"]["p0"]["attn"]["wq"]
        got = opt["m"]["layers"][1]["attn"]["wq"]
        if md == "int8":
            assert got["q"].dtype == torch.int8
            np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"])[1])
            np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"])[1])
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want).astype(np.float32)[1])
            assert opt["v"]["embed"]["table"].dtype == torch.bfloat16
