"""The port's Mamba mixer (``repro_torch.models.mamba``) held to the JAX
package's ``models/mamba.py`` on the CPU, on the same weights (the
reference's ``init``, carried as numpy arrays) and numpy inputs from a
seed: the chunked selective scan at chunks of 1, 7 and 128 with a sequence
that is no multiple of the chunk and a given initial state; the in-chunk
Hillis–Steele scan against the step-by-step recurrence; the prefill
output and its final ``(conv, ssm)`` state; decode steps continuing that
state; all within 1e-5 of the largest magnitude compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba as jax_mamba

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import mamba


def _close(got, want, tol=1e-5):
    """|got - want| <= tol · max|want| everywhere."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _layer(arch="falcon_mamba_7b", seed=0, **over):
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jp = jax_mamba.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, interop._whole(jax.tree.map(np.asarray, jp), "cpu")


def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, di) - 2.0)).astype(np.float32)      # softplus: > 0
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    return dt, f(B, S, di), f(B, S, N), f(B, S, N), A, np.ones(di, np.float32), f(B, di, N)


@pytest.mark.parametrize("chunk", [1, 7, 128])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_ssm_scan_matches_reference(chunk, with_h0):
    """S = 45 (no multiple of 7 or 128: the zero-padded tail chunk)."""
    dt, xs, Bm, Cm, A, D, h0 = _scan_inputs(2, 45, 16, 4, seed=chunk)
    h0 = h0 if with_h0 else None
    want_y, want_h = jax_mamba.ssm_scan(*map(jnp.asarray, (dt, xs, Bm, Cm, A, D)),
                                        h0=None if h0 is None else jnp.asarray(h0),
                                        chunk=chunk)
    t = torch.from_numpy
    y, h = mamba.ssm_scan(*map(t, (dt, xs, Bm, Cm, A, D)),
                          h0=None if h0 is None else t(h0), chunk=chunk)
    assert y.shape == (2, 45, 16) and h.shape == (2, 16, 4) and h.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(h.numpy(), want_h)


def test_scan_chunk_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 37, 3, 2), generator=g)
    b = torch.randn((2, 37, 3, 2), generator=g)
    aprod, h = mamba._scan_chunk(a, b)
    run_a, run_h = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for t in range(a.shape[1]):
        run_a, run_h = a[:, t] * run_a, a[:, t] * run_h + b[:, t]
        torch.testing.assert_close(aprod[:, t], run_a, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(h[:, t], run_h, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "jamba_v0_1_52b"])
def test_prefill_state_and_decode_match_reference(arch):
    """apply_full with its state on a 20-token prompt (ssm_chunk 8: three
    chunks, the last padded), then 5 decode steps from that state."""
    jcfg, jp, cfg, tp = _layer(arch, ssm_chunk=8)
    x = np.random.default_rng(4).standard_normal((2, 25, cfg.d_model)).astype(np.float32)
    want, (w_conv, w_ssm) = jax_mamba.apply_full(jp, jcfg, jnp.asarray(x[:, :20]),
                                                 return_state=True)
    got, (conv, ssm) = mamba.apply_full(tp, cfg, torch.from_numpy(x[:, :20]),
                                        return_state=True)
    _close(got.numpy(), want)
    _close(conv.numpy(), w_conv)
    _close(ssm.numpy(), w_ssm)
    _close(mamba.apply_full(tp, cfg, torch.from_numpy(x[:, :20])).numpy(), want)
    jstate = {"conv": w_conv, "ssm": w_ssm}
    state = {"conv": conv, "ssm": ssm}
    for t in range(20, 25):
        want, jstate = jax_mamba.apply_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        got, state = mamba.apply_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), state)
        _close(got.numpy(), want)
        _close(state["ssm"].numpy(), jstate["ssm"])
        _close(state["conv"].numpy(), jstate["conv"])
    # decode continuing the prefill state == the whole sequence prefilled
    whole = mamba.apply_full(tp, cfg, torch.from_numpy(x))
    _close(got.numpy(), whole[:, -1:].numpy())


def test_short_prompt_conv_state_is_zero_padded():
    """A prompt shorter than the conv window: the missing inputs are the
    zeros the causal conv saw, so decode continues the same sequence."""
    _, _, cfg, tp = _layer()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    _, (conv, ssm) = mamba.apply_full(tp, cfg, x[:, :2], return_state=True)
    assert conv.shape == (1, cfg.ssm_conv - 1, cfg.d_inner)
    assert bool((conv[:, 0] == 0).all())
    state = {"conv": conv, "ssm": ssm}
    for t in (2, 3):
        out, state = mamba.apply_decode(tp, cfg, x[:, t:t + 1], state)
    _close(out.numpy(), mamba.apply_full(tp, cfg, x)[:, -1:].numpy())


def test_port_init_matches_reference_shapes_and_ranges():
    _, jp, cfg, _ = _layer()
    tp = mamba.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    dt = torch.nn.functional.softplus(tp["dt_b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]))
