"""The port's MoE FFN (``repro_torch.models.moe``) held to the JAX package's
``models/moe.py`` on the CPU, on the same weights (made by the reference's
``init``, carried as numpy arrays) and the same inputs (numpy, seeded):
the router's gates, expert indices and balance loss; the dense oracle and
the ragged dispatch, with and without Arctic's dense residual, within 1e-5
of the output's largest magnitude (the reference's init makes expert
outputs of tens, and f32 rounds them at ~1e-6);
the stable top-k's tie order; the group-size read counted once per
ragged call; ``impl="ep"`` refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import moe
from routing_margins import ROUTE_GAP, recorded_gaps, route_gaps

TOL = dict(atol=1e-5, rtol=0)


def _close(got, want, tol=1e-5):
    """|got - want| <= tol · max|want| everywhere."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _moe(arch, seed=0, **over):
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jp = jax_moe.init(jax.random.PRNGKey(seed), jcfg)
    tp = interop._whole(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b"])
def test_route_matches_reference(arch):
    jcfg, jp, cfg, tp = _moe(arch)
    x = _x((24, cfg.d_model))
    jg, ji, ja = jax_moe._route(jp, jcfg, jnp.asarray(x))
    g, i, a = moe._route(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, atol=1e-6)
    assert all(len(set(row)) == cfg.top_k for row in i.tolist())
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    gaps = route_gaps(probs, cfg.top_k)
    assert float(gaps.min()) > ROUTE_GAP          # no index may flip on these inputs
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)


def test_route_ties_go_to_the_lower_index():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``."""
    jcfg, jp, cfg, tp = _moe("qwen3_moe_235b")
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 3] = router[:, 1] = 0.5                # experts 1 and 3 tie above the rest
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(_x((5, cfg.d_model)))
    _, ji, _ = jax_moe._route(jp, jcfg, jnp.asarray(x))
    g, i, _ = moe._route(tp, cfg, torch.from_numpy(x))
    assert i.tolist() == [[1, 3]] * 5 == np.asarray(ji).tolist()
    np.testing.assert_allclose(g.numpy(), 0.5, atol=1e-7)
    router[:] = 0.0                                  # every expert ties
    _, i, _ = moe._route(dict(tp, router=torch.from_numpy(router)), cfg, torch.from_numpy(x))
    assert i.tolist() == [[0, 1]] * 5


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b"])
def test_apply_matches_reference(arch, impl):
    """Both implementations against the reference's of the same name, and
    the balance loss; Arctic adds its dense residual MLP."""
    jcfg, jp, cfg, tp = _moe(arch)
    assert ("dense" in tp) == cfg.dense_residual == (arch == "arctic_480b")
    x = _x((2, 9, cfg.d_model), seed=2)
    want, want_aux = jax_moe.apply(jp, jcfg, jnp.asarray(x), impl=impl)
    with recorded_gaps([]) as calls:
        got, aux = moe.apply(tp, cfg, torch.from_numpy(x), impl=impl)
    assert float(calls[0].min()) > ROUTE_GAP
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_ragged_equals_dense_and_counts_its_host_read():
    jcfg, jp, cfg, tp = _moe("qwen3_moe_235b", n_experts=8, top_k=3)
    x = torch.from_numpy(_x((3, 7, cfg.d_model), seed=3))
    moe.group_size_syncs = 0
    y_r, a_r = moe.apply(tp, cfg, x, impl="ragged")
    y_d, a_d = moe.apply(tp, cfg, x, impl="dense")
    assert moe.group_size_syncs == 1
    _close(y_r.numpy(), y_d.numpy())
    assert float(a_r) == float(a_d)
    # one token, the decode step's shape: most experts get no row
    y1, _ = moe.apply(tp, cfg, x[:1, :1], impl="ragged")
    _close(y1.numpy(), moe.apply(tp, cfg, x[:1, :1], "dense")[0].numpy())
    assert moe.group_size_syncs == 2


def test_ep_is_refused():
    _, _, cfg, tp = _moe("qwen3_moe_235b")
    with pytest.raises(ValueError, match="item 15"):
        moe.apply(tp, cfg, torch.zeros((1, 2, cfg.d_model)), impl="ep")
    with pytest.raises(ValueError, match="unknown"):
        moe.apply(tp, cfg, torch.zeros((1, 2, cfg.d_model)), impl="megablocks")


def test_port_init_shapes_follow_the_reference():
    for arch in ("qwen3_moe_235b", "arctic_480b"):
        _, jp, cfg, _ = _moe(arch)
        g = torch.Generator().manual_seed(0)
        tp = moe.init(cfg, g, "cpu")
        shapes = lambda t: {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                            for k, v in t.items()}
        assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
