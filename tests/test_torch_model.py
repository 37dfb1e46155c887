"""The port's model forward, held to the JAX package's ``models/lm.py``.

The JAX model's weights are carried across by ``repro_torch.interop``; the
same host-side pool bookkeeping (tables, slot mappings) drives both sides.
Tolerances (f32): rope 1e-6; logits 1e-4 and pool pages 1e-5 absolute — the
same math, summed in another order (the port attends through its
flash-prefill path where the reference uses XLA).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rope as jax_rope
from repro.core.cache import PagedKVPool as JaxPool
from repro.models import lm as jax_lm

from repro_torch import interop
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import rope
from repro_torch.core.cache import PagedKVPool
from repro_torch.models import lm

BS, N_BLOCKS, MB = 4, 16, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_elite_rope_matches(per_lane):
    rng = np.random.default_rng(0)
    B, S, H, r = 2, 7, 3, 4
    x = rng.standard_normal((B, S, H, 2 * r)).astype(np.float32)
    freqs = rng.uniform(1e-3, 1.0, (H, r)).astype(np.float32)
    pos = (rng.integers(0, 900, (B, S)) if per_lane else np.arange(S) * 37).astype(np.int32)
    want = np.asarray(jax_rope.apply_elite_rope(jnp.asarray(x), jnp.asarray(pos),
                                                jnp.asarray(freqs)))
    got = rope.apply_elite_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                torch.from_numpy(freqs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _port_cfg(jcfg):
    """The port's config with the reference config's values."""
    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=jcfg.num_layers, vocab_size=jcfg.vocab_size,
        n_kv_heads=jcfg.n_kv_heads)
    e = jcfg.elitekv
    return dataclasses.replace(cfg, elitekv=EliteKVConfig(
        enabled=True, elite_r=e.elite_r, d_ckv=e.d_ckv, lrd=e.lrd))


@pytest.fixture(scope="module", params=[4, 1], ids=["G1", "G4"])
def models(request, tiny_elite_cfg):
    """(jax cfg, jax params, buffers, port cfg, port params, buffers); G = 1
    is the shared test config, G = 4 exercises the GQA head mapping."""
    jcfg = dataclasses.replace(tiny_elite_cfg, n_kv_heads=request.param)
    jp, jb = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jcfg, jp, jb, _port_cfg(jcfg), tp, tb


def _assert_pages(jpool, tpool, written):
    for name, arr in jpool.pages["p0"].items():
        got = tpool.pages["p0"][name].numpy()
        np.testing.assert_allclose(got, np.asarray(arr), atol=1e-5, rtol=0)
        untouched = np.setdiff1d(np.arange(got.shape[1]), np.asarray(written))
        assert not got[:, untouched].any(), "a slot outside the mappings was written"


def test_paged_prefill_and_decode_match(models):
    jcfg, jp, jb, tcfg, tp, tb = models
    rng = np.random.default_rng(7)
    jpool, tpool = JaxPool(jcfg, N_BLOCKS, BS), PagedKVPool(tcfg, N_BLOCKS, BS, device="cpu")
    written = []

    def grow(sid, n):
        jpool.ensure_capacity(sid, n)
        tpool.ensure_capacity(sid, n)
        assert jpool.block_table(sid) == tpool.block_table(sid)

    # 1. fresh one-shot prefill: two prompts, the second padded
    S, n_valid = 12, [12, 9]
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    for sid, n in enumerate(n_valid):
        grow(sid, n)
    sm = np.stack([tpool.prefill_slot_mapping(sid, 0, n, S)
                   for sid, n in enumerate(n_valid)])
    written += sm[sm < tpool.oob_slot].tolist()
    want, jpool.pages = jax_lm.apply_prefill_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm))
    got = lm.apply_prefill_paged(tp, tb, tcfg, torch.from_numpy(toks),
                                 tpool.pages, torch.from_numpy(sm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert float(got[..., jcfg.vocab_size:].max()) == np.float32(-1e30)  # vocab pad
    _assert_pages(jpool, tpool, written)

    # 2. resumed chunks of both sequences at their own offsets, plus an idle lane
    C, starts, n_chunk = 4, [12, 9], [4, 3]
    toks = rng.integers(0, jcfg.vocab_size, (3, C)).astype(np.int32)
    sm = np.full((3, C), tpool.oob_slot, np.int32)
    for sid, (st, n) in enumerate(zip(starts, n_chunk)):
        grow(sid, st + n)
        sm[sid] = tpool.prefill_slot_mapping(sid, st, n, C)
    written += sm[sm < tpool.oob_slot].tolist()
    cs = np.asarray(starts + [0], np.int32)
    bt = tpool.block_table_array([0, 1, None], MB)
    want, jpool.pages = jax_lm.apply_prefill_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm),
        chunk_start=jnp.asarray(cs), block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray(cs), block_size=BS)
    got = lm.apply_prefill_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                                 torch.from_numpy(sm), chunk_start=cs,
                                 block_tables=bt, prefix_lens=cs, block_size=BS)
    # rows of valid tokens only: pad rows and the idle lane are never read,
    # and the reference lets them attend to padding keys the port masks
    for lane, n in enumerate(n_chunk):
        np.testing.assert_allclose(got[lane, :n].numpy(), np.asarray(want)[lane, :n],
                                   atol=1e-4, rtol=0)
    _assert_pages(jpool, tpool, written)

    # 3. one decode step: sequence 0, an idle lane, sequence 1
    lengths = np.asarray([17, 0, 14], np.int32)
    grow(0, 17)
    grow(1, 14)
    sm = tpool.slot_mapping([0, None, 1], [16, 0, 13])
    assert sm.tolist() == jpool.slot_mapping([0, None, 1], [16, 0, 13]).tolist()
    written += sm[sm < tpool.oob_slot].tolist()
    bt = tpool.block_table_array([0, None, 1], MB)
    toks = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    want, jpool.pages = jax_lm.apply_decode_paged(
        jp, jb, jcfg, {"tokens": jnp.asarray(toks)}, jpool.pages, jnp.asarray(sm),
        jnp.asarray(bt), jnp.asarray(lengths), block_size=BS)
    got = lm.apply_decode_paged(tp, tb, tcfg, torch.from_numpy(toks), tpool.pages,
                                torch.from_numpy(sm), bt, lengths, BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    _assert_pages(jpool, tpool, written)


def test_interop_unstacks_layers(models):
    jcfg, jp, jb, tcfg, tp, tb = models
    assert len(tp["layers"]) == len(tb["layers"]) == jcfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(), np.asarray(jp["blocks"]["p0"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            tb["layers"][i]["elite_freqs"].numpy(),
            np.asarray(jb["blocks"]["p0"]["elite_freqs"][i]))


def test_port_init_matches_reference_shapes(models):
    """``lm.init`` builds every leaf the reference has, at its shape."""
    jcfg, jp, jb, tcfg, tp, tb = models
    ip, ib = lm.init(tcfg, seed=3, device="cpu")
    ref_p, ref_b = interop.from_reference(jax.tree.map(np.asarray, jp),
                                          jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(ip) == shapes(ref_p)
    assert shapes(ib) == shapes(ref_b)
    np.testing.assert_array_equal(ib["layers"][0]["elite_freqs"].numpy(),
                                  ref_b["layers"][0]["elite_freqs"].numpy())
