"""The port's attention kernels, held to the JAX package's Pallas kernels.

On the CPU the port's dispatch runs each kernel's plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode.  Inputs are made
with numpy from a seed and handed to both as numpy arrays.  Tolerance is
1e-5 (absolute and relative) in f32: the two compute the same math, but the
Pallas kernel sums block by block with an online softmax while the plain
version takes one softmax over the gathered row, so summation order differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import elite_decode as jax_ed
from repro.kernels import flash_prefill as jax_fp

from repro_torch.kernels import build, ops
from repro_torch.kernels import elite_decode as ed
from repro_torch.kernels import flash_prefill as fp

TOL = dict(atol=1e-5, rtol=1e-5)


def _decode_case(seed, nkv, G, r2, dc, bs, mb, lengths, separate):
    """Pool of random pages; lanes own disjoint random chains, padded with
    block 0 — which is a live block of some lane, so only ``lengths`` may
    hide it."""
    rng = np.random.default_rng(seed)
    B, nh = len(lengths), nkv * G
    n_blocks = B * mb + 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    case = dict(q_e=f(B, nh, r2), q_lat=f(B, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
                c_k=f(n_blocks * bs, dc))
    case["c_v"] = f(n_blocks * bs, dc) if separate else case["c_k"]
    perm = np.concatenate([[0], 1 + rng.permutation(n_blocks - 1)])
    bt = np.zeros((B, mb), np.int32)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-L // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    case["bt"] = bt
    case["lengths"] = np.asarray(lengths, np.int32)
    return case


@pytest.mark.parametrize("nkv,G,r2,dc,bs,separate", [
    (2, 1, 8, 32, 8, False),      # MHA-like
    (1, 4, 8, 64, 4, False),      # GQA, G = 4
    (2, 4, 16, 32, 8, True),      # GQA with separate c_k / c_v (S-LRD)
])
def test_elite_decode_paged_matches_pallas(nkv, G, r2, dc, bs, separate):
    mb = 4
    # empty lane, one token, partial last block, exact block, ragged, full
    lengths = [0, 1, bs - 3, bs, 2 * bs + 3, mb * bs]
    c = _decode_case(0, nkv, G, r2, dc, bs, mb, lengths, separate)
    scale = 0.3
    want = np.asarray(jax_ed.elite_decode_paged(
        *(jnp.asarray(c[k]) for k in ("q_e", "q_lat", "k_e", "c_k", "c_v", "bt",
                                      "lengths")),
        G, scale, bs, interpret=True))
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    if not separate:
        t["c_v"] = t["c_k"]
    got = ops.elite_decode_paged(t["q_e"], t["q_lat"], t["k_e"], t["c_k"], t["c_v"],
                                 t["bt"], t["lengths"], G, scale, bs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0].abs().max()) == 0.0          # empty lane: exact zeros


@pytest.mark.parametrize("nkv,G", [(2, 1), (1, 4)])
def test_flash_prefill_matches_pallas(nkv, G):
    rng = np.random.default_rng(1)
    B, Sq, Sk, dh = 3, 8, 16, 16
    nh = nkv * G
    q = rng.standard_normal((B, Sq, nh, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, dh)).astype(np.float32)
    # fresh lane, a lane resumed at position 5, and a kv_len = 0 lane
    offs = np.asarray([0, 5, 0], np.int32)
    lens = np.asarray([Sq, 5 + Sq - 2, 0], np.int32)
    scale = dh ** -0.5
    want = np.asarray(jax_fp.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), G, scale, block_q=8,
        block_k=8, q_offset=jnp.asarray(offs), kv_lens=jnp.asarray(lens),
        interpret=True))
    got = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), G, scale, torch.from_numpy(offs),
                            torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[2].abs().max()) == 0.0          # kv_len = 0: exact zeros


def test_cpu_tensors_take_the_plain_version():
    """Dispatch: CPU inputs run the plain version and launch nothing."""
    ops.reset_launches()
    c = _decode_case(2, 2, 2, 4, 16, 4, 2, [3, 8], False)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    ops.elite_decode_paged(t["q_e"], t["q_lat"], t["k_e"], t["c_k"], t["c_k"],
                           t["bt"], t["lengths"], 2, 0.5, 4)
    q = torch.zeros(1, 4, 2, 32)
    kv = torch.zeros(1, 4, 1, 32)
    ops.flash_prefill(q, kv, kv, 2, 0.5, torch.zeros(1, dtype=torch.int32),
                      torch.full((1,), 4, dtype=torch.int32))
    assert ops.launches() == {"elite_decode_paged": 0, "flash_prefill": 0}


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers raise on CPU tensors instead of computing anything."""
    ops.reset_launches()
    c = _decode_case(3, 1, 1, 4, 16, 4, 2, [3, 8], False)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ed.elite_decode_paged(t["q_e"], t["q_lat"], t["k_e"], t["c_k"], t["c_k"],
                              t["bt"], t["lengths"], 1, 0.5, 4)
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fp.flash_prefill(q, q[:, :, :1], q[:, :, :1], 2, 0.5,
                         torch.zeros(1, dtype=torch.int32),
                         torch.full((1,), 4, dtype=torch.int32))
    assert ops.launches() == {"elite_decode_paged": 0, "flash_prefill": 0}


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 3, dtype=torch.float64), TypeError),
    (torch.zeros(3, 2), ValueError),
    (torch.zeros(3, 2).T, ValueError),
])
def test_binding_check_rejects(bad, err):
    """What a kernel reading raw pointers cannot take: wrong dtype, shape,
    or a non-contiguous layout."""
    with pytest.raises(err):
        build.check(bad, "x", (2, 3), torch.float32, torch.device("cpu"))
