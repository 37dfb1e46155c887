"""The port's attention kernels, held to the JAX package's Pallas kernels.

On the CPU the port's dispatch runs each kernel's plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode.  Inputs are made
with numpy from a seed and handed to both as numpy arrays.  Tolerance is
1e-5 (absolute and relative) in f32: the two compute the same math, but the
Pallas kernel sums block by block with an online softmax while the plain
version takes one softmax over the gathered row, so summation order differs.
The int8 variants take pages quantized by the reference's own quantizer.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import quant as jax_quant
from repro.kernels import elite_decode as jax_ed
from repro.kernels import flash_prefill as jax_fp

from repro_torch.core import quant
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


SHAPES = [
    (2, 1, 8, 32, 8, False),      # MHA-like
    (1, 4, 8, 64, 4, False),      # GQA, G = 4
    (2, 4, 16, 32, 8, True),      # GQA with separate c_k / c_v (S-LRD)
]


def _quantized(c, separate):
    """The case's pages as int8 plus per-slot scales, by the reference's
    quantizer → {name: page} and (k_e, c_k, c_v) scales."""
    q = {}
    for name in ("k_e", "c_k", "c_v") if separate else ("k_e", "c_k"):
        page, s = jax_quant.quantize_rows(jnp.asarray(c[name]))
        q[name], q[name + "_s"] = np.array(page), np.array(s)
    if not separate:
        q["c_v"], q["c_v_s"] = q["c_k"], q["c_k_s"]
    return q


def _selection(c, bs, W, seed):
    """A [B, W] selection over the case's chains: ascending picks of each
    lane's blocks with their counts, count-0 padding at block 0, and a
    repeated physical block (lane 1 picks its first block twice)."""
    rng = np.random.default_rng(seed)
    B = len(c["lengths"])
    st, ct = np.zeros((B, W), np.int32), np.zeros((B, W), np.int32)
    for b, L in enumerate(c["lengths"]):
        n = -(-int(L) // bs)
        pick = np.sort(rng.permutation(n)[:W])
        st[b, :len(pick)] = c["bt"][b, pick]
        ct[b, :len(pick)] = np.clip(L - pick * bs, 0, bs)
    st[1, 1], ct[1, 1] = st[1, 0], ct[1, 0]
    return st, ct


def _args(arrays, separate, q8):
    """Torch inputs; under J-LRD c_v (and its scale) is the c_k tensor."""
    t = [torch.from_numpy(a) for a in arrays]
    if not separate:
        t[4] = t[3]
        if q8:
            t[7] = t[6]
    return t


@pytest.mark.parametrize("variant", ["paged_q8", "sparse_paged", "sparse_paged_q8"])
@pytest.mark.parametrize("nkv,G,r2,dc,bs,separate", SHAPES)
def test_decode_variants_match_pallas(variant, nkv, G, r2, dc, bs, separate):
    """The int8 and selection variants of paged decode against their
    Pallas kernels: empty lane, partial blocks, count-0 selection entries
    and a block selected twice."""
    mb, W = 4, 3
    lengths = [0, 2 * bs + 3, bs - 3, bs, mb * bs, 1]
    c = _decode_case(4, nkv, G, r2, dc, bs, mb, lengths, separate)
    scale = 0.3
    q8 = variant.endswith("q8")
    if q8:
        qc = _quantized(c, separate)
        pages = [qc["k_e"], qc["c_k"], qc["c_v"], qc["k_e_s"], qc["c_k_s"], qc["c_v_s"]]
    else:
        pages = [c["k_e"], c["c_k"], c["c_v"]]
    walk = list(_selection(c, bs, W, 5)) if "sparse" in variant else [c["bt"], c["lengths"]]
    arrays = [c["q_e"], c["q_lat"]] + pages + walk
    want = np.asarray(getattr(jax_ed, "elite_decode_" + variant)(
        *map(jnp.asarray, arrays), G, scale, bs, interpret=True))
    t = _args(arrays, separate, q8)
    got = getattr(ops, "elite_decode_" + variant)(*t, G, scale, bs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0].abs().max()) == 0.0          # empty lane: exact zeros


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_full_width_selection_is_dense(q8):
    """A selection that is the whole table gives the dense plain version's
    bits (f32 and int8 pages)."""
    nkv, G, r2, dc, bs, mb = 2, 2, 8, 32, 4, 5
    c = _decode_case(6, nkv, G, r2, dc, bs, mb, [0, 7, 4, 20, 13], True)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    pages = [t["k_e"], t["c_k"], t["c_v"]]
    if q8:
        pairs = [quant.quantize_rows(p) for p in pages]
        pages = [p for p, _ in pairs] + [s for _, s in pairs]
    mean = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (c["k_e"].shape[0] // bs, dc)).astype(np.float32))
    sel = ops.select_topk_blocks(t["q_lat"], mean, mean.abs(), t["bt"], t["lengths"],
                                 bs, mb, 1)
    assert torch.equal(sel[0], t["bt"])
    dense = (ops.elite_decode_paged_q8 if q8 else ops.elite_decode_paged)(
        t["q_e"], t["q_lat"], *pages, t["bt"], t["lengths"], G, 0.3, bs)
    sparse = (ops.elite_decode_sparse_paged_q8 if q8 else ops.elite_decode_sparse_paged)(
        t["q_e"], t["q_lat"], *pages, *sel, G, 0.3, bs)
    assert torch.equal(sparse, dense)


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
    assert not any(ops.launches().values())


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
    assert not any(ops.launches().values())


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
