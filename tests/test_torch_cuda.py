"""The port's CUDA kernels on the card, held to their plain versions.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  On the card (no JAX there, so without the JAX conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance 5e-5 (absolute and relative) in f32: kernel and plain version do
the same math in another summation order (online softmax over blocks or
tiles against one softmax over the row; dot products of up to 1056 terms).
The int8 kernels dequantize with the plain version's one multiply, so the
same tolerance holds; a full-width selection must give the dense kernel's
bits exactly, and so must a verify window of one token at
``q_offsets = lengths - 1``, and the contiguous ``elite_decode`` over the
same rows seen as identity-table pages.  ``rope_elite`` rotates each pair
once with no reduction, through its one-tensor entry and its q-and-k entry:
2e-6 relative (1e-6 absolute near zero); so does its backward (the kernel
in transpose mode under autograd) against autograd through the plain
version, also at the MoE and hybrid training shapes.  Training gradients
on the card against the CPU's, and the ragged MoE's against the dense
oracle's: 1e-4 of each leaf's largest (f32 matmuls summed in another
order).  The attention kernels have no backward and must raise when asked
for one.  The sharded steps' ``local_map`` wrappers of the rotation and
``flash_prefill`` launch the same kernels on a shard's local tensors and
are held to the plain versions' pieces at the same tolerances.  The
contiguous decode's log-sum-exp (``return_lse``) is held to the plain
version's at 5e-5 and leaves o's bits as they are; pieces of one cache
attended apart and merged by ``ref.merge_lse`` (as the sequence-sharded
decode merges them) give the one call within 5e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import quant, rope
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rope_elite as re_k
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
import sampling_margins

pytestmark = pytest.mark.cuda

TOL = dict(atol=5e-5, rtol=5e-5)
# rope_elite: one rotation per pair, no reduction; the floor is 2e-6 relative
ROPE_TOL = dict(atol=1e-6, rtol=2e-6)
# (nh, nkv, 2r, d_c, d_h): TinyLlama-1.1B and LLaMA2-7B under EliteKV at 25%
WIDTHS = {"tinyllama_1_1b": (32, 4, 16, 64, 64), "llama2_7b": (32, 32, 32, 1024, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _decode_inputs(dev, nh, nkv, r2, dc, separate, bs=16, mb=20, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 15, 16, 100, 257, mb * bs, 33]     # empty, partial, full
    B, n_blocks = len(lengths), len(lengths) * mb + 1
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(n_blocks * bs, dc)
    x = dict(q_e=f(B, nh, r2), q_lat=f(B, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=c_k, c_v=f(n_blocks * bs, dc) if separate else c_k)
    perm = torch.randperm(n_blocks, generator=g, device=dev).int()
    bt = torch.zeros((B, mb), dtype=torch.int32, device=dev)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-L // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    x["bt"], x["lengths"] = bt, torch.tensor(lengths, dtype=torch.int32, device=dev)
    return x, nh // nkv, bs


@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_decode_kernel_matches_plain(width, separate, cuda):
    nh, nkv, r2, dc, dh = WIDTHS[width]
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, separate)
    args = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"], x["bt"], x["lengths"],
            G, dh ** -0.5, bs)
    before = ops.launches()["elite_decode_paged"]
    got = ops.elite_decode_paged(*args)
    want = ref.elite_decode_paged_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches()["elite_decode_paged"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[0].abs().max()) == 0.0


def _quantize(x):
    """The case's pages as int8 with per-slot scales (J-LRD: one latent)."""
    (k, ks), (ck, cks) = quant.quantize_rows(x["k_e"]), quant.quantize_rows(x["c_k"])
    cv, cvs = (ck, cks) if x["c_v"] is x["c_k"] else quant.quantize_rows(x["c_v"])
    return [k, ck, cv, ks, cks, cvs]


def _selection(x, bs, W, seed):
    """Sorted random picks of each lane's blocks with their counts, count-0
    padding, and lane 4 picking one physical block twice → [B, W] int32."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bt, lengths = x["bt"].cpu(), x["lengths"].cpu()
    st = torch.zeros((len(lengths), W), dtype=torch.int32)
    ct = torch.zeros_like(st)
    for b, L in enumerate(lengths.tolist()):
        n = -(-L // bs)
        pick = torch.sort(torch.randperm(n, generator=g)[:W])[0]
        st[b, :len(pick)] = bt[b, pick]
        ct[b, :len(pick)] = (L - pick * bs).clamp(0, bs).int()
    st[4, 1], ct[4, 1] = st[4, 0], ct[4, 0]
    return st.to(x["bt"].device), ct.to(x["bt"].device)


VARIANTS = ["paged_q8", "sparse_paged", "sparse_paged_q8"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_decode_variant_matches_plain(width, separate, variant, cuda):
    nh, nkv, r2, dc, dh = WIDTHS[width]
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, separate, seed=2)
    pages = _quantize(x) if variant.endswith("q8") else [x["k_e"], x["c_k"], x["c_v"]]
    walk = _selection(x, bs, 6, 3) if "sparse" in variant else (x["bt"], x["lengths"])
    args = (x["q_e"], x["q_lat"], *pages, *walk, G, dh ** -0.5, bs)
    name = "elite_decode_" + variant
    before = ops.launches()[name]
    got = getattr(ops, name)(*args)
    want = getattr(ref, name + "_ref")(*args)
    torch.cuda.synchronize()
    assert ops.launches()[name] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_full_width_sparse_kernel_is_dense(width, q8, cuda):
    nh, nkv, r2, dc, dh = WIDTHS[width]
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, False, seed=4)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    n_blocks = x["k_e"].shape[0] // bs
    mean = torch.randn(n_blocks, dc, device=cuda)
    sel = ops.select_topk_blocks(x["q_lat"], mean, mean.abs(), x["bt"], x["lengths"],
                                 bs, x["bt"].shape[1], 2)
    assert torch.equal(sel[0], x["bt"])
    sfx = "_q8" if q8 else ""
    dense = getattr(ops, "elite_decode_paged" + sfx)(
        x["q_e"], x["q_lat"], *pages, x["bt"], x["lengths"], G, dh ** -0.5, bs)
    sparse = getattr(ops, "elite_decode_sparse_paged" + sfx)(
        x["q_e"], x["q_lat"], *pages, *sel, G, dh ** -0.5, bs)
    torch.cuda.synchronize()
    assert torch.equal(sparse, dense)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_flash_kernel_matches_plain(width, cuda):
    nh, nkv, _, _, dh = WIDTHS[width]
    g = torch.Generator(device=cuda).manual_seed(1)
    B, Sq, Sk = 3, 100, 301                 # neither a multiple of the tiles
    q = torch.randn(B, Sq, nh, dh, generator=g, device=cuda)
    k = torch.randn(B, Sk, nkv, dh, generator=g, device=cuda)
    v = torch.randn(B, Sk, nkv, dh, generator=g, device=cuda)
    offs = torch.tensor([0, 137, 0], dtype=torch.int32, device=cuda)
    lens = torch.tensor([Sq, 137 + 90, 0], dtype=torch.int32, device=cuda)
    before = ops.launches()["flash_prefill"]
    got = ops.flash_prefill(q, k, v, nh // nkv, dh ** -0.5, offs, lens)
    want = ref.flash_prefill_ref(q, k, v, nh // nkv, dh ** -0.5, offs, lens)
    torch.cuda.synchronize()
    assert ops.launches()["flash_prefill"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("pool", [
    dict(), dict(cache_dtype="int8"),
    dict(sparse_topk_blocks=2, sparse_recent_blocks=1, admission="watermark"),
    dict(cache_dtype="int8", sparse_topk_blocks=2, sparse_recent_blocks=1,
         admission="watermark"),
], ids=["f32", "int8", "sparse", "int8_sparse"])
def test_scheduler_on_card_matches_cpu(pool, cuda):
    """A short chunked-prefill stream on the card, through the prefill
    kernel and the pool's decode kernel, gives the CPU run's greedy tokens."""
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128).with_elitekv(
        elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else \
        [move(v) for v in t] if isinstance(t, list) else t.to(cuda)
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=4, num_blocks=64,
                                      max_len=40, prefill_chunk_tokens=8, **pool)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 128, (2, 20)).astype(np.int32)
    want, _ = serve_loop.generate_paged(params, buffers, cfg, prompts, 8, scfg, device="cpu")
    ops.reset_launches()
    got, rep = serve_loop.generate_paged(move(params), move(buffers), cfg, prompts, 8,
                                         scfg, device="cuda")
    n = ops.launches()
    np.testing.assert_array_equal(got, want)
    decode = "elite_decode_" + ("sparse_" if "sparse_topk_blocks" in pool else "") + \
        "paged" + ("_q8" if "cache_dtype" in pool else "")
    assert n[decode] == rep.decode_steps * cfg.num_layers > 0
    assert n["flash_prefill"] == rep.prefill_chunks * cfg.num_layers > 0
    # q and k of every layer of every forward rotate in one rope_elite launch
    assert n["rope_elite"] == (rep.decode_steps + rep.prefill_chunks) * cfg.num_layers
    assert sum(n.values()) == n[decode] + n["flash_prefill"] + n["rope_elite"]


def _verify_inputs(dev, nh, nkv, r2, dc, separate, W, bs=16, mb=20, seed=0):
    """Lanes with windows (q_offset, n tokens, n <= W): a dead lane, a
    window at position 0, one crossing a block boundary, a short one (pad
    rows), a ragged one, one ending the table, and a single token."""
    g = torch.Generator(device=dev).manual_seed(seed)
    windows = [(0, 0), (0, W), (bs - 2, W), (100, max(1, W - 2)), (257, W),
               (mb * bs - W, W), (33, 1)]
    B, n_blocks = len(windows), len(windows) * mb + 1
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(n_blocks * bs, dc)
    x = dict(q_e=f(B, W, nh, r2), q_lat=f(B, W, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=c_k, c_v=f(n_blocks * bs, dc) if separate else c_k)
    perm = torch.randperm(n_blocks, generator=g, device=dev).int()
    bt = torch.zeros((B, mb), dtype=torch.int32, device=dev)
    used = 0
    for b, (off, n) in enumerate(windows):
        k = -(-(off + n) // bs) if n else 0
        bt[b, :k] = perm[used:used + k]
        used += k
    x["bt"] = bt
    x["offs"] = torch.tensor([o for o, _ in windows], dtype=torch.int32, device=dev)
    x["lengths"] = torch.tensor([o + n if n else 0 for o, n in windows],
                                dtype=torch.int32, device=dev)
    return x, nh // nkv, bs


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("W", [1, 3, 5])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_verify_kernel_matches_plain(width, separate, W, q8, cuda):
    nh, nkv, r2, dc, dh = WIDTHS[width]
    x, G, bs = _verify_inputs(cuda, nh, nkv, r2, dc, separate, W, seed=W)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    args = (x["q_e"], x["q_lat"], *pages, x["bt"], x["offs"], x["lengths"], G,
            dh ** -0.5, bs)
    name = "elite_verify_paged" + ("_q8" if q8 else "")
    before = ops.launches()[name]
    got = getattr(ops, name)(*args)
    want = getattr(ref, name + "_ref")(*args)
    torch.cuda.synchronize()
    assert ops.launches()[name] == before + 1
    assert got.shape == (7, W, nh, dc)
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[0].abs().max()) == 0.0          # dead lane: exact zeros


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_verify_window_of_one_is_decode_bitwise(width, q8, cuda):
    """W = 1 with q_offsets = lengths - 1 gives the decode kernel's bits."""
    nh, nkv, r2, dc, dh = WIDTHS[width]
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, True, seed=5)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    sfx = "_q8" if q8 else ""
    dense = getattr(ops, "elite_decode_paged" + sfx)(
        x["q_e"], x["q_lat"], *pages, x["bt"], x["lengths"], G, dh ** -0.5, bs)
    offs = (x["lengths"] - 1).clamp(min=0)
    verify = getattr(ops, "elite_verify_paged" + sfx)(
        x["q_e"][:, None].contiguous(), x["q_lat"][:, None].contiguous(), *pages,
        x["bt"], offs, x["lengths"], G, dh ** -0.5, bs)
    torch.cuda.synchronize()
    assert torch.equal(verify[:, 0], dense)


def test_verify_window_beyond_shared_memory_raises(cuda):
    """A window whose query rows do not fit the card's shared memory is
    refused with the limit named, never clamped or sent elsewhere."""
    B, W, nh, nkv, r2, dc, bs = 1, 5, 4, 1, 32, 4096, 16
    q_e = torch.zeros(B, W, nh, r2, device=cuda)
    q_lat = torch.zeros(B, W, nh, dc, device=cuda)
    k_e = torch.zeros(bs, nkv, r2, device=cuda)
    c = torch.zeros(bs, dc, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    before = ops.launches()["elite_verify_paged"]
    with pytest.raises(ValueError, match="opt-in limit"):
        ops.elite_verify_paged(q_e, q_lat, k_e, c, c, torch.zeros(B, 1, **i32),
                               torch.zeros(B, **i32), torch.full((B,), W, **i32),
                               nh // nkv, 0.1, bs)
    assert ops.launches()["elite_verify_paged"] == before


@pytest.mark.parametrize("pool", [dict(), dict(cache_dtype="int8")], ids=["f32", "int8"])
def test_speculative_scheduler_on_card_matches_cpu(pool, cuda):
    """Greedy speculative decode with a truncated draft on the card gives
    the CPU run's tokens, through the verify and decode kernels."""
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128).with_elitekv(
        elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else \
        [move(v) for v in t] if isinstance(t, list) else t.to(cuda)
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=4, num_blocks=64,
                                      max_len=40, prefill_chunk_tokens=8,
                                      speculate_k=2, draft_rank=16, **pool)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 128, (2, 20)).astype(np.int32)
    want, _ = serve_loop.generate_paged(params, buffers, cfg, prompts, 8, scfg, device="cpu")
    ops.reset_launches()
    got, rep = serve_loop.generate_paged(move(params), move(buffers), cfg, prompts, 8,
                                         scfg, device="cuda")
    n = ops.launches()
    np.testing.assert_array_equal(got, want)
    sfx = "_q8" if pool else ""
    assert n["elite_verify_paged" + sfx] == rep.decode_steps * cfg.num_layers > 0
    assert n["elite_decode_paged" + sfx] == rep.draft_forwards * cfg.num_layers > 0
    assert n["flash_prefill"] == rep.prefill_chunks * cfg.num_layers > 0
    assert n["rope_elite"] == (rep.decode_steps + rep.draft_forwards
                               + rep.prefill_chunks) * cfg.num_layers
    assert sum(n.values()) == (n["elite_verify_paged" + sfx] + n["elite_decode_paged" + sfx]
                               + n["flash_prefill"] + n["rope_elite"])


@pytest.mark.parametrize("S", [300, 1152], ids=["S300", "S1152"])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_contiguous_decode_kernel_matches_plain_and_paged(width, separate, S, cuda):
    """Lengths 0, 1, a partial tile, S and past S, with S = 300 not a
    multiple of the tile; the same rows as pages of an identity table give
    ``elite_decode_paged``'s bits."""
    nh, nkv, r2, dc, dh = WIDTHS[width]
    g = torch.Generator(device=cuda).manual_seed(6)
    lengths = [0, 1, 13, 17, S - 5, S, S + 9]
    B = len(lengths)
    f = lambda *s: torch.randn(s, generator=g, device=cuda)
    q_e, q_lat, k_e, c_k = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc)
    c_v = f(B, S, dc) if separate else c_k
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q_e, q_lat, k_e, c_k, c_v, lens, nh // nkv, dh ** -0.5)
    before = ops.launches()["elite_decode"]
    got = ops.elite_decode(*args)
    want = ref.elite_decode_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches()["elite_decode"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[0].abs().max()) == 0.0
    # identity-table pages: each lane padded to whole tiles of 16 rows
    bs, mb = 16, -(-S // 16)
    pad = lambda t: torch.cat([t, t.new_zeros((B, mb * bs - S) + t.shape[2:])], 1)
    pages = [pad(t).reshape((B * mb * bs,) + t.shape[2:]) for t in (k_e, c_k)]
    pages.append(pad(c_v).reshape(B * mb * bs, dc) if separate else pages[1])
    table = torch.arange(B * mb, dtype=torch.int32, device=cuda).reshape(B, mb)
    paged = ops.elite_decode_paged(q_e, q_lat, *pages, table, lens.clamp(max=S),
                                   nh // nkv, dh ** -0.5, bs)
    torch.cuda.synchronize()
    assert torch.equal(got, paged)


@pytest.mark.parametrize("case", ["elite_h32", "elite_h4", "strided_q", "full_dh64",
                                  "full_dh128"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
def test_rope_kernel_matches_plain(case, per_lane, cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S = 3, 257
    if case.startswith("full"):
        dh = int(case[len("full_dh"):])
        H, width = 4, dh
        freqs = rope.chunk_freqs(dh, 10000.0, device=cuda).expand(H, dh // 2)
    else:
        H, width = (4 if case == "elite_h4" else 32), 16
        freqs = torch.exp(-4 * torch.rand(H, width // 2, generator=g, device=cuda))
        freqs[:, 0] = 1.0                     # angles up to 4096 rad
    wide = 64 if case == "strided_q" else width
    x = torch.randn(B, S, H, wide, generator=g, device=cuda)[..., :width]
    shape = (B, S) if per_lane else (S,)
    pos = torch.randint(0, 4097, shape, generator=g, device=cuda)   # int64
    if per_lane:
        pos = pos.int()
    before = ops.launches()["rope_elite"]
    got = ops.rope_elite(x, pos, freqs)
    want = ref.rope_elite_ref(x, pos, freqs)
    torch.cuda.synchronize()
    assert ops.launches()["rope_elite"] == before + 1
    assert got.is_contiguous() and got.shape == (B, S, H, width)
    torch.testing.assert_close(got, want, **ROPE_TOL)


# (query heads, key heads, frequency rows, 2r, projection width, slice start):
# EliteKV at TinyLlama-1.1B and LLaMA2-7B widths (q_e a slice of the
# projection), the full RoPE at dh 64 and 128, and a slice 8 bytes into the
# row, which takes the 8-byte accesses
PAIR_CASES = {"elite_tinyllama": (32, 4, 4, 16, 64, 0), "elite_llama2_7b": (32, 32, 32, 32, 128, 0),
              "full_dh64": (32, 4, 1, 64, 64, 0), "full_dh128": (32, 32, 1, 128, 128, 0),
              "misaligned_slice": (32, 4, 4, 16, 64, 2)}


@pytest.mark.parametrize("BS", [(3, 257), (1, 1)], ids=["B3_S257", "B1_S1"])
@pytest.mark.parametrize("case", list(PAIR_CASES))
@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
def test_rope_pair_kernel_matches_plain(case, per_lane, BS, cuda):
    Hq, Hk, rows, r2, wide, start = PAIR_CASES[case]
    B, S = BS
    g = torch.Generator(device=cuda).manual_seed(8)
    if rows == 1:
        freqs = rope.chunk_freqs(r2, 10000.0, device=cuda)[None]
    else:
        freqs = torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=cuda))
        freqs[:, 0] = 1.0                     # angles up to 4096 rad
    q = torch.randn(B, S, Hq, wide + start, generator=g, device=cuda)[..., start:start + r2]
    k = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    pos = torch.randint(0, 4097, (B, S) if per_lane else (S,), generator=g, device=cuda)
    if per_lane:
        pos = pos.int()
    args = (q, k, pos, freqs, Hq // rows, Hk // rows)
    assert re_k.access_bytes(q, k) == (8 if start else 16)
    before = ops.launches()["rope_elite"]
    got_q, got_k = ops.rope_elite_qk(*args)
    want_q, want_k = ref.rope_elite_qk_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches()["rope_elite"] == before + 1
    assert got_q.is_contiguous() and got_k.is_contiguous()
    torch.testing.assert_close(got_q, want_q, **ROPE_TOL)
    torch.testing.assert_close(got_k, want_k, **ROPE_TOL)


@pytest.mark.parametrize("elitekv", [True, False], ids=["elitekv", "baseline"])
def test_generate_on_card_matches_cpu(elitekv, cuda):
    """Lockstep ``generate`` on the card gives the CPU's greedy tokens and
    launches only the contiguous path's kernels."""
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128)
    if elitekv:
        cfg = cfg.with_elitekv(elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else \
        [move(v) for v in t] if isinstance(t, list) else t.to(cuda)
    prompts = np.random.default_rng(5).integers(0, 128, (3, 20)).astype(np.int32)
    want, _ = serve_loop.generate(params, buffers, cfg, prompts, 8, device="cpu")
    ops.reset_launches()
    got, _ = serve_loop.generate(move(params), move(buffers), cfg, prompts, 8,
                                 device="cuda")
    n = ops.launches()
    np.testing.assert_array_equal(got, want)
    L = cfg.num_layers
    expect = {"rope_elite": 8 * L, "flash_prefill": L if elitekv else 8 * L}
    if elitekv:
        expect["elite_decode"] = 7 * L
    assert {k: v for k, v in n.items() if v} == expect


def _split_case(dev, nh, nkv, r2, dc, separate, mb, lengths, seed):
    """Pages for lanes of ``lengths`` rows over chains of ``mb`` blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bs, B = 16, len(lengths)
    n_blocks = B * mb + 1
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    c_k = f(n_blocks * bs, dc)
    x = dict(q_e=f(B, nh, r2), q_lat=f(B, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=c_k, c_v=f(n_blocks * bs, dc) if separate else c_k)
    perm = torch.randperm(n_blocks, generator=g, device=dev).int()
    x["bt"] = perm[:B * mb].reshape(B, mb).contiguous()
    x["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return x, nh // nkv, bs


@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_split_boundaries_match_plain_and_split_reference(width, separate, cuda):
    """Lengths at the plan's split boundaries (±1) over a wide table that
    gives many splits: the kernel matches the plain version and the split
    reference, and two calls in a row give identical bits (the counters were
    reset, the merge order is fixed)."""
    from repro_torch.kernels import elite_decode as ed
    nh, nkv, r2, dc, dh = WIDTHS[width]
    mb = 96
    x, G, bs = _split_case(cuda, nh, nkv, r2, dc, separate, mb, [0] * 8, seed=8)
    probe = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"], x["bt"], x["lengths"], G,
             dh ** -0.5, bs)
    p = ed.plan_for("elite_decode_paged", probe, ed.sm_count(cuda),
                    ed.smem_optin_limit(cuda))
    assert p.splits > 1
    span = p.tiles_per_split * bs
    x["lengths"] = torch.tensor([0, span - 1, span, span + 1, 2 * span + 1, 1, 17,
                                 mb * bs], dtype=torch.int32, device=cuda)
    args = probe[:6] + (x["lengths"],) + probe[7:]
    got = ops.elite_decode_paged(*args)
    again = ops.elite_decode_paged(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.elite_decode_paged_ref(*args), **TOL)
    torch.testing.assert_close(got, ref.split_call_ref("elite_decode_paged", args,
                                                       p.tiles_per_split), **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("W", [1, 5])
def test_repeated_calls_give_identical_bits(W, cuda):
    """Every entry called twice on the same inputs gives the same bits."""
    nh, nkv, r2, dc, dh = WIDTHS["tinyllama_1_1b"]
    x, G, bs = _verify_inputs(cuda, nh, nkv, r2, dc, False, W, seed=9)
    d, _, _ = _decode_inputs(cuda, nh, nkv, r2, dc, False, seed=9)
    sel = _selection(d, bs, 6, 9)
    calls = {"elite_verify_paged": (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"],
                                    x["bt"], x["offs"], x["lengths"], G, dh ** -0.5, bs),
             "elite_decode_paged": (d["q_e"], d["q_lat"], d["k_e"], d["c_k"], d["c_v"],
                                    d["bt"], d["lengths"], G, dh ** -0.5, bs),
             "elite_decode_sparse_paged": (d["q_e"], d["q_lat"], d["k_e"], d["c_k"],
                                           d["c_v"], *sel, G, dh ** -0.5, bs)}
    q = _quantize(d)
    calls["elite_decode_paged_q8"] = (d["q_e"], d["q_lat"], *q, d["bt"], d["lengths"], G,
                                      dh ** -0.5, bs)
    calls["elite_decode_sparse_paged_q8"] = (d["q_e"], d["q_lat"], *q, *sel, G,
                                             dh ** -0.5, bs)
    calls["elite_verify_paged_q8"] = (x["q_e"], x["q_lat"], *_quantize(x), x["bt"],
                                      x["offs"], x["lengths"], G, dh ** -0.5, bs)
    c = torch.randn(8, 300, dc, device=cuda)
    calls["elite_decode"] = (d["q_e"], d["q_lat"], torch.randn(8, 300, nkv, r2, device=cuda),
                             c, c, d["lengths"], G, dh ** -0.5)
    for name, args in calls.items():
        a, b = getattr(ops, name)(*args), getattr(ops, name)(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b), name


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_selection_with_trailing_zero_counts_matches_plain(q8, cuda):
    """Zero-count entries after a lane's picks (and whole lanes of them)
    add nothing: the kernel matches the plain version, empty lanes are
    exact zeros."""
    nh, nkv, r2, dc, dh = WIDTHS["tinyllama_1_1b"]
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, False, seed=10)
    st, ct = _selection(x, bs, 3, 10)
    pad = torch.zeros((st.shape[0], 9), dtype=torch.int32, device=cuda)
    st, ct = torch.cat([st, pad], 1), torch.cat([ct, pad], 1)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    name = "elite_decode_sparse_paged" + ("_q8" if q8 else "")
    args = (x["q_e"], x["q_lat"], *pages, st, ct, G, dh ** -0.5, bs)
    got = getattr(ops, name)(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, getattr(ref, name + "_ref")(*args), **TOL)
    assert float(got[0].abs().max()) == 0.0


def test_shared_memory_formula_matches_the_kernel(cuda):
    """The host's shared-memory formula (which plans and refuses calls) is
    the kernel source's layout, at both model widths, f32 and int8, one and
    two stages."""
    from repro_torch.kernels import elite_decode as ed
    for (nh, nkv, r2, dc, _) in WIDTHS.values():
        for window in (1, 5):
            for heads in (1, nkv):
                for shared, q8, stages in ((True, False, 2), (False, True, 1),
                                           (False, False, 2), (True, True, 2)):
                    args = (window, nh // nkv, heads, 16, r2, dc, shared, q8, stages)
                    assert ed.smem_bytes(*args) == ed.smem_bytes_built(*args), args



def _lane_walks(dev, nh, nkv, r2, dc, W, seed=11):
    """One lane (lane 0: 300 rows, its own chain, queries and window) decoded
    three ways: beside short lanes (table width 19 blocks), beside a lane of
    600 rows (38 blocks, past the 33 at which a width-sized plan changes at
    8 lanes), and beside the short lanes with the table padded to 80
    blocks.  → [argument tuple of each walk, without the pages]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bs, n_blocks = 16, 200
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    lead = (8, W) if W else (8,)
    q_e, q_lat = f(*lead, nh, r2), f(*lead, nh, dc)
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev).int() + 1
    walks = []
    for lengths, mb in (([300, 20, 5, 40, 17, 1, 0, 33], 19),
                        ([300, 20, 5, 600, 17, 1, 0, 33], 38),
                        ([300, 20, 5, 40, 17, 1, 0, 33], 80)):
        bt = torch.zeros((8, mb), dtype=torch.int32, device=dev)
        used = 0
        for b, L in enumerate(lengths):
            n = -(-L // bs)
            bt[b, :n] = perm[used:used + n]
            used += n
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        offs = (lens - W).clamp(min=0) if W else None
        walks.append((q_e, q_lat, bt, offs, lens))
    pages = (f(n_blocks * bs, nkv, r2), f(n_blocks * bs, dc))
    return walks, pages, bs


@pytest.mark.parametrize("entry", ["elite_decode_paged", "elite_decode_paged_q8",
                                   "elite_verify_paged"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_lane_decode_bits_do_not_depend_on_other_lanes(width, entry, cuda):
    """A lane's output is the same bits beside short lanes, beside a
    600-token lane that widens the table past 33 blocks, and with a wider
    table: the plan's ranges do not move with the other lanes."""
    nh, nkv, r2, dc, dh = WIDTHS[width]
    W = 3 if "verify" in entry else 0
    walks, (k_e, c), bs = _lane_walks(cuda, nh, nkv, r2, dc, W)
    pages = [k_e, c, c]
    if entry.endswith("q8"):
        (k8, ks), (c8, cs) = quant.quantize_rows(k_e), quant.quantize_rows(c)
        pages = [k8, c8, c8, ks, cs, cs]
    outs = []
    for q_e, q_lat, bt, offs, lens in walks:
        walk = (bt, offs, lens) if W else (bt, lens)
        outs.append(getattr(ops, entry)(q_e, q_lat, *pages, *walk, nh // nkv, dh ** -0.5,
                                        bs)[0])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _flash_case(dev, nh, nkv, dh, B, Sq, Sk, seed):
    """q, k, v and ragged per-lane (q_offsets, kv_lens): a fresh lane, a
    resumed one, one whose kv_len ends inside the chunk, a kv_len = 0 lane,
    and (B > 4) lanes of random offsets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    room = Sk - Sq
    offs = [0, room // 3, room, 0] + [int(x) for x in
                                      torch.randint(0, room + 1, (B - 4,), generator=g,
                                                    device=dev)]
    lens = [Sq, room // 3 + Sq, room + Sq // 2 + 1, 0] + [o + Sq for o in offs[4:]]
    i32 = dict(dtype=torch.int32, device=dev)
    return (f(B, Sq, nh, dh), f(B, Sk, nkv, dh), f(B, Sk, nkv, dh), nh // nkv, dh ** -0.5,
            torch.tensor(offs[:B], **i32), torch.tensor(lens[:B], **i32))


@pytest.mark.parametrize("Sq", [1, 2, 8, 100, 256, 1024])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_flash_bodies_match_plain(width, Sq, cuda):
    """Both bodies of ``flash_prefill`` (the decode body up to 16 query rows
    per kv head) against the plain version, with ragged offsets and lengths,
    a kv_len = 0 lane and Sk a multiple of no tile; two calls give the same
    bits; one launch per call."""
    from repro_torch.kernels import flash_prefill as fp
    nh, nkv, _, _, dh = WIDTHS[width]
    args = _flash_case(cuda, nh, nkv, dh, 5, Sq, Sq + 333, seed=Sq)
    body = fp.plan_for(*args).body
    assert body == ("decode" if (nh // nkv) * Sq <= fp.DECODE_ROWS else "prefill")
    before = ops.launches()["flash_prefill"]
    got = ops.flash_prefill(*args)
    again = ops.flash_prefill(*args)
    want = ref.flash_prefill_ref(*args)
    torch.cuda.synchronize()
    assert ops.launches()["flash_prefill"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("width", list(WIDTHS))
def test_flash_decode_bits_do_not_depend_on_other_lanes(width, cuda):
    """The decode body gives a lane the same bits whatever the other lanes'
    kv_len and whatever Sk: its key ranges are fixed."""
    nh, nkv, _, _, dh = WIDTHS[width]
    g = torch.Generator(device=cuda).manual_seed(12)
    B, Sk, wide = 4, 700, 1300
    k = torch.randn(B, wide, nkv, dh, generator=g, device=cuda)
    v = torch.randn(B, wide, nkv, dh, generator=g, device=cuda)
    q = torch.randn(B, 1, nh, dh, generator=g, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    outs = []
    for lens, S in (([513, 20, 5, 90], Sk), ([513, 700, 0, 600], Sk), ([513, 20, 5, 90], wide)):
        lens = torch.tensor(lens, **i32)
        outs.append(ops.flash_prefill(q, k[:, :S].contiguous(), v[:, :S].contiguous(),
                                      nh // nkv, dh ** -0.5, lens - 1, lens)[0])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_flash_shared_memory_formula_matches_the_kernel(cuda):
    """The host's shared-memory formula is the kernel source's layout."""
    from repro_torch.kernels import flash_prefill as fp
    for body in fp.BODIES:
        for dh in fp.HEAD_DIMS:
            assert fp.smem_bytes(body, dh) == fp.smem_bytes_built(body, dh), (body, dh)


# ---------------------------------------------------------------------------
# pool lifecycle on the card: copy-on-write, pinned host swap, the sampler
# ---------------------------------------------------------------------------

def _random_pool(dev, dtype, seed):
    from repro_torch.core.cache import PagedKVPool
    cfg = get_config("tinyllama_1_1b").with_elitekv(elite_r=8, d_ckv=64)
    pool = PagedKVPool(cfg, 64, 16, device=dev, dtype=dtype, block_summaries=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    for a in pool.pages["p0"].values():
        a.copy_(torch.randint(-127, 128, a.shape, generator=g, device=dev, dtype=a.dtype)
                if a.dtype == torch.int8 else torch.randn(a.shape, generator=g, device=dev))
    return pool


def _chain_contents(pool, seq_id, length):
    bs = pool.block_size
    slots = torch.as_tensor(pool.flat_slots(seq_id, np.arange(length)), device=pool.device)
    chain = torch.tensor(pool.block_table(seq_id)[:-(-length // bs)], device=pool.device)
    return {n: (a[:, chain] if n.endswith(("_blkmean", "_blkmax")) else a[:, slots]).cpu()
            for n, a in pool.pages["p0"].items()}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cow_block_copy_on_the_card_is_bitwise(dtype, cuda):
    """A write barrier into a shared block copies its 16 slots of every
    leaf and its summary rows on the card, bit for bit, and leaves the
    reader's block untouched."""
    from repro_torch.core.cache import BlockManager
    pool = _random_pool(cuda, dtype, seed=21)
    bm = BlockManager(pool, prefix_cache=True)
    toks = np.arange(40, dtype=np.int32)
    bm.grow(0, 40)
    assert bm.register_prefix(0, toks) == 2
    assert bm.lookup_prefix(1, toks) == 32
    before = _chain_contents(pool, 0, 32)
    bm.grow(1, 33)
    bm.prepare_write(1, 20, 33)                    # block 1 of the shared two
    torch.cuda.synchronize()
    assert pool.cow_copies == 1 and pool.block_table(1)[0] == pool.block_table(0)[0]
    assert pool.block_table(1)[1] != pool.block_table(0)[1]
    after_reader, after_writer = _chain_contents(pool, 0, 32), _chain_contents(pool, 1, 32)
    for n in before:
        assert torch.equal(after_reader[n], before[n]), n
        assert torch.equal(after_writer[n], before[n]), n


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pinned_swap_roundtrip_on_the_card_is_bitwise(dtype, cuda):
    """Swap-out gathers on the card and copies once into pinned host memory;
    swap-in restores the slots, scales and summary rows on another chain."""
    from repro_torch.core.cache import BlockManager
    pool = _random_pool(cuda, dtype, seed=22)
    bm = BlockManager(pool)
    bm.grow(0, 333)
    before, old = _chain_contents(pool, 0, 333), pool.block_table(0)
    swapped = bm.preempt_swap_out(0, 333)
    assert swapped.host.is_pinned() and swapped.ready is not None
    assert swapped.nbytes() == bm.swapped_bytes
    host = swapped.leaves()
    for n in before:
        assert torch.equal(host[n], before[n]), n
    bm.grow(9, 17)                                 # the restored chain must move
    bm.swap_in(0, swapped)
    torch.cuda.synchronize()
    assert pool.block_table(0) != old
    after = _chain_contents(pool, 0, 333)
    for n in before:
        assert torch.equal(after[n], before[n]), n


def test_sampler_on_the_card_draws_the_cpu_tokens(cuda):
    """The Threefry bits are integer arithmetic: the card draws the CPU's
    bits, and on the same logits the same tokens away from near-ties."""
    from repro_torch.runtime import prng
    g = torch.Generator().manual_seed(5)
    B, V = 32, 32000
    logits = torch.randn(B, V, generator=g) * 3
    temps = torch.rand(B, generator=g) * 1.5
    temps[::4] = 0.0
    top_ps = torch.rand(B, generator=g)
    seeds = torch.randint(-2**31, 2**31 - 1, (B,), generator=g, dtype=torch.int32)
    counts = torch.randint(0, 4096, (B,), generator=g, dtype=torch.int32)
    key_cpu = prng.fold_in(prng.key(seeds), counts)
    key_dev = prng.fold_in(prng.key(seeds.to(cuda)), counts.to(cuda))
    assert torch.equal(prng.random_bits(key_dev, V).cpu(), prng.random_bits(key_cpu, V))
    assert torch.equal(prng.uniform(key_dev, V).cpu(), prng.uniform(key_cpu, V))
    args = (logits, temps, top_ps, seeds, counts)
    want = serve_loop.sample_tokens(*args)
    got = serve_loop.sample_tokens(*(a.to(cuda) for a in args)).cpu()
    margins = sampling_margins.sample_margins(*args)
    decided = margins > 1e-4
    assert decided.sum() >= B - 2
    assert torch.equal(got[decided], want[decided])


# ---------------------------------------------------------------------------
# observability on the card
# ---------------------------------------------------------------------------

def _narrow_on_card(cuda):
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128).with_elitekv(
        elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else \
        [move(v) for v in t] if isinstance(t, list) else t.to(cuda)
    return cfg, move(params), move(buffers)


def _obs_requests(n=4, temp=0.0):
    rng = np.random.default_rng(6)
    return [serve_loop.Request(uid=i, prompt=rng.integers(0, 128, int(rng.integers(12, 30)))
                               .astype(np.int32), max_new_tokens=10, arrival=0.5 * i,
                               temperature=temp, top_p=0.9, seed=3 + i) for i in range(n)]


@pytest.mark.parametrize("pool", [
    dict(eviction="swap", num_blocks=14),
    dict(cache_dtype="int8", sparse_topk_blocks=2, sparse_recent_blocks=1,
         admission="watermark"),
], ids=["f32_swap", "int8_sparse"])
@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_traced_run_on_the_card_is_bitwise_and_spans_equal_launches(pool, temp, cuda):
    """A traced paged run (scheduler, pool and kernel tracer armed) gives the
    untraced run's tokens bit for bit, one kernel span per launch, device
    spans that nest on their track, and a swap's device time."""
    from repro_torch import obs
    cfg, params, buffers = _narrow_on_card(cuda)
    scfg = serve_loop.SchedulerConfig(max_slots=3, block_size=4, max_len=48,
                                      prefill_chunk_tokens=8, **{"num_blocks": 64, **pool})
    plain = serve_loop.Scheduler(params, buffers, cfg, scfg, device=cuda)
    plain.run(_obs_requests(temp=temp))
    tr = obs.Tracer()
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=cuda, tracer=tr,
                                 metrics=obs.MetricsRegistry())
    ops.reset_launches()
    ops.set_kernel_tracer(tr, device=cuda)
    try:
        rep = sched.run(_obs_requests(temp=temp))
    finally:
        ops.set_kernel_tracer(None)
    launches = ops.launches()
    assert {r.uid: r.generated for r in sched.finished} == \
        {r.uid: r.generated for r in plain.finished}
    kern = [e for e in tr.events() if e.track == "kernel"]
    spans = {}
    for e in kern:
        spans[e.name] = spans.get(e.name, 0) + 1
    spans["rope_elite"] = spans.pop("rope_elite_qk", 0) + spans.get("rope_elite", 0)
    assert spans == {k: v for k, v in launches.items() if v}
    ends = sorted((e.ts, e.ts + e.dur) for e in kern)
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))   # one stream: disjoint
    assert all(e.dur > 0 for e in kern)
    if "eviction" in pool:
        swaps = [e for e in tr.events() if e.name in ("swap_out", "swap_in")]
        assert rep.swap_outs > 0 and len(swaps) == rep.swap_outs + rep.swap_ins
        assert all(e.arg("device_ms") > 0 for e in swaps)


def test_tracing_adds_no_sync_to_a_decode_step(cuda, monkeypatch):
    """Count every call that waits for the card or reads a device value
    during one decode step: a traced step makes exactly the untraced
    step's calls."""
    from repro_torch import obs
    cfg, params, buffers = _narrow_on_card(cuda)
    scfg = serve_loop.SchedulerConfig(max_slots=3, block_size=4, num_blocks=64, max_len=48,
                                      prefill_chunk_tokens=0)
    counts = {}

    def counting(owner, name):
        orig = getattr(owner, name)

        def fn(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(owner, name, fn)

    for owner, name in ((torch.cuda, "synchronize"), (torch.Tensor, "item"),
                        (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
                        (torch.cuda.Event, "synchronize"), (torch.cuda.Event, "query"),
                        (torch.cuda.Event, "elapsed_time"), (torch.cuda.Stream, "synchronize")):
        counting(owner, name)

    def one_decode_step(tracer):
        sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=cuda, tracer=tracer)
        for r in _obs_requests(n=3):
            r.arrival = 0.0
            sched.submit(r)
        sched.step()                                   # admission, prefill, first decode
        ops.set_kernel_tracer(tracer, device=cuda)     # anchoring waits once, here
        try:
            counts.clear()
            sched.step()                               # a decode step
            return dict(counts)
        finally:
            ops.set_kernel_tracer(None)

    untraced = one_decode_step(None)
    traced = one_decode_step(obs.Tracer())
    assert traced == untraced


# LLaMA2-13B under EliteKV at half cache (r = 32, d_ckv = 2560): one kv head's
# rows of a W = 5 window (f32) or W = 3 window (int8) do not fit a CTA, so
# the plan cuts the window
LLAMA2_13B_HALF = (40, 40, 64, 2560, 128)


@pytest.mark.parametrize("part", [1, 2, 3])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
def test_forced_window_cut_gives_the_uncut_bits(separate, q8, part, cuda):
    """At LLaMA2-7B widths, where the uncut W = 5 call fits, a window cut
    into parts of ``part`` positions gives the uncut call's bits, row for
    row, and the count goes up once per call."""
    from repro_torch.kernels import elite_decode as ed
    nh, nkv, r2, dc, dh = WIDTHS["llama2_7b"]
    x, G, bs = _verify_inputs(cuda, nh, nkv, r2, dc, separate, 5, seed=17)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    name = "elite_verify_paged" + ("_q8" if q8 else "")
    args = (x["q_e"], x["q_lat"], *pages, x["bt"], x["offs"], x["lengths"], G,
            dh ** -0.5, bs)
    fn = getattr(ed, name)
    whole = fn(*args)
    before = fn.launches
    cut = fn(*args, part=part)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(cut, whole)


@pytest.mark.parametrize("W,q8", [(5, False), (9, False), (3, True), (5, True)],
                         ids=["f32-W5", "f32-W9", "int8-W3", "int8-W5"])
def test_cut_verify_window_matches_plain_at_llama2_13b_widths(W, q8, cuda):
    from repro_torch.kernels import elite_decode as ed
    nh, nkv, r2, dc, dh = LLAMA2_13B_HALF
    x, G, bs = _verify_inputs(cuda, nh, nkv, r2, dc, False, W, seed=W)
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    name = "elite_verify_paged" + ("_q8" if q8 else "")
    args = (x["q_e"], x["q_lat"], *pages, x["bt"], x["offs"], x["lengths"], G,
            dh ** -0.5, bs)
    p = ed.plan_for(name, args, ed.sm_count(cuda), ed.smem_optin_limit(cuda))
    assert p.parts > 1 and p.part < W
    before = ops.launches()[name]
    got = getattr(ops, name)(*args)
    want = getattr(ref, name + "_ref")(*args)
    torch.cuda.synchronize()
    assert ops.launches()[name] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("variant", ["elite_decode_paged", "elite_decode_paged_q8"])
def test_decode_matches_plain_at_llama2_13b_widths(variant, cuda):
    nh, nkv, r2, dc, dh = LLAMA2_13B_HALF
    x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, False)
    pages = _quantize(x) if variant.endswith("q8") else [x["k_e"], x["c_k"], x["c_v"]]
    args = (x["q_e"], x["q_lat"], *pages, x["bt"], x["lengths"], G, dh ** -0.5, bs)
    got = getattr(ops, variant)(*args)
    want = getattr(ref, variant + "_ref")(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", ["elite_llama2_13b", "full_dh128_40", "elite_minicpm"])
def test_rope_pair_kernel_with_row_blocks_matches_plain(case, cuda):
    """Rows that do not fit one CTA (LLaMA2-13B at half cache: 40 rows of 32
    pairs) are cut into row blocks; every head still matches the plain
    version, and MiniCPM-2B's 36 one-head rows too."""
    Hq, Hk, rows, r2 = {"elite_llama2_13b": (40, 40, 40, 64), "full_dh128_40": (40, 40, 1, 128),
                        "elite_minicpm": (36, 36, 36, 32)}[case]
    B, S = 3, 257
    g = torch.Generator(device=cuda).manual_seed(9)
    freqs = (rope.chunk_freqs(r2, 10000.0, device=cuda)[None] if rows == 1 else
             torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=cuda)))
    q = torch.randn(B, S, Hq, r2, generator=g, device=cuda)
    k = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    pos = torch.randint(0, 4097, (S,), generator=g, device=cuda)
    args = (q, k, pos, freqs, Hq // rows, Hk // rows)
    if case == "elite_llama2_13b":
        assert re_k.plan_for(*args).row_blocks == 2
    got = ops.rope_elite_qk(*args)
    want = ref.rope_elite_qk_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **ROPE_TOL)


@pytest.mark.parametrize("dh", [64, 128])
def test_masked_rope_matches_plain(dh, cuda):
    """``rope.apply_rope_subset`` (the RoPElite search's rotation, one
    frequency row per head, masked chunks at frequency 0) through the
    kernel: equal to the plain version, masked pairs passed through
    exactly."""
    B, S, H = 2, 300, 32
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(B, S, H, dh, generator=g, device=cuda)
    mask = torch.rand(H, dh // 2, generator=g, device=cuda) < 0.3
    pos = torch.arange(S, device=cuda)
    got = rope.apply_rope_subset(x, pos, 10000.0, mask)
    freqs = rope.chunk_freqs(dh, 10000.0, device=cuda) * mask.float()
    want = ref.rope_elite_ref(x, pos, freqs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ROPE_TOL)
    keep = ~mask.repeat_interleave(2, dim=1)
    assert torch.equal(got[:, :, keep], x[:, :, keep])


# -- the rotation's backward (the kernel's transpose mode) and training --------

# PAIR_CASES and LLaMA2-13B at half cache: 40 rows of 32 pairs, whose
# threads exceed one CTA's, so the rows go in row blocks
BWD_CASES = {**PAIR_CASES, "elite_llama2_13b_half": (40, 40, 40, 64, 128, 0)}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
def test_rope_backward_kernel_matches_plain_autograd(case, per_lane, cuda):
    """The gradient through ``ops.rope_elite_qk`` on the card (its backward
    is the kernel in transpose mode, one launch) equals autograd through the
    plain version, into the projection a strided q was sliced from."""
    Hq, Hk, rows, r2, wide, start = BWD_CASES[case]
    B, S = 3, 257
    g = torch.Generator(device=cuda).manual_seed(9)
    if rows == 1:
        freqs = rope.chunk_freqs(r2, 10000.0, device=cuda)[None]
    else:
        freqs = torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=cuda))
        freqs[:, 0] = 1.0
    proj = torch.randn(B, S, Hq, wide + start, generator=g, device=cuda)
    k0 = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    gq = torch.randn(B, S, Hq, r2, generator=g, device=cuda)
    gk = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    pos = torch.randint(0, 4097, (B, S) if per_lane else (S,), generator=g, device=cuda)
    grads = {}
    for name, fn in (("kernel", ops.rope_elite_qk), ("plain", ref.rope_elite_qk_ref)):
        p, k = proj.clone().requires_grad_(True), k0.clone().requires_grad_(True)
        before = ops.launches()["rope_elite_backward"]
        qo, ko = fn(p[..., start:start + r2], k, pos, freqs, Hq // rows, Hk // rows)
        grads[name] = torch.autograd.grad((qo * gq).sum() + (ko * gk).sum(), (p, k))
        torch.cuda.synchronize()
        assert ops.launches()["rope_elite_backward"] == before + (name == "kernel")
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, **ROPE_TOL)
    assert not grads["kernel"][0][..., :start].any()
    assert not grads["kernel"][0][..., start + r2:].any()


def test_rope_one_tensor_backward_kernel_matches_plain_autograd(cuda):
    """The one-tensor entry (the full RoPE's broadcast frequency row) under
    autograd: one backward launch, the plain version's gradient."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x0 = torch.randn(2, 300, 8, 64, generator=g, device=cuda)
    gy = torch.randn(2, 300, 8, 64, generator=g, device=cuda)
    pos = torch.arange(300, device=cuda)
    freqs = rope.chunk_freqs(64, 10000.0, device=cuda).expand(8, 32)
    out = {}
    for name, fn in (("kernel", ops.rope_elite), ("plain", ref.rope_elite_ref)):
        x = x0.clone().requires_grad_(True)
        before = ops.launches()["rope_elite_backward"]
        out[name], = torch.autograd.grad((fn(x, pos, freqs) * gy).sum(), (x,))
        torch.cuda.synchronize()
        assert ops.launches()["rope_elite_backward"] == before + (name == "kernel")
    torch.testing.assert_close(out["kernel"], out["plain"], **ROPE_TOL)


@pytest.mark.parametrize("entry", ["elite_decode_paged", "elite_decode_paged_q8",
                                   "elite_decode_sparse_paged",
                                   "elite_decode_sparse_paged_q8", "elite_verify_paged",
                                   "elite_verify_paged_q8", "elite_decode", "flash_prefill"])
def test_kernels_without_backward_raise_under_grad(entry, cuda):
    """A CUDA input that requires grad under grad mode makes a kernel that
    has no backward raise, naming it; under no_grad it runs."""
    nh, nkv, r2, dc, dh = WIDTHS["tinyllama_1_1b"]
    if entry == "flash_prefill":
        args = _flash_case(cuda, nh, nkv, dh, 4, 8, 16, seed=1)
    elif entry == "elite_decode":
        g = torch.Generator(device=cuda).manual_seed(2)
        f = lambda *s: torch.randn(s, generator=g, device=cuda)
        c = f(2, 64, dc)
        args = (f(2, nh, r2), f(2, nh, dc), f(2, 64, nkv, r2), c, c,
                torch.tensor([5, 64], dtype=torch.int32, device=cuda), nh // nkv, dh ** -0.5)
    else:
        verify = "verify" in entry
        x, G, bs = (_verify_inputs(cuda, nh, nkv, r2, dc, False, 3) if verify
                    else _decode_inputs(cuda, nh, nkv, r2, dc, False))
        pages = _quantize(x) if entry.endswith("_q8") else [x["k_e"], x["c_k"], x["c_v"]]
        walk = (_selection(x, bs, 4, 3) if "sparse" in entry else
                (x["bt"], x["offs"], x["lengths"]) if verify else (x["bt"], x["lengths"]))
        args = (x["q_e"], x["q_lat"], *pages, *walk, G, dh ** -0.5, bs)
    leaf = args[0].detach().clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=entry):
        getattr(ops, entry)(leaf, *args[1:])
    with torch.no_grad():
        getattr(ops, entry)(leaf, *args[1:])
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["jlrd", "baseline"])
def test_training_gradients_on_card_match_cpu(kind, cuda):
    """A reduced model's loss gradient on the card, through the rotary
    kernel forward and backward (2 forward launches per layer under full
    remat, 1 backward), equals the CPU's plain-rotation gradient for every
    leaf (1e-4 of the leaf's largest, f32 summed in another order); wk_e
    gets one."""
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128)
    if kind == "jlrd":
        cfg = cfg.with_elitekv(elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) else \
        [move(v) for v in t] if isinstance(t, list) else t.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    from repro_torch.tree import items
    grads = {}
    for where, (p, b) in (("cpu", (params, buffers)), ("cuda", (move(params), move(buffers)))):
        names, leaves = zip(*items(p))
        for t in leaves:
            t.requires_grad_(True)
        ops.reset_launches()
        loss, _ = lm.loss_fn(p, b, cfg, {k: v.to(where) for k, v in batch.items()})
        grads[where] = dict(zip(names, torch.autograd.grad(loss, leaves)))
        if where == "cuda":
            torch.cuda.synchronize()
            n = {k: v for k, v in ops.launches().items() if v}
            assert n == {"rope_elite": 2 * cfg.num_layers,
                         "rope_elite_backward": cfg.num_layers}, n
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name].cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-7, name
    if kind == "jlrd":
        assert float(grads["cuda"]["layers/0/attn/wk_e"].abs().max()) > 0


def _to_card(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_card(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v, dev) for v in tree]
    return tree.to(dev)


def _rel_close(got, want, tol=1e-5):
    """|got - want| <= tol · max|want| (f32 matmuls summed in another order)."""
    got = got.cpu()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b"])
def test_moe_on_card_matches_cpu(arch, cuda):
    """A reduced MoE FFN (ragged, one group-size read per call) on the card
    against the CPU on the same params and tokens, where no router comes
    within ``ROUTE_GAP`` of another choice: 1e-5 of the output's largest."""
    from repro_torch.models import moe
    from routing_margins import ROUTE_GAP, recorded_gaps
    cfg = get_config(arch).reduced()
    p = moe.init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with recorded_gaps([]) as calls:
        want, want_aux = moe.apply(p, cfg, x)
    assert float(calls[0].min()) > ROUTE_GAP
    moe.group_size_syncs = 0
    got, aux = moe.apply(_to_card(p, cuda), cfg, x.to(cuda))
    assert moe.group_size_syncs == 1
    _rel_close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b"])
def test_ragged_moe_gradient_on_card_matches_dense(arch, cuda):
    """The ragged MoE's gradient on the card (every expert weight split
    once, one ``stack`` on the way back) against the dense oracle's, for
    the input and every weight, where no router comes within ``ROUTE_GAP``
    of another choice: 1e-4 of each leaf's largest."""
    from repro_torch.models import moe
    from routing_margins import ROUTE_GAP, recorded_gaps
    cfg = get_config(arch).reduced()
    p0 = _to_card(moe.init(cfg, torch.Generator().manual_seed(2), "cpu"), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn(2, 24, cfg.d_model, generator=g, device=cuda)
    gy = torch.randn(2, 24, cfg.d_model, generator=g, device=cuda)
    grads = {}
    for impl in ("ragged", "dense"):
        p = {k: v.clone().requires_grad_(True) if torch.is_tensor(v) else
             {n: t.clone().requires_grad_(True) for n, t in v.items()} for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        with recorded_gaps([]) as calls:
            y, aux = moe.apply(p, cfg, x, impl=impl)
        assert float(calls[0].min()) > ROUTE_GAP
        leaves = [x] + [t for v in p.values() for t in
                        (v.values() if isinstance(v, dict) else [v])]
        grads[impl] = torch.autograd.grad((y * gy).sum() + aux, leaves)
    for got, want in zip(grads["ragged"], grads["dense"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-7


# the rotation's backward at the MoE and hybrid training shapes (PERF.md rows
# 9q, 9j): q_e [1, 512, H, 32] a slice of the 128-wide [q_e | q_ne] gradient,
# one frequency row per kv head (Hq, Hk, rows, 2r, width)
MOE_BWD_CASES = {"qwen3_moe": (64, 4, 4, 32, 128), "jamba": (32, 8, 8, 32, 128)}


@pytest.mark.parametrize("case", list(MOE_BWD_CASES))
def test_rope_backward_at_moe_and_hybrid_training_shapes(case, cuda):
    Hq, Hk, rows, r2, wide = MOE_BWD_CASES[case]
    B, S = 1, 512
    g = torch.Generator(device=cuda).manual_seed(11)
    freqs = torch.exp(-4 * torch.rand(rows, r2 // 2, generator=g, device=cuda))
    proj = torch.randn(B, S, Hq, wide, generator=g, device=cuda)
    k0 = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    gq = torch.randn(B, S, Hq, r2, generator=g, device=cuda)
    gk = torch.randn(B, S, Hk, r2, generator=g, device=cuda)
    pos = torch.arange(S, device=cuda)
    grads = {}
    for name, fn in (("kernel", ops.rope_elite_qk), ("plain", ref.rope_elite_qk_ref)):
        p, k = proj.clone().requires_grad_(True), k0.clone().requires_grad_(True)
        before = ops.launches()["rope_elite_backward"]
        qo, ko = fn(p[..., :r2], k, pos, freqs, Hq // rows, Hk // rows)
        grads[name] = torch.autograd.grad((qo * gq).sum() + (ko * gk).sum(), (p, k))
        torch.cuda.synchronize()
        assert ops.launches()["rope_elite_backward"] == before + (name == "kernel")
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, **ROPE_TOL)
    assert not grads["kernel"][0][..., r2:].any()


def test_mamba_on_card_matches_cpu(cuda):
    """A reduced Mamba layer (chunk 8: three chunks, the tail padded): the
    prefill output and final state, then 4 decode steps, card vs CPU."""
    from repro_torch.models import mamba
    cfg = get_config("falcon_mamba_7b").reduced(ssm_chunk=8)
    p = mamba.init(cfg, torch.Generator().manual_seed(0), "cpu")
    pc = _to_card(p, cuda)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(2))
    want, (wc, ws) = mamba.apply_full(p, cfg, x[:, :20], return_state=True)
    got, (gc, gs) = mamba.apply_full(pc, cfg, x[:, :20].to(cuda), return_state=True)
    for g, w in ((got, want), (gc, wc), (gs, ws)):
        _rel_close(g, w)
    wst, gst = {"conv": wc, "ssm": ws}, {"conv": gc, "ssm": gs}
    for t in range(20, 24):
        want, wst = mamba.apply_decode(p, cfg, x[:, t:t + 1], wst)
        got, gst = mamba.apply_decode(pc, cfg, x[:, t:t + 1].to(cuda), gst)
        _rel_close(got, want)
    _rel_close(gst["ssm"], wst["ssm"])


@pytest.mark.parametrize("arch,layers", [("jamba_v0_1_52b", 8), ("falcon_mamba_7b", 2),
                                         ("qwen3_moe_235b", 2)])
def test_hybrid_generate_on_card_matches_cpu(arch, layers, cuda):
    """Reduced stacks through ``generate`` (EliteKV on where there is
    attention: the contiguous decode, ``flash_prefill`` and the rotation,
    once per attention layer and forward): the card's greedy tokens are
    the CPU's; Qwen3-MoE also through the paged ``Scheduler``."""
    cfg = get_config(arch).reduced(num_layers=layers)
    if cfg.n_attn_layers:
        cfg = cfg.with_elitekv()
    params, buffers = lm.init(cfg, seed=3, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 20))
    want, _ = serve_loop.generate(params, buffers, cfg, prompts, 8, device="cpu")
    cp, cb = _to_card(params, cuda), _to_card(buffers, cuda)
    ops.reset_launches()
    got, stats = serve_loop.generate(cp, cb, cfg, prompts, 8, device=cuda)
    torch.cuda.synchronize()
    n = {k: v for k, v in ops.launches().items() if v}
    L = cfg.n_attn_layers
    assert n == ({"elite_decode": 7 * L, "flash_prefill": L, "rope_elite": 8 * L} if L
                 else {}), n
    np.testing.assert_array_equal(got, want)
    if arch == "qwen3_moe_235b":
        scfg = serve_loop.SchedulerConfig(max_slots=3, block_size=8, num_blocks=32,
                                          max_len=64, prefill_chunk_tokens=16)
        want, _ = serve_loop.generate_paged(params, buffers, cfg, prompts, 8, scfg,
                                            device="cpu")
        got, _ = serve_loop.generate_paged(cp, cb, cfg, prompts, 8, scfg, device=cuda)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [("decode_32k", dict(batch=4, seq_len=256)),
                                        ("prefill_32k", dict(batch=2, seq_len=256)),
                                        ("train_4k", dict(batch=2, seq_len=64))])
def test_dryrun_peak_matches_the_card(shape, size, cuda):
    """A reduced TinyLlama step's peak on the card (``max_memory_allocated``
    less what was held before its tensors were made) within chip_smoke
    phase 3o's bound, max(3%, 256 MiB), of ``lower_cell``'s prediction on a
    1 x 1 plan, with the trace's kernel calls as the launches."""
    import gc
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    small = get_config("tinyllama_1_1b").reduced().with_elitekv()
    over = {k: getattr(small, k) for k in ("num_layers", "d_model", "n_heads", "n_kv_heads",
                                           "d_head", "d_ff", "vocab_size", "elitekv")}
    rec, cell = dryrun.lower_cell("tinyllama_1_1b", shape, mesh_axes={"data": 1, "model": 1},
                                  overrides=over, return_cell=True, **size)
    gc.collect()
    torch.cuda.empty_cache()
    build.free_scratch(cuda)
    held = torch.cuda.memory_allocated(cuda)
    state = dryrun.cell_state(cell, cuda, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    ops.reset_launches()
    out = dryrun.run_step(cell, state)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(cuda) - held
    launches = {k: v for k, v in ops.launches().items() if v}
    del out, state
    build.free_scratch(cuda)
    pred = rec["memory"]["peak_estimate_bytes"]
    assert abs(pred - measured) <= max(0.03 * measured, 256 * 2**20), (pred, measured)
    assert launches == {k: v["calls"] for k, v in rec["kernels"].items()}


NEAR_TIE = 1e-3          # chip_smoke.py's: a top-2 margin f32 rounding may decide


def _near_tie_margin(params, buffers, cfg, tokens, dev) -> float:
    """Top-1/top-2 margin of the next token after ``tokens`` (a one-shot
    prefill into a fresh pool), as chip_smoke.py's ``near_tie_margin``."""
    from repro_torch.core.cache import PagedKVPool
    n = len(tokens)
    pool = PagedKVPool(cfg, -(-n // 16), 16, device=dev)
    pool.ensure_capacity(0, n)
    sm = pool.prefill_slot_mapping(0, 0, n, n)[None]
    logits = lm.apply_prefill_paged(
        params, buffers, cfg, torch.from_numpy(np.asarray(tokens, np.int32)[None]).to(dev),
        pool.pages, torch.from_numpy(sm))
    top = torch.topk(logits[0, n - 1].double(), 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("name", ["plain", "recompute", "prefix", "int8", "spec"])
def test_router_on_card_matches_one_scheduler(name, cuda):
    """Two replicas sharing the card against one Scheduler on the same
    requests (sharded_check's): a stream may part only where the single
    scheduler's token is a near-tie (margin under NEAR_TIE), and each
    replica launched exactly its own forwards' kernels."""
    from repro_torch.runtime import sharded_check
    from repro_torch.runtime.router import Router
    cfg, params, buffers, prompts = sharded_check.tiny_model(cuda)
    knobs, req = sharded_check.scenario_knobs(name)
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=8, num_blocks=24,
                                      prefill_chunk_tokens=8,
                                      max_new_tokens=sharded_check.NEW_TOKENS, **knobs)
    sched = serve_loop.Scheduler(params, buffers, cfg, scfg, device=cuda)
    sched.run(sharded_check.build_requests(prompts, **req))
    ops.reset_launches()
    router = Router(params, buffers, cfg, scfg, num_replicas=2, devices=[cuda, cuda])
    rep = router.run(sharded_check.build_requests(prompts, **req))
    total = {k: v for k, v in ops.launches().items() if v}
    assert router.devices == [torch.device("cuda", 0)] * 2
    assert all(r.params is params for r in router.replicas)
    L = cfg.num_layers
    for r, n in zip(rep.replicas, rep.launches):
        sfx = "_q8" if scfg.cache_dtype == "int8" else ""
        want = {"flash_prefill": r.prefill_chunks * L,
                "rope_elite": (r.prefill_chunks + r.decode_steps + r.draft_forwards) * L}
        if scfg.speculate_k:
            want.update({"elite_verify_paged" + sfx: r.decode_steps * L,
                         "elite_decode_paged" + sfx: r.draft_forwards * L})
        else:
            want["elite_decode_paged" + sfx] = r.decode_steps * L
        assert n == want and all(want.values())
    assert total == {k: sum(n.get(k, 0) for n in rep.launches) for k in total}
    got = router.finished_tokens()
    for r in sched.finished:
        diff = [t for t, (a, b) in enumerate(zip(got[r.uid], r.generated)) if a != b]
        if diff:
            ctx = list(r.prompt) + r.generated[:diff[0]]
            assert _near_tie_margin(params, buffers, cfg, ctx, cuda) < NEAR_TIE, r.uid
        else:
            assert got[r.uid] == r.generated


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form", ["decode", "sparse", "verify"])
def test_tp_wrappers_on_card_bitwise_unsharded(form, q8, tp, cuda):
    """Each head shard's launch on a ``TPMesh`` of the one card, at
    TinyLlama-1.1B's widths (32/4 heads): the gathered output is the
    unsharded launch's bit for bit, from ``tp`` launches of the entry."""
    from repro_torch.launch.mesh import TPMesh
    nh, nkv, r2, dc, dh = WIDTHS["tinyllama_1_1b"]
    if form == "verify":
        x, G, bs = _verify_inputs(cuda, nh, nkv, r2, dc, False, 3, seed=11)
        walk = (x["bt"], x["offs"], x["lengths"])
    else:
        x, G, bs = _decode_inputs(cuda, nh, nkv, r2, dc, False, seed=11)
        walk = _selection(x, bs, 6, 3) if form == "sparse" else (x["bt"], x["lengths"])
    pages = _quantize(x) if q8 else [x["k_e"], x["c_k"], x["c_v"]]
    name = {"decode": "elite_decode_paged", "sparse": "elite_decode_sparse_paged",
            "verify": "elite_verify_paged"}[form]
    entry = name + ("_q8" if q8 else "")
    before = ops.launches()[entry]
    want = getattr(ops, entry)(x["q_e"], x["q_lat"], *pages, *walk, G, dh ** -0.5, bs)
    torch.cuda.synchronize()
    single = ops.launches()[entry] - before
    before = ops.launches()[entry]
    got = getattr(ops, name + "_tp")(x["q_e"], x["q_lat"], *pages[:3],
                                     tuple(pages[3:]) if q8 else None, *walk, G,
                                     dh ** -0.5, bs, TPMesh.on(cuda, tp))
    torch.cuda.synchronize()
    assert single == 1 and ops.launches()[entry] - before == tp * single
    assert got.device == want.device and torch.equal(got, want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["plain", "recompute", "prefix", "int8", "spec", "sampled"])
def test_tp_scheduler_on_card_matches_tp1(name, tp, cuda):
    """``Scheduler(mesh=)`` with every shard on the card against the same
    scheduler at tp 1 (sharded_check's requests): the same streams and
    scheduling, bit for bit, and the attention kernel launched ``tp``
    times per layer and forward, the other kernels as at tp 1."""
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.runtime import sharded_check
    cfg, params, buffers, prompts = sharded_check.tiny_model(cuda)
    runs = {}
    for t in (1, tp):
        ops.reset_launches()
        rep = sharded_check.run_scenario(name, params, buffers, cfg, [TPMesh.on(cuda, t)],
                                         prompts)
        runs[t] = rep, {k: v for k, v in ops.launches().items() if v}
    (one, n1), (got, n) = runs[1], runs[tp]
    assert got["tokens"] == one["tokens"]
    for key in ("completed", "preemptions", "prefill_chunks", "decode_steps"):
        assert got["report"][key] == one["report"][key], key
    attention = {k for k in n1 if k.startswith("elite_")}
    assert attention and n == {k: v * (tp if k in attention else 1) for k, v in n1.items()}
    assert got["report"]["pool_bytes_per_token_per_device"] < \
        one["report"]["pool_bytes_per_token_per_device"]


def test_tp_parity_and_routed_tp2_dp2_on_card(cuda):
    """``sharded_check --parity``'s cases on the card, and ``Router(meshes=)``
    at tp 2 x dp 2 against the same router at tp 1: the same streams."""
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.runtime import sharded_check
    assert all(sharded_check.run_parity(cuda).values())
    cfg, params, buffers, prompts = sharded_check.tiny_model(cuda)
    one, two = (sharded_check.run_scenario("plain", params, buffers, cfg,
                                           [TPMesh.on(cuda, t)] * 2, prompts)
                for t in (1, 2))
    assert two["tokens"] == one["tokens"] and sum(two["report"]["routed"]) == \
        sharded_check.N_REQUESTS


@pytest.mark.parametrize("nh,nkv", [(8, 2), (4, 1), (8, 8)])
def test_sharded_kernel_wrappers_on_card_match_plain(nh, nkv, cuda, monkeypatch):
    """``rope_elite_qk`` (with its backward) and ``flash_prefill`` on
    ``DTensor``s with CUDA local tensors, at each shard's coordinate of a
    1 × 4 mesh of a fake group: each launches its kernel (counted) and
    equals the plain version's piece; kv heads that do not divide the
    shards are replicated and sliced to the shard's."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_group, make_debug_mesh
    tp, B, S, dh, r = 4, 2, 48, 64, 8
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, S, nh, dh, generator=g, device=cuda)
    k = torch.randn(B, S, nkv, dh, generator=g, device=cuda)
    v = torch.randn(B, S, nkv, dh, generator=g, device=cuda)
    freqs = torch.rand(nkv, r, generator=g, device=cuda)
    pos = torch.arange(S, device=cuda)
    G = nh // nkv
    qe, ke = q[..., :2 * r].contiguous(), k[..., :2 * r].contiguous()
    offs = torch.zeros(B, dtype=torch.int32, device=cuda)
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    want_o = ref.flash_prefill_ref(q, k, v, G, dh ** -0.5, offs, lens)
    with fake_group(tp, "cuda"):
        mesh = make_debug_mesh((1, tp), device_type="cuda")
        rep, heads = [Replicate(), Replicate()], [Replicate(), Shard(2)]
        kv_pl = heads if nkv % tp == 0 else rep
        for c in range(tp):
            monkeypatch.setattr(DeviceMesh, "get_coordinate", lambda self, c=c: [0, c])
            piece = lambda t, pl: t.chunk(tp, 2)[c].contiguous() if pl == heads else t
            dt = lambda t, pl: DTensor.from_local(piece(t, pl), mesh, pl, run_check=False,
                                                  shape=t.shape, stride=t.stride())
            qp, kp = qe.clone().requires_grad_(True), ke.clone().requires_grad_(True)
            want_q, want_k = ref.rope_elite_qk_ref(qp, kp, pos, freqs, G, 1)
            wq, wk = torch.randn_like(want_q), torch.randn_like(want_k)
            ((want_q * wq).sum() + (want_k * wk).sum()).backward()
            qd = dt(qe, heads).requires_grad_(True)
            kd = dt(ke, kv_pl).requires_grad_(True)
            ops.reset_launches()
            got_q, got_k = ops.rope_elite_qk(qd, kd, dt(pos, rep), dt(freqs, rep), G, 1)
            ((got_q.to_local() * piece(wq, heads)).sum()
             + (got_k.to_local() * piece(wk, kv_pl)).sum()).backward()
            torch.testing.assert_close(got_q.to_local(), piece(want_q, heads), **ROPE_TOL)
            torch.testing.assert_close(got_k.to_local(), piece(want_k, kv_pl), **ROPE_TOL)
            torch.testing.assert_close(qd.grad.to_local(), piece(qp.grad, heads), **ROPE_TOL)
            torch.testing.assert_close(kd.grad.to_local(), piece(kp.grad, kv_pl), **ROPE_TOL)
            with torch.no_grad():
                o = ops.flash_prefill(dt(q, heads), dt(k, kv_pl), dt(v, kv_pl), G,
                                      dh ** -0.5, dt(offs, rep), dt(lens, rep))
            torch.testing.assert_close(o.to_local(), piece(want_o, heads), **TOL)
            n = ops.launches()
            assert (n["rope_elite"], n["rope_elite_backward"], n["flash_prefill"]) == (1, 1, 1)


@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_contiguous_decode_lse_matches_plain(width, separate, cuda):
    """``return_lse``: the kernel's log-sum-exp against the plain version's
    (-inf exactly where a lane has no row), and o bitwise the call's
    without it."""
    nh, nkv, r2, dc, dh = WIDTHS[width]
    g = torch.Generator(device=cuda).manual_seed(7)
    S = 1152
    lengths = [0, 1, 13, 17, S - 5, S, S + 9]
    B = len(lengths)
    f = lambda *s: torch.randn(s, generator=g, device=cuda)
    q_e, q_lat, k_e, c_k = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc)
    c_v = f(B, S, dc) if separate else c_k
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q_e, q_lat, k_e, c_k, c_v, lens, nh // nkv, dh ** -0.5)
    before = ops.launches()["elite_decode"]
    o, lse = ops.elite_decode(*args, return_lse=True)
    bare = ops.elite_decode(*args)
    want_o, want_lse = ref.elite_decode_ref(*args, return_lse=True)
    torch.cuda.synchronize()
    assert ops.launches()["elite_decode"] == before + 2
    assert torch.equal(o, bare)
    torch.testing.assert_close(o, want_o, **TOL)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    assert bool(torch.isneginf(lse[0]).all()) and bool(torch.isfinite(lse[1:]).all())
    torch.testing.assert_close(lse[1:], want_lse[1:], **TOL)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_decode_pieces_merged_match_one_call(width, cuda):
    """One cache cut into sequence pieces (some past a lane's length),
    each attended by the kernel with its log-sum-exp and merged by
    ``ref.merge_lse``: the kernel's call over the whole cache."""
    nh, nkv, r2, dc, dh = WIDTHS[width]
    g = torch.Generator(device=cuda).manual_seed(8)
    S, P = 2048, 256
    lengths = [0, 1, 255, 256, 700, 1500, S]
    B = len(lengths)
    f = lambda *s: torch.randn(s, generator=g, device=cuda)
    q_e, q_lat, k_e, c = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    G, sc = nh // nkv, dh ** -0.5
    whole = ops.elite_decode(q_e, q_lat, k_e, c, c, lens, G, sc)
    os_, lses = [], []
    for lo in range(0, S, P):
        k_i, c_i = k_e[:, lo:lo + P].contiguous(), c[:, lo:lo + P].contiguous()
        mine = (lens - lo).clamp(0, P).to(torch.int32)
        o, lse = ops.elite_decode(q_e, q_lat, k_i, c_i, c_i, mine, G, sc, return_lse=True)
        os_.append(o)
        lses.append(lse)
    torch.testing.assert_close(ref.merge_lse(os_, lses), whole, **TOL)


@pytest.mark.parametrize("lanes", [4, 1], ids=["seq_over_model", "seq_over_data"])
def test_sequence_sharded_decode_wrapper_on_card(lanes, cuda, monkeypatch):
    """``ops.elite_decode`` on ``DTensor``s with CUDA local tensors and the
    cache sequence sharded, at each coordinate of a 2 × 2 mesh of a fake
    group: one launch each, the all-reduces handed the piece's lse and
    ``[o·w | w]``, and the pieces merged by ``ref.merge_lse`` equal to the
    unsharded plain call."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import fake_group, make_debug_mesh
    nh, nkv, r2, dc, S = 32, 4, 16, 64, 512
    g = torch.Generator(device=cuda).manual_seed(9)
    f = lambda *s: torch.randn(s, generator=g, device=cuda)
    q_e, q_lat, k_e, c = f(lanes, nh, r2), f(lanes, nh, dc), f(lanes, S, nkv, r2), f(lanes, S, dc)
    lens = torch.tensor([512, 300, 256, 5][:lanes] if lanes > 1 else [300],
                        dtype=torch.int32, device=cuda)
    G, sc = nh // nkv, 64 ** -0.5
    want = ref.elite_decode_ref(q_e, q_lat, k_e, c, c, lens, G, sc)
    if lanes > 1:
        q_pl, c_pl, seq_dim = [Shard(0), Replicate()], [Shard(0), Shard(1)], 1
    else:
        q_pl, c_pl, seq_dim = [Replicate(), Shard(1)], [Shard(1), Replicate()], 0
    pieces = {}
    with fake_group(4, "cuda"):
        mesh = make_debug_mesh((2, 2), device_type="cuda")

        def piece(t, pl):
            local = shd.local_shard(t, shd.Sharding(mesh, tuple(pl)))
            return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                      stride=t.stride())
        for coord in [(d, m) for d in range(2) for m in range(2)]:
            monkeypatch.setattr(DeviceMesh, "get_coordinate", lambda self, c=coord: list(c))
            sent = []
            monkeypatch.setattr(ops, "_all_reduce", lambda t, op, mesh, dim: sent.append(
                (op, dim, t)) or t)
            ops.reset_launches()
            ops.elite_decode(piece(q_e, q_pl), piece(q_lat, q_pl), piece(k_e, c_pl),
                             *[piece(c, c_pl)] * 2, piece(lens, [q_pl[0], Replicate()]), G, sc)
            torch.cuda.synchronize()
            assert ops.launches()["elite_decode"] == 1
            assert [(op, dim) for op, dim, _ in sent] == [("max", seq_dim), ("sum", seq_dim)]
            pieces.setdefault(coord[1 - seq_dim], []).append((sent[1][2][..., :-1],
                                                              sent[0][2]))
    for other, got in pieces.items():
        part = want.chunk(2, 0)[other] if lanes > 1 else want.chunk(2, 1)[other]
        torch.testing.assert_close(ref.merge_lse(*zip(*got)), part, **TOL)
