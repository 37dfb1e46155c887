"""The split-KV plan of the decode and verify kernels, and its arithmetic.

``elite_decode.plan_for`` is the host plan the kernels launch by (kv heads
per CTA, tiles in flight, splits of the walk); ``ref.split_call_ref`` cuts a
call by that plan into partials (m, l, acc) and merges them in the kernel's
order.  Here, on the CPU, the split-and-merge is held to the unsplit plain
versions within 2e-6 (f32; one softmax against a max-rescaled sum of a few
partials), the plan to the three bitwise identities the card checks, and
one case of each to the JAX package's Pallas kernels in interpret mode
(1e-5, as ``tests/test_torch_kernels.py``).  Inputs are made with numpy from
a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import elite_decode as jax_ed

from repro_torch.core import quant
from repro_torch.kernels import elite_decode as ed
from repro_torch.kernels import ref

TOL = dict(atol=2e-6, rtol=2e-6)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)
LIMIT = 232448           # an H100's opt-in shared memory per block
SMS = 132


def _pool(seed, B, nkv, G, r2, dc, bs, mb, separate, window=0):
    """Random pages and per-lane disjoint random chains of mb blocks."""
    rng = np.random.default_rng(seed)
    nh, n_blocks = nkv * G, B * mb + 1
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    lead = (B, window) if window else (B,)
    x = dict(q_e=f(*lead, nh, r2), q_lat=f(*lead, nh, dc), k_e=f(n_blocks * bs, nkv, r2),
             c_k=f(n_blocks * bs, dc))
    x["c_v"] = f(n_blocks * bs, dc) if separate else x["c_k"]
    perm = 1 + rng.permutation(n_blocks - 1)
    x["bt"] = torch.from_numpy(perm[:B * mb].reshape(B, mb).astype(np.int32))
    return x


def _lengths(span, S):
    """Lengths 0, 1, 15, 16, 17, a split boundary ±1 and S (the table)."""
    return torch.tensor([0, 1, 15, 16, 17, span - 1, span, span + 1, S], dtype=torch.int32)


@pytest.mark.parametrize("sms", [4, 16, 132])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
def test_split_paged_decode_matches_unsplit(separate, sms):
    nkv, G, r2, dc, bs, mb = 2, 4, 8, 32, 16, 6
    B = 9
    tps = ed.split_plan(1, mb, sms, 32)[1]
    x = _pool(0, B, nkv, G, r2, dc, bs, mb, separate)
    lengths = _lengths(tps * bs, mb * bs)
    args = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"], x["bt"], lengths, G, 0.3, bs)
    got = ref.split_call_ref("elite_decode_paged", args, tps)
    torch.testing.assert_close(got, ref.elite_decode_paged_ref(*args), **TOL)
    assert float(got[0].abs().max()) == 0.0          # empty lane: exact zeros


@pytest.mark.parametrize("tps", [1, 2, 5])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
def test_split_contiguous_decode_matches_unsplit(separate, tps):
    rng = np.random.default_rng(1)
    nkv, G, r2, dc, S = 2, 2, 8, 32, 100              # S not a multiple of the tile
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    lengths = torch.cat([_lengths(tps * 16, S), torch.tensor([S + 9], dtype=torch.int32)])
    B = len(lengths)
    c_k = f(B, S, dc)
    args = (f(B, nkv * G, r2), f(B, nkv * G, dc), f(B, S, nkv, r2), c_k,
            f(B, S, dc) if separate else c_k, lengths, G, 0.25)
    got = ref.split_call_ref("elite_decode", args, tps)
    torch.testing.assert_close(got, ref.elite_decode_ref(*args), **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("tps", [1, 2, 4])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_split_verify_matches_unsplit(W, tps):
    nkv, G, r2, dc, bs, mb = 2, 2, 8, 32, 8, 8
    span = tps * bs
    # (q_offset, tokens): dead lane, at 0, across a block and a split
    # boundary, a short window, one ending the table
    windows = [(0, 0), (0, W), (bs - 2, W), (span - 1, W), (span, max(1, W - 2)),
               (mb * bs - W, W)]
    B = len(windows)
    x = _pool(2, B, nkv, G, r2, dc, bs, mb, True, window=W)
    offs = torch.tensor([o for o, _ in windows], dtype=torch.int32)
    lens = torch.tensor([o + n if n else 0 for o, n in windows], dtype=torch.int32)
    args = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"], x["bt"], offs, lens, G,
            0.3, bs)
    got = ref.split_call_ref("elite_verify_paged", args, tps)
    torch.testing.assert_close(got, ref.elite_verify_paged_ref(*args), **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_split_sparse_decode_matches_unsplit(q8):
    nkv, G, r2, dc, bs, mb = 1, 4, 8, 16, 4, 10
    x = _pool(3, 5, nkv, G, r2, dc, bs, mb, False)
    lengths = torch.tensor([0, 1, 17, 40, 23], dtype=torch.int32)
    # ascending picks with count-0 padding and trailing zero-count entries
    st = torch.zeros(5, 6, dtype=torch.int32)
    ct = torch.zeros_like(st)
    for b, L in enumerate(lengths.tolist()):
        n = -(-L // bs)
        pick = torch.arange(n)[torch.arange(n) % 2 == 0][:4]
        st[b, :len(pick)] = x["bt"][b, pick]
        ct[b, :len(pick)] = (L - pick * bs).clamp(0, bs).int()
    pages = [x["k_e"], x["c_k"], x["c_v"]]
    if q8:
        (k, ks), (c, cs) = quant.quantize_rows(x["k_e"]), quant.quantize_rows(x["c_k"])
        pages = [k, c, c, ks, cs, cs]
    name = "elite_decode_sparse_paged" + ("_q8" if q8 else "")
    args = (x["q_e"], x["q_lat"], *pages, st, ct, G, 0.3, bs)
    for tps in (1, 2, 6):
        got = ref.split_call_ref(name, args, tps)
        torch.testing.assert_close(got, getattr(ref, name + "_ref")(*args), **TOL)
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("entry", ["paged", "sparse"])
def test_trailing_empty_splits_keep_the_bits(entry):
    """Widening the walk with entries that visit nothing (zero table columns
    past every chain, zero-count selection entries) adds only empty
    partials: the merge gives the same bits."""
    nkv, G, r2, dc, bs, mb = 2, 2, 8, 16, 4, 5
    x = _pool(4, 4, nkv, G, r2, dc, bs, mb, True)
    lengths = torch.tensor([0, 3, 9, 20], dtype=torch.int32)
    if entry == "paged":
        walk = (x["bt"], lengths)
        wide = (torch.cat([x["bt"], torch.zeros(4, 7, dtype=torch.int32)], 1), lengths)
        name = "elite_decode_paged"
    else:
        counts = (lengths[:, None] - torch.arange(mb)[None] * bs).clamp(0, bs).int()
        walk = (x["bt"], counts)
        wide = (torch.cat([x["bt"], torch.zeros(4, 7, dtype=torch.int32)], 1),
                torch.cat([counts, torch.zeros(4, 7, dtype=torch.int32)], 1))
        name = "elite_decode_sparse_paged"
    pages = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_v"])
    for tps in (1, 2):
        a = ref.split_call_ref(name, (*pages, *walk, G, 0.3, bs), tps)
        b = ref.split_call_ref(name, (*pages, *wide, G, 0.3, bs), tps)
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", ["tinyllama_1_1b", "llama2_7b"])
@pytest.mark.parametrize("separate", [False, True], ids=["jlrd", "slrd"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_plan_is_shared_by_each_identity(width, separate, q8):
    """Contiguous vs identity-table pages, verify W=1 vs decode, full-width
    selection vs chain: each pair gets one plan (heads per CTA, stages,
    splits, tiles per split), so each pair can give the same bits."""
    nh, nkv, r2, dc = {"tinyllama_1_1b": (32, 4, 16, 64),
                       "llama2_7b": (32, 32, 32, 1024)}[width]
    G, bs, B, S = nh // nkv, 16, 8, 1152
    mb = S // bs
    e = lambda *s: torch.empty(s)
    q_e, q_lat = e(B, nh, r2), e(B, nh, dc)
    ck = e(B * S, dc)
    cv = e(B * S, dc) if separate else ck
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    if q8:
        pages = (torch.empty(B * S, nkv, r2, dtype=torch.int8),
                 torch.empty(B * S, dc, dtype=torch.int8))
        cv8 = torch.empty(B * S, dc, dtype=torch.int8) if separate else pages[1]
        s_k, s_c = e(B * S), e(B * S)
        pages = (*pages, cv8, s_k, s_c, e(B * S) if separate else s_c)
    else:
        pages = (e(B * S, nkv, r2), ck, cv)
    sfx = "_q8" if q8 else ""
    dense = ed.plan_for("elite_decode_paged" + sfx,
                        (q_e, q_lat, *pages, i32(B, mb), i32(B), G, 0.1, bs), SMS, LIMIT)
    one = ed.plan_for("elite_verify_paged" + sfx,
                      (q_e[:, None], q_lat[:, None], *pages, i32(B, mb), i32(B), i32(B), G,
                       0.1, bs), SMS, LIMIT)
    sparse = ed.plan_for("elite_decode_sparse_paged" + sfx,
                         (q_e, q_lat, *pages, i32(B, mb), i32(B, mb), G, 0.1, bs), SMS,
                         LIMIT)
    assert one == dense and sparse == dense
    if not q8:
        kc = e(B, S, dc)
        contig = ed.plan_for("elite_decode", (q_e, q_lat, e(B, S, nkv, r2), kc,
                                              e(B, S, dc) if separate else kc, i32(B), G,
                                              0.1), SMS, LIMIT)
        assert contig == dense
    assert dense.smem <= LIMIT


@pytest.mark.parametrize("B,groups,n_tiles,ctas,cap", [
    (8, 1, 72, 264, 64), (8, 1, 6, 264, 64), (1, 1, 1, 264, 64), (3, 4, 64, 132, 64),
    (64, 8, 64, 264, 64), (8, 16, 72, 264, 1024), (2, 1, 1000, 4, 64), (1, 1, 500, 264, 16)])
def test_split_plan_covers_the_walk(B, groups, n_tiles, ctas, cap):
    """Every tile lies in exactly one split, no split is empty by
    construction, there are at most ``cap`` splits, and the reference load
    gets the CTAs asked for, or one split per tile.  Tiles per split do not
    depend on the batch or on the walk's width up to ``tiles per split ·
    cap`` tiles, so a lane's ranges are the same whatever the other lanes'
    lengths: a wider walk only adds trailing ranges."""
    splits, tps = ed.split_plan(groups, n_tiles, ctas, cap)
    assert splits * tps >= n_tiles > (splits - 1) * tps
    assert splits <= cap
    base = ed.split_plan(groups, 1, ctas, cap)[1]
    if n_tiles <= base * cap:
        assert tps == base
        for other in (1, n_tiles // 2 + 1, base * cap):
            assert ed.split_plan(groups, other, ctas, cap)[1] == tps
    else:
        assert tps == -(-n_tiles // cap)
    ref_splits = -(-ed.REF_TILES // base)
    ref_lanes = ed.REF_LANES * groups
    assert ref_lanes * ref_splits >= min(ctas, ref_lanes * min(cap, ed.REF_TILES)) // 2
    # the plan of a call: the same ranges for B lanes and for one
    one, many = (ed.plan(b, 1, 8, 4, 16, 16, 64, True, False, n_tiles, SMS, LIMIT)
                 for b in (1, B))
    assert one.tiles_per_split == many.tiles_per_split
    assert many.ctas == B * one.ctas


def test_plan_sizes_heads_by_shared_memory_and_refuses_one_head():
    """TinyLlama holds all 4 kv heads (32 query rows at decode, 160 at
    W = 5) in one CTA; LLaMA2-7B widths take smaller groups, and S-LRD falls
    back to one stage; a row too wide for one kv head raises."""
    tiny = ed.plan(8, 1, 8, 4, 16, 16, 64, True, False, 72, SMS, LIMIT)
    assert (tiny.heads, tiny.groups, tiny.stages) == (4, 1, 2)
    assert tiny.ctas >= 2 * SMS * 2 // 3               # two CTAs per SM fit
    verify = ed.plan(8, 5, 8, 4, 16, 16, 64, True, False, 72, SMS, LIMIT)
    assert verify.heads == 4 and LIMIT // 2 < verify.smem <= LIMIT   # one per SM fits
    # ranges are sized by head groups and the card, not by a CTA's rows
    assert verify.tiles_per_split == tiny.tiles_per_split
    big = ed.plan(8, 1, 1, 32, 16, 32, 1024, True, False, 72, SMS, LIMIT)
    assert 1 <= big.heads < 32 and big.smem <= LIMIT and big.stages == 2
    assert ed.plan(8, 1, 1, 32, 16, 32, 1024, False, False, 72, SMS, LIMIT).stages == 1
    with pytest.raises(ValueError, match="opt-in limit"):
        ed.plan(1, 5, 4, 1, 16, 32, 4096, True, False, 1, SMS, LIMIT)
    with pytest.raises(ValueError, match="multiples of 4"):
        ed.plan_for("elite_decode_paged", (torch.empty(1, 2, 6), torch.empty(1, 2, 8),
                                           torch.empty(4, 1, 6), torch.empty(4, 8),
                                           torch.empty(4, 8), torch.zeros(1, 1), None,
                                           2, 0.1, 4), SMS, LIMIT)


def test_split_contiguous_decode_matches_pallas():
    rng = np.random.default_rng(5)
    nkv, G, r2, dc, S = 2, 2, 8, 32, 40
    lengths = np.asarray([0, 1, 15, 16, 17, 33, S, S + 3], np.int32)
    B, nh = len(lengths), nkv * G
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q_e, q_lat, k_e, c_k, c_v = f(B, nh, r2), f(B, nh, dc), f(B, S, nkv, r2), f(B, S, dc), \
        f(B, S, dc)
    want = np.asarray(jax_ed.elite_decode(
        *(jnp.asarray(a) for a in (q_e, q_lat, k_e, c_k, c_v, lengths)), G, 0.3,
        block_s=S, interpret=True))
    t = [torch.from_numpy(a) for a in (q_e, q_lat, k_e, c_k, c_v, lengths)]
    got = ref.split_call_ref("elite_decode", (*t, G, 0.3), 1)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_split_verify_matches_pallas():
    nkv, G, r2, dc, bs, mb, W = 1, 4, 8, 32, 4, 5, 3
    x = _pool(6, 4, nkv, G, r2, dc, bs, mb, False, window=W)
    offs = np.asarray([0, 0, 5, 17], np.int32)
    lens = np.asarray([0, 3, 8, 20], np.int32)
    arrays = [x[k].numpy() for k in ("q_e", "q_lat", "k_e", "c_k", "c_v", "bt")] + [offs, lens]
    want = np.asarray(jax_ed.elite_verify_paged(*map(jnp.asarray, arrays), G, 0.3, bs,
                                                interpret=True))
    args = (x["q_e"], x["q_lat"], x["k_e"], x["c_k"], x["c_k"], x["bt"],
            torch.from_numpy(offs), torch.from_numpy(lens), G, 0.3, bs)
    got = ref.split_call_ref("elite_verify_paged", args, 2)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)
    assert float(got[0].abs().max()) == 0.0


def _cut_widths():
    """(arch, ratio, lrd, G, nkv, 2r, d_c) of every architecture with
    attention layers at ratios 0.5, 0.25 and 0.125 (``pick_dims``), J-LRD
    (d_c = d_ckv) and S-LRD (two streams of d_ckv / 2)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.convert import pick_dims
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.n_attn_layers:
            continue
        for ratio in (0.5, 0.25, 0.125):
            e = pick_dims(cfg, ratio)
            for sep in (False, True):
                out.append((arch, ratio, "S" if sep else "J", cfg.q_group, cfg.n_kv_heads,
                            2 * e.elite_r, e.d_ckv // (2 if sep else 1)))
    return out


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "llama2_7b", "llama2_13b", "yi_6b",
                                  "granite_3_2b", "minicpm_2b", "qwen3_moe_235b",
                                  "jamba_v0_1_52b", "arctic_480b", "internvl2_2b",
                                  "musicgen_large"])
def test_window_cut_only_where_one_head_does_not_fit(arch):
    """Every decode and verify width of the architectures with attention
    (dense, MoE: G = 16 and 7, Jamba's attention layers, and the InternVL2
    and MusicGen backbones) plans
    (W = 1, 3, 5, 9, f32 and int8): the window is cut only where one kv
    head's rows of the whole window do not fit, into the fewest parts that
    do, and the cut leaves the ranges as ``split_plan`` gives them for the
    plan's head groups.  A forced cut of a call that fits keeps its heads,
    stages and ranges, so the card can hold its bits to the uncut call's.
    LLaMA2-13B at half cache cuts f32 at W = 5 and int8 at W = 3."""
    cuts = set()
    for (a, ratio, lrd, G, nkv, r2, dc) in _cut_widths():
        if a != arch:
            continue
        shared = lrd == "J"
        for q8 in (False, True):
            for W in (1, 3, 5, 9):
                p = ed.plan(8, W, G, nkv, 16, r2, dc, shared, q8, 72, SMS, LIMIT)
                whole = ed.head_group(W, G, nkv, 16, r2, dc, shared, q8, LIMIT)
                assert p.smem <= LIMIT
                assert (p.splits, p.tiles_per_split) == ed.split_plan(
                    p.groups, 72, ed.CTAS_PER_SM * SMS, dc)
                assert p.ctas == 8 * p.groups * p.parts * p.splits
                if whole is not None:
                    assert (p.part, p.parts) == (W, 1)
                    assert (p.heads, p.stages, p.smem) == whole
                    if W > 1:
                        f = ed.plan(8, W, G, nkv, 16, r2, dc, shared, q8, 72, SMS, LIMIT,
                                    part=1)
                        assert (f.heads, f.stages, f.splits, f.tiles_per_split) == \
                            (p.heads, p.stages, p.splits, p.tiles_per_split)
                        assert (f.part, f.parts) == (1, W) and f.smem <= p.smem
                    continue
                cuts.add((ratio, lrd, q8, W))
                assert W > 1 and p.parts == -(-W // p.part) > 1
                assert ed.head_group(p.part, G, nkv, 16, r2, dc, shared, q8, LIMIT) == \
                    (p.heads, p.stages, p.smem)
                # the next larger part size does not fit
                bigger = [-(-W // n) for n in range(1, p.parts) if -(-W // n) > p.part]
                assert all(ed.head_group(s, G, nkv, 16, r2, dc, shared, q8, LIMIT) is None
                           for s in bigger)
    if arch == "llama2_13b":
        assert {(0.5, "J", False, 5), (0.5, "J", True, 3), (0.5, "S", True, 3)} <= cuts
    if arch in ("tinyllama_1_1b", "yi_6b", "granite_3_2b", "minicpm_2b"):
        assert not cuts


def test_window_of_one_position_too_wide_raises_naming_the_window():
    """Only a window of which one position of one kv head does not fit is
    refused, and the message names the window."""
    with pytest.raises(ValueError, match="window of 5 positions.*opt-in limit"):
        ed.plan(1, 5, 4, 1, 16, 32, 4096, True, False, 1, SMS, LIMIT, "elite_verify_paged")


@pytest.mark.parametrize("part", [1, 2, 3])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_cut_window_arithmetic_matches_uncut(part, q8):
    """A window cut into parts of ``part`` positions, each scored on its
    own with shifted offsets (``ref.split_call_ref(part=...)``), gives the
    uncut split-and-merge row for row within 2e-6, and the unsplit plain
    version's rows likewise; a dead lane stays exact zeros."""
    nkv, G, r2, dc, bs, mb, W = 2, 2, 8, 32, 4, 6, 5
    x = _pool(13 + part, 5, nkv, G, r2, dc, bs, mb, True, window=W)
    offs = torch.tensor([0, 0, 4, 11, 19], dtype=torch.int32)
    lens = torch.tensor([0, 3, 9, 16, 24], dtype=torch.int32)
    pages = (x["k_e"], x["c_k"], x["c_v"])
    name = "elite_verify_paged"
    if q8:
        (k, ks), (ck, cks), (cv, cvs) = (quant.quantize_rows(t) for t in pages)
        pages = (k, ck, cv, ks, cks, cvs)
        name += "_q8"
    args = (x["q_e"], x["q_lat"], *pages, x["bt"], offs, lens, G, 0.3, bs)
    plain = getattr(ref, name + "_ref")(*args)
    for tps in (1, 2):
        whole = ref.split_call_ref(name, args, tps)
        cut = ref.split_call_ref(name, args, tps, part=part)
        torch.testing.assert_close(cut, whole, **TOL)
        torch.testing.assert_close(cut, plain, **TOL)
        assert float(cut[0].abs().max()) == 0.0
