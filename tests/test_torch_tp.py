"""Tensor-parallel paged attention: the head-sharded decode, sparse and
verify wrappers (``kernels/ops.py``), the head-sharded ``PagedKVPool`` and
the paged forwards of ``models/lm.py`` on a ``TPMesh`` of CPU devices.

The port's tensor parallelism is held to the port's own single-device
output bit for bit (every wrapper form, every logits row of the paged
forwards, the pool's gathered bytes after each pool operation), and one
wrapper call at tp 2 per form to the JAX package's single-device XLA path
within 1e-5 (``tests/test_torch_kernels.py``'s tolerance).  The split-KV
plan of a shard is held to the unsharded call's: its ranges, and so its
merge order, come from the unsharded call's kv heads.  Inputs are made with
numpy from a seed; 2 layers, 8 query and 4 kv heads.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.core.cache import PagedKVPool as JaxPool
from repro.kernels import ops as jax_ops

from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import elite_attention as ea
from repro_torch.core import quant
from repro_torch.core.cache import BlockManager, PagedKVPool
from repro_torch.kernels import elite_decode as ed
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import lm

JAX_TOL = dict(atol=1e-5, rtol=1e-5)
LIMIT, SMS = 232448, 132        # an H100's opt-in shared memory per block, its SMs
BS, N_BLOCKS, MB = 4, 32, 10
FORMS = ["decode", "sparse", "verify"]
ENTRY = {"decode": "elite_decode_paged", "sparse": "elite_decode_sparse_paged",
         "verify": "elite_verify_paged"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _mesh(tp):
    return TPMesh.on("cpu", tp)


def _call(form, q8, nkv=4, G=2, r2=8, dc=32, bs=4, mb=6, W=3, separate=False, seed=0):
    """(entry name, its argument tuple) of one call on random pages: lanes
    own disjoint chains, one lane empty; int8 pages quantized by the port's
    quantizer."""
    rng = np.random.default_rng(seed)
    B, nh = 4, nkv * G
    n_slots = (B * mb + 1) * bs
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    lead = (B, W) if form == "verify" else (B,)
    q_e, q_lat = f(*lead, nh, r2), f(*lead, nh, dc)
    k_e, c_k = f(n_slots, nkv, r2), f(n_slots, dc)
    c_v = f(n_slots, dc) if separate else c_k
    bt = torch.from_numpy((1 + rng.permutation(B * mb)).reshape(B, mb).astype(np.int32))
    lengths = torch.tensor([0, 1, 2 * bs + 3, mb * bs], dtype=torch.int32)
    pages = (k_e, c_k, c_v)
    if q8:
        (k, ks), (c, cs) = quant.quantize_rows(k_e), quant.quantize_rows(c_k)
        cv, cvs = (c, cs) if not separate else quant.quantize_rows(c_v)
        pages = (k, c, cv, ks, cs, cvs)
    if form == "decode":
        walk = (bt, lengths)
    elif form == "sparse":
        n_blocks = n_slots // bs
        walk = ref.select_topk_blocks(q_lat, f(n_blocks, dc), f(n_blocks, dc).abs(), bt,
                                      lengths, bs, 3, 1)
    else:
        offs = (lengths - W).clamp(min=0)
        walk = (bt, offs, lengths)
    name = ENTRY[form] + ("_q8" if q8 else "")
    return name, (q_e, q_lat, *pages, *walk, G, 0.3, bs)


def _tp_call(name, args, mesh):
    """``ops.<form>_tp`` on the argument tuple of the single-device entry."""
    q8 = name.endswith("_q8")
    n = 8 if q8 else 5
    scales = tuple(args[5:8]) if q8 else None
    tp_fn = getattr(ops, name.removesuffix("_q8") + "_tp")
    return tp_fn(*args[:5], scales, *args[n:], mesh)


# ---------------------------------------------------------------------------
# (a) the wrappers, bit for bit

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form", FORMS)
def test_tp_wrapper_is_bitwise_single_device(form, q8, tp):
    name, args = _call(form, q8, separate=(form == "decode"))
    want = getattr(ops, name)(*args)
    got = _tp_call(name, args, _mesh(tp))
    assert torch.equal(got, want)
    # the same call on pages already split into head shards (a pool's tuple)
    k_e, h = args[2], args[2].shape[1] // tp
    shards = tuple(k_e[:, r * h:(r + 1) * h].contiguous() for r in range(tp))
    assert torch.equal(_tp_call(name, (*args[:2], shards, *args[3:]), _mesh(tp)), want)
    assert torch.equal(_tp_call(name, args, None), want)      # tp 1: the entry itself


# ---------------------------------------------------------------------------
# (b) tp 2 against the reference's single-device XLA path

@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form", FORMS)
def test_tp2_matches_reference_xla(form, q8):
    name, args = _call(form, q8, seed=1)
    got = _tp_call(name, args, _mesh(2))
    want = getattr(jax_ops, name)(*(jnp.asarray(a.numpy()) for a in args[:-3]),
                                  *args[-3:], force_xla=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


# ---------------------------------------------------------------------------
# (c) a shard's split ranges are the unsharded call's

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_shard_plans_its_ranges_from_the_unsharded_call(monkeypatch, q8, tp):
    """TinyLlama's G = 8 and a verify window of 3 at 2r 32 / d_c 256: the
    kv heads per CTA that fit give 2 head groups at nkv 4 but 1 at nkv 2 or
    1, which would halve a shard's tiles per split (4 → 2 on 132 SMs).  Each
    shard's call must be planned with ``split_nkv`` = the unsharded nkv,
    and its split-and-merge arithmetic (``ref.split_call_ref`` by that plan)
    must then give the unsharded split call's bits."""
    name, args = _call("verify", q8, nkv=4, G=8, r2=32, dc=256, bs=16, mb=8, seed=2)
    full = ed.plan_for(name, args, SMS, LIMIT)
    assert full.groups == 2 and full.tiles_per_split == 4
    calls = []

    def shard_entry(*a, split_nkv=0):
        p = ed.plan_for(name, a, SMS, LIMIT, split_nkv=split_nkv)
        own = ed.plan_for(name, a, SMS, LIMIT)
        calls.append((split_nkv, p.tiles_per_split, own.tiles_per_split))
        return ref.split_call_ref(name, a, p.tiles_per_split)

    monkeypatch.setattr(ops, name, shard_entry)
    got = _tp_call(name, args, _mesh(tp))
    assert calls == [(4, 4, 2)] * tp          # own plan: 2 tiles per split
    want = ref.split_call_ref(name, args, full.tiles_per_split)
    assert torch.equal(got, want)
    cut = ref.split_call_ref(name, args, calls[0][2])      # the shard's own ranges
    assert not torch.equal(cut, want)


# ---------------------------------------------------------------------------
# (d) the head-sharded pool through every pool operation

def _cfg(lrd="joint"):
    kw = dict(enabled=True, elite_r=4, d_ckv=64, lrd=lrd, d_ck=24, d_cv=40)
    return dataclasses.replace(
        get_config("tinyllama_1_1b").reduced(num_layers=2, n_heads=8, n_kv_heads=4),
        elitekv=EliteKVConfig(**kw))


def _write(pool, cfg, seq, start, n, seed):
    """Scatter seeded random streams of ``n`` tokens of ``seq`` from
    ``start`` into every layer, as the forwards do."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    slots = torch.from_numpy(pool.prefill_slot_mapping(seq, start, n, n))
    writes = ea.write_index(slots, pool.oob_slot, torch.device("cpu"))
    e = cfg.elitekv
    for i in range(cfg.num_layers):
        c_k = f(n, e.d_ckv if e.lrd == "joint" else e.d_ck)
        c_v = c_k if e.lrd == "joint" else f(n, e.d_cv)
        ea._scatter_pages(lm._layer_pages(pool.pages, cfg, i),
                          f(n, cfg.n_kv_heads, 2 * e.elite_r), c_k, c_v, writes)


def _gathered(pool):
    """The pool's leaves as a tp-1 pool holds them: a split ``k_e``'s
    shards concatenated in shard order, a replicated leaf's first copy."""
    return {name: (leaf if torch.is_tensor(leaf) else
                   torch.cat(leaf, 2) if name == "k_e" else leaf[0])
            for name, leaf in pool.pages["p0"].items()}


def _pool_story(cfg, dtype, mesh):
    """Chains, a registered prefix shared by a second chain, truncate,
    copy-on-write, swap-out/in and reset on one pool; the pool's gathered
    pages after each step, and the swapped host copy."""
    pool = PagedKVPool(cfg, 16, BS, device="cpu", dtype=dtype, block_summaries=True,
                       mesh=mesh)
    bm = BlockManager(pool, prefix_cache=True)
    snaps = []
    snap = lambda: snaps.append({k: v.clone() for k, v in _gathered(pool).items()})
    prompt = list(range(10))
    pool.ensure_capacity(0, 10)
    _write(pool, cfg, 0, 0, 10, 1)
    bm.register_prefix(0, prompt)
    snap()
    assert bm.lookup_prefix(1, prompt + [7, 7]) == 8            # two shared blocks
    pool.truncate(1, 6)
    bm.prepare_write(1, 6, 12)                                  # copy-on-write
    pool.ensure_capacity(1, 12)
    _write(pool, cfg, 1, 6, 6, 2)
    assert pool.cow_copies == 1
    snap()
    swapped = bm.preempt_swap_out(0, 10)
    bm.swap_in(2, swapped)
    _write(pool, cfg, 2, 10, 2, 3)
    snap()
    pool.reset()
    pool.ensure_capacity(3, 7)
    _write(pool, cfg, 3, 0, 7, 4)
    snap()
    return snaps, swapped.host.clone(), pool


@pytest.mark.parametrize("lrd", ["joint", "separate"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_pool_operations_match_tp1(dtype, lrd):
    cfg = _cfg(lrd)
    want, host, _ = _pool_story(cfg, dtype, None)
    got, got_host, pool = _pool_story(cfg, dtype, _mesh(2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            assert torch.equal(g[name], w[name]), name
    assert torch.equal(got_host, host)           # the same bytes in host memory
    k_e = pool.pages["p0"]["k_e"]
    assert len(k_e) == 2 and k_e[0].shape == (2, 16 * BS, 2, 8) and k_e[0] is not k_e[1]
    for name, leaf in pool.pages["p0"].items():
        if name != "k_e":
            assert leaf[0] is leaf[1], name      # one replica per distinct device


# ---------------------------------------------------------------------------
# (e) bytes per token on each device

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_bytes_per_token_per_device_follows_reference_formula(dtype):
    cfg = _cfg()
    jcfg = dataclasses.replace(jax_get_config("tinyllama_1_1b").reduced(
        num_layers=2, n_heads=8, n_kv_heads=4), elitekv=JaxEliteKV(
            enabled=True, elite_r=4, d_ckv=64))
    jpool = JaxPool(jcfg, 8, BS, dtype="int8" if dtype == "int8" else np.float32,
                    block_summaries=True)
    n_slots = 8 * BS
    per = {}
    for tp in (1, 2, 4):
        pool = PagedKVPool(cfg, 8, BS, device="cpu", dtype=dtype, block_summaries=True,
                           mesh=_mesh(tp))
        want = sum(a.nbytes // (tp if name == "k_e" else 1) // n_slots
                   for name, a in jpool.pages["p0"].items())
        per[tp] = pool.bytes_per_token_per_device()
        assert per[tp] == want
        assert pool.bytes_per_token() == jpool.bytes_per_token()
    assert per[1] == jpool.bytes_per_token_per_device()
    assert per[1] > per[2] > per[4] > per[1] // 4           # shrinks, not as 1/tp


# ---------------------------------------------------------------------------
# (f) the paged forwards, every logits row bitwise equal to tp 1

@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    params, buffers = lm.init(cfg, seed=0, device="cpu")
    return cfg, params, buffers


def _serve(model, dtype, mesh):
    """Every logits row of: a fresh prefill of two prompts (one padded), a
    resumed chunk of both, 8 dense decode steps, a verify window of 3, and
    on a pool with block summaries a prefill and 2 sparse decode steps."""
    cfg, params, buffers = model
    rng = np.random.default_rng(5)
    out = []
    tok = lambda *s: torch.from_numpy(rng.integers(0, cfg.vocab_size, s))

    def prefill(pool, lanes):
        S = max(lanes)
        for sid, n in enumerate(lanes):
            pool.ensure_capacity(sid, n)
        sm = np.stack([pool.prefill_slot_mapping(sid, 0, n, S) for sid, n in enumerate(lanes)])
        out.append(lm.apply_prefill_paged(params, buffers, cfg, tok(len(lanes), S),
                                          pool.pages, torch.from_numpy(sm), mesh=mesh))

    def decode(pool, **kw):
        lengths = np.asarray([pool.length(s) + 1 for s in (0, 1)], np.int32)
        for s in (0, 1):
            pool.ensure_capacity(s, int(lengths[s]))
        sm = pool.slot_mapping([0, 1], (lengths - 1).tolist())
        out.append(lm.apply_decode_paged(params, buffers, cfg, tok(2, 1), pool.pages,
                                         torch.from_numpy(sm),
                                         pool.block_table_array([0, 1], MB), lengths, BS,
                                         mesh=mesh, **kw))

    pool = PagedKVPool(cfg, N_BLOCKS, BS, device="cpu", dtype=dtype, mesh=mesh)
    prefill(pool, [12, 9])
    starts, n_chunk, C = [12, 9], [4, 3], 4
    sm = np.full((2, C), pool.oob_slot, np.int32)
    for sid, (st, n) in enumerate(zip(starts, n_chunk)):
        pool.ensure_capacity(sid, st + n)
        sm[sid] = pool.prefill_slot_mapping(sid, st, n, C)
    cs = np.asarray(starts, np.int32)
    out.append(lm.apply_prefill_paged(params, buffers, cfg, tok(2, C), pool.pages,
                                      torch.from_numpy(sm), chunk_start=cs,
                                      block_tables=pool.block_table_array([0, 1], MB),
                                      prefix_lens=cs, block_size=BS, mesh=mesh))
    for _ in range(8):
        decode(pool)
    W = 3
    offs = np.asarray([pool.length(s) for s in (0, 1)], np.int32)
    for s in (0, 1):
        pool.ensure_capacity(s, int(offs[s]) + W)
    sm = np.stack([pool.prefill_slot_mapping(s, int(offs[s]), W, W) for s in (0, 1)])
    out.append(lm.apply_verify_paged(params, buffers, cfg, tok(2, W), pool.pages,
                                     torch.from_numpy(sm), pool.block_table_array([0, 1], MB),
                                     offs, offs + W, BS, mesh=mesh))
    sparse = PagedKVPool(cfg, N_BLOCKS, BS, device="cpu", dtype=dtype, block_summaries=True,
                         mesh=mesh)
    prefill(sparse, [20, 14])
    for _ in range(2):
        decode(sparse, sparse_topk=1, sparse_recent=1)
    return out, pool


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_forwards_bitwise_equal_tp1(model, dtype, tp):
    want, pool1 = _serve(model, dtype, None)
    got, pool = _serve(model, dtype, _mesh(tp))
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"forward {i}: max |diff| {float((g - w).abs().max())}"
    for name, w in pool1.pages["p0"].items():
        assert torch.equal(_gathered(pool)[name], w), name


# ---------------------------------------------------------------------------
# (g) refusals

def test_tp_that_does_not_divide_kv_heads_raises(model):
    cfg, params, buffers = model
    with pytest.raises(ValueError, match="pad_cfg_for_tp"):
        PagedKVPool(cfg, 8, BS, device="cpu", mesh=_mesh(3))
    name, args = _call("decode", False)
    with pytest.raises(ValueError, match="pad_cfg_for_tp"):
        _tp_call(name, args, _mesh(3))
    pool = PagedKVPool(cfg, 8, BS, device="cpu", mesh=_mesh(2))
    with pytest.raises(ValueError, match="2 head shard"):
        lm.apply_prefill_paged(params, buffers, cfg, torch.zeros(1, 4, dtype=torch.int64),
                               pool.pages, torch.zeros(1, 4, dtype=torch.int32))


def test_tp_mesh_and_the_serving_refusal():
    m = TPMesh(("cpu", torch.device("cpu")))
    assert m.tp == 2 and m.devices == (torch.device("cpu"),) * 2
    assert m.distinct() == (torch.device("cpu"),)
    assert TPMesh.on("cuda:0", 4).devices == (torch.device("cuda", 0),) * 4
    with pytest.raises(ValueError):
        TPMesh(())
    assert mesh_lib.serving_devices(tp=2, device="cpu") == [[torch.device("cpu")] * 2]
    assert mesh_lib.replica_meshes(tp=4, device="cpu") == [TPMesh.on("cpu", 4)]
