"""The port's rotation of q and k in one call, held to the JAX package.

* ``ref.rope_elite_qk_ref``, the plain version of the ``rope_elite`` kernel's
  q-and-k entry, equals the JAX Pallas ``rope_elite`` (interpret mode) called
  once for q, with each frequency row repeated for the query heads that read
  it, and once for k: the EliteKV grouping (q_group 4 and 8, r 4 and 8) and
  the full RoPE (dh 32), positions [S] and [B, S], q as a strided slice of a
  wider projection.  Tolerance 1e-5 absolute and relative in f32, as in
  ``tests/test_torch_contiguous.py``: the same math, with cos/sin of two
  libraries that may differ in the last ulp.
* The pair's plain version gives the bits of two single-tensor calls.
* Every forward of every path, EliteKV and baseline, lockstep and paged,
  rotates through exactly one ``ops.rope_elite_qk`` call per layer, and
  never through the single-tensor ``ops.rope_elite``.
* The kernel's host plan (``kernels/rope_elite.py``): 16-byte accesses for
  the q_e slice and contiguous k, 8-byte ones for a slice that starts 8 bytes
  into a row, a refusal below that; at most ``MAX_VECTORS`` heads per thread
  and ``MAX_THREADS`` threads per CTA at both model widths.

Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rope_elite as jax_re

from repro_torch.configs import get_config
from repro_torch.core import rope
from repro_torch.core.cache import PagedKVPool
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rope_elite as re_k
from repro_torch.models import lm
from repro_torch.runtime import serve_loop

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


# (frequency rows, query heads per row, key heads per row, r, full RoPE)
CASES = {"elite_G4_r4": (2, 4, 1, 4, False), "elite_G8_r8": (2, 8, 1, 8, False),
         "full_dh32": (1, 4, 2, 16, True)}


def _pair_case(case, per_lane, strided, seed=0, B=2, S=8):
    rows, qpr, kpr, r, full = CASES[case]
    rng = np.random.default_rng(seed)
    q_wide = rng.standard_normal((B, S, rows * qpr, 2 * r + (24 if strided else 0)))
    k = rng.standard_normal((B, S, rows * kpr, 2 * r))
    if full:
        freqs = rope.chunk_freqs(2 * r, 10000.0, device="cpu").numpy()[None]
    else:
        # chunk 0 of a row runs at frequency 1.0, so angles reach ~4000 rad
        freqs = np.exp(-rng.uniform(0, 4, (rows, r)))
        freqs[:, 0] = 1.0
    pos = rng.integers(0, 4096, (B, S) if per_lane else (S,)).astype(np.int32)
    return (q_wide.astype(np.float32), k.astype(np.float32), pos,
            freqs.astype(np.float32), qpr, kpr, r)


def _pallas(x, pos, freqs):
    """The JAX Pallas kernel in interpret mode; per-lane positions one lane
    at a time (its contract takes positions [S])."""
    if pos.ndim == 1:
        return np.asarray(jax_re.rope_elite(jnp.asarray(x), jnp.asarray(pos),
                                            jnp.asarray(freqs), interpret=True))
    return np.concatenate([_pallas(x[b:b + 1], pos[b], freqs) for b in range(len(pos))])


@pytest.mark.parametrize("strided", [False, True], ids=["q_contiguous", "q_slice"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
@pytest.mark.parametrize("case", list(CASES))
def test_pair_plain_version_matches_pallas(case, per_lane, strided):
    q_wide, k, pos, freqs, qpr, kpr, r = _pair_case(case, per_lane, strided)
    q = q_wide[..., :2 * r]
    want_q = _pallas(q, pos, np.repeat(freqs, qpr, axis=0))
    want_k = _pallas(k, pos, np.repeat(freqs, kpr, axis=0))
    tq = _t(q_wide)[..., :2 * r]
    assert tq.is_contiguous() == (not strided)
    got_q, got_k = ops.rope_elite_qk(tq, _t(k), _t(pos), _t(freqs), qpr, kpr)
    assert got_q.is_contiguous() and got_k.is_contiguous()
    np.testing.assert_allclose(got_q.numpy(), want_q, **TOL)
    np.testing.assert_allclose(got_k.numpy(), want_k, **TOL)
    assert ops.launches()["rope_elite"] == 0          # the CPU runs the plain math


@pytest.mark.parametrize("per_lane", [False, True], ids=["pos_S", "pos_BS"])
@pytest.mark.parametrize("case", list(CASES))
def test_pair_plain_version_is_two_single_calls(case, per_lane):
    """Bit for bit: the pair's plain version against the single-tensor one
    on q (rows expanded to the query heads, or for the full RoPE one row
    broadcast with head stride 0, as the full RoPE was rotated before) and
    on k."""
    q_wide, k, pos, freqs, qpr, kpr, r = _pair_case(case, per_lane, True, seed=1)
    q, k, pos, f = _t(q_wide)[..., :2 * r], _t(k), _t(pos), _t(freqs)
    got_q, got_k = ref.rope_elite_qk_ref(q, k, pos, f, qpr, kpr)
    if CASES[case][4]:
        fq, fk = f.expand(q.shape[2], r), f.expand(k.shape[2], r)
    else:
        fq, fk = rope.expand_kv_to_q(f, qpr), f
    assert torch.equal(got_q, ref.rope_elite_ref(q, pos, fq))
    assert torch.equal(got_k, ref.rope_elite_ref(k, pos, fk))
    assert torch.equal(got_q, rope.apply_elite_rope(q, pos, fq))


# ---------------------------------------------------------------------------
# one rotation call per layer and forward, on every path
# ---------------------------------------------------------------------------

@pytest.fixture
def rotations(monkeypatch):
    """Count ``ops.rope_elite_qk`` calls; any ``ops.rope_elite`` call fails."""
    calls = []
    pair = ops.rope_elite_qk

    def counted(*a):
        calls.append(a[0].shape)
        return pair(*a)

    def single(*a):
        raise AssertionError("a forward rotated through the single-tensor entry")

    monkeypatch.setattr(ops, "rope_elite_qk", counted)
    monkeypatch.setattr(ops, "rope_elite", single)
    return calls


def _model(elitekv=True, seed=0):
    cfg = get_config("tinyllama_1_1b").reduced(vocab_size=128, n_kv_heads=2)
    if elitekv:
        cfg = cfg.with_elitekv(elite_r=4, d_ckv=64)
    params, buffers = lm.init(cfg, seed=seed, device="cpu")
    return cfg, params, buffers


@pytest.mark.parametrize("elitekv", [True, False], ids=["elitekv", "baseline"])
def test_generate_rotates_once_per_layer_and_forward(elitekv, rotations):
    cfg, params, buffers = _model(elitekv)
    prompts = np.random.default_rng(3).integers(0, 128, (2, 10))
    serve_loop.generate(params, buffers, cfg, prompts, 5, device="cpu")
    # one prefill and four decode forwards
    assert len(rotations) == 5 * cfg.num_layers
    assert rotations[0] == (2, 10, cfg.n_heads, rotations[0][-1])
    assert all(s[:2] == (2, 1) for s in rotations[cfg.num_layers:])


BS, MB = 4, 8


def test_paged_forwards_rotate_once_per_layer(rotations):
    """A fresh prefill, a resumed chunk, a decode step and a speculative
    verify step through ``models/lm.py``: one call per layer each."""
    cfg, params, buffers = _model()
    L = cfg.num_layers
    rng = np.random.default_rng(4)
    pool = PagedKVPool(cfg, 32, BS, device="cpu")
    toks = lambda *s: torch.from_numpy(rng.integers(0, 128, s).astype(np.int32))
    for sid in (0, 1):
        pool.ensure_capacity(sid, 10)
    sm = np.stack([pool.prefill_slot_mapping(sid, 0, 6, 6) for sid in (0, 1)])
    lm.apply_prefill_paged(params, buffers, cfg, toks(2, 6), pool.pages, torch.from_numpy(sm))
    assert len(rotations) == L
    starts = np.asarray([6, 6], np.int32)
    sm = np.stack([pool.prefill_slot_mapping(sid, 6, 3, 3) for sid in (0, 1)])
    lm.apply_prefill_paged(params, buffers, cfg, toks(2, 3), pool.pages,
                           torch.from_numpy(sm), chunk_start=starts,
                           block_tables=pool.block_table_array([0, 1], MB),
                           prefix_lens=starts, block_size=BS)
    assert len(rotations) == 2 * L
    sm = pool.slot_mapping([0, 1], [9, 9])
    lm.apply_decode_paged(params, buffers, cfg, toks(2, 1), pool.pages,
                          torch.from_numpy(sm), pool.block_table_array([0, 1], MB),
                          np.asarray([10, 10], np.int32), BS)
    assert len(rotations) == 3 * L
    W = 3
    for sid in (0, 1):
        pool.ensure_capacity(sid, 10 + W)
    sm = np.stack([pool.prefill_slot_mapping(sid, 10, W, W) for sid in (0, 1)])
    lm.apply_verify_paged(params, buffers, cfg, toks(2, W), pool.pages, torch.from_numpy(sm),
                          pool.block_table_array([0, 1], MB), np.asarray([10, 10], np.int32),
                          np.asarray([10 + W, 10 + W], np.int32), BS)
    assert len(rotations) == 4 * L
    assert rotations[-1][:2] == (2, W)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_scheduler_rotates_once_per_layer_and_forward(spec, rotations):
    """Chunked prefill and decode (plain), or draft and verify forwards
    (speculative), through the ``Scheduler``: the report's forwards times
    the layers."""
    cfg, params, buffers = _model()
    scfg = serve_loop.SchedulerConfig(max_slots=2, block_size=BS, num_blocks=64, max_len=40,
                                      prefill_chunk_tokens=8,
                                      **(dict(speculate_k=2, draft_rank=16) if spec else {}))
    prompts = np.random.default_rng(5).integers(0, 128, (2, 20)).astype(np.int32)
    _, rep = serve_loop.generate_paged(params, buffers, cfg, prompts, 6, scfg, device="cpu")
    forwards = rep.prefill_chunks + rep.decode_steps + rep.draft_forwards
    assert rep.prefill_chunks > 1 and rep.decode_steps > 0
    assert (rep.draft_forwards > 0) == spec
    assert len(rotations) == forwards * cfg.num_layers


# ---------------------------------------------------------------------------
# the kernel's host plan
# ---------------------------------------------------------------------------

def test_access_width_follows_alignment():
    wide = torch.zeros(2, 5, 32, 64)
    assert re_k.access_bytes(wide[..., :16], torch.zeros(2, 5, 4, 16)) == 16
    assert re_k.access_bytes(wide[..., 2:18]) == 8          # starts 8 B into a row
    assert re_k.access_bytes(torch.zeros(2, 5, 4, 18)[..., :16]) == 8   # 72-byte heads
    assert re_k.access_bytes(wide[:, :1, :1, :16]) == 16    # size-1 axes' strides
    with pytest.raises(ValueError, match="8-byte"):
        re_k.access_bytes(wide[..., 1:17])


# (B, S, r, rows, heads per row): TinyLlama-1.1B and LLaMA2-7B, EliteKV and
# the full RoPE, prefill and decode, and the single-tensor entry's shapes
WIDTH_CASES = [(8, 1024, 8, 4, 9), (8, 1, 8, 4, 9), (8, 1024, 16, 32, 2),
               (8, 1024, 32, 1, 36), (8, 1, 32, 1, 36), (2, 1024, 64, 1, 64),
               (1, 1, 8, 32, 1), (4, 1000, 64, 1, 32), (3, 5, 8, 4, 9)]


@pytest.mark.parametrize("aligned16", [True, False], ids=["16B", "8B"])
@pytest.mark.parametrize("B,S,r,rows,heads", WIDTH_CASES)
def test_plan_covers_every_head_and_token(B, S, r, rows, heads, aligned16):
    p = re_k.plan(B, S, r, rows, heads, aligned16)
    assert p.vec == (2 if aligned16 and r % 2 == 0 else 1)
    assert p.per_sub <= re_k.MAX_VECTORS and p.subsets * p.per_sub >= heads
    assert (p.subsets - 1) * p.per_sub < heads              # no empty subset
    vx, vy, tz = p.block
    assert vx * p.vec == r and vy == rows * p.subsets
    assert vx * vy * tz <= re_k.MAX_THREADS and tz <= re_k.MAX_TOKENS_PER_CTA
    assert p.grid[1] == B and p.grid[0] * tz >= S > (p.grid[0] - 1) * tz


def test_plan_of_the_main_shapes():
    """EliteKV at TinyLlama-1.1B widths: 16 threads per token, each with the
    8 query heads and the key head of one row (144 B in flight), 16 tokens
    per CTA; the full RoPE's 36 heads in four subsets of 9."""
    assert re_k.plan(8, 1024, 8, 4, 9, True) == re_k.Plan(2, 1, 9, (4, 4, 16), (64, 8))
    assert re_k.plan(8, 1024, 32, 1, 36, True) == re_k.Plan(2, 4, 9, (16, 4, 4), (256, 8))
    with pytest.raises(ValueError, match="threads per token"):
        re_k.plan(1, 1, 512, 1, 36, False)


@pytest.mark.parametrize("B,S,r,rows,heads", [
    (8, 1024, 32, 40, 2),      # LLaMA2-13B EliteKV at half cache: 40 rows of 32 pairs
    (4, 512, 64, 40, 1),       # the RoPElite search's masked rotation, one row per head
    (4, 512, 64, 32, 1),       # the same at LLaMA2-7B widths
    (2, 3, 32, 36, 2)])        # MiniCPM-2B at half cache
def test_plan_cuts_rows_that_do_not_fit_one_cta(B, S, r, rows, heads):
    """A token whose rows need more than ``MAX_THREADS`` threads has them
    cut into the fewest even row blocks that fit (grid z); a token whose
    rows fit keeps one block, as before."""
    p = re_k.plan(B, S, r, rows, heads, True)
    per_row = (r // p.vec) * p.subsets
    vx, vy, tz = p.block
    rpc = vy // p.subsets
    assert vx * vy * tz <= re_k.MAX_THREADS
    assert p.row_blocks * rpc >= rows > (p.row_blocks - 1) * rpc
    assert (p.row_blocks > 1) == (rows * per_row > re_k.MAX_THREADS)
    assert p.row_blocks == -(-rows * per_row // re_k.MAX_THREADS)
    assert p.grid[1] == B and p.grid[0] * tz >= S > (p.grid[0] - 1) * tz


def test_kernel_entries_refuse_cpu_tensors():
    q_wide, k, pos, freqs, qpr, kpr, r = _pair_case("elite_G4_r4", False, False)
    with pytest.raises(ValueError, match="CUDA"):
        re_k.rope_elite_qk(_t(q_wide), _t(k), _t(pos), _t(freqs), qpr, kpr)
    with pytest.raises(ValueError, match="CUDA"):
        re_k.rope_elite(_t(k), _t(pos), _t(freqs))
