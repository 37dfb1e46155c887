"""The host plan of ``flash_prefill`` and its decode body's arithmetic.

``kernels/flash_prefill.py::plan`` picks the kernel's body (decode for at
most 16 query rows per kv head, prefill otherwise) and the decode body's
key ranges from the call's shapes alone; ``ref.flash_split_ref`` cuts the
call into those ranges and merges the partials in the kernel's order.
Here, on the CPU, the plan is held to its invariants and the
split-and-merge to the unsplit plain version within 2e-6 (f32; one softmax
against a max-rescaled sum of a few partials), and one decode-shaped case
to the JAX package's Pallas kernel in interpret mode (1e-5, as
``tests/test_torch_kernels.py``).  Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import flash_prefill as jax_fp

from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ref

TOL = dict(atol=2e-6, rtol=2e-6)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B, Sq, Sk, nkv, G, dh, offs, lens):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return (f(B, Sq, nkv * G, dh), f(B, Sk, nkv, dh), f(B, Sk, nkv, dh), G, dh ** -0.5,
            i32(offs), i32(lens))


@pytest.mark.parametrize("B,Sq,Sk,nkv,G", [
    (8, 1, 1152, 4, 8), (8, 2, 1152, 4, 8), (8, 3, 1152, 4, 8), (4, 16, 300, 32, 1),
    (4, 17, 300, 32, 1), (8, 256, 768, 4, 8), (2, 1024, 1024, 32, 1), (3, 1, 0, 2, 4),
    # Qwen3-MoE (4 kv heads of 16 queries), Jamba (8 of 4), Arctic (8 of 7)
    (8, 1, 1152, 4, 16), (8, 2, 1152, 4, 16), (8, 256, 768, 4, 16), (8, 1024, 1024, 8, 4),
    (8, 4, 1152, 8, 4), (8, 2, 900, 8, 7), (8, 3, 900, 8, 7)])
def test_plan_reads_shapes_only(B, Sq, Sk, nkv, G):
    """The body (decode up to 16 query rows per kv head) and the decode
    body's ranges come from the shapes: other offsets and kv_lens give the
    same plan."""
    rng = np.random.default_rng(B + Sq)
    plans = set()
    for _ in range(3):
        offs = rng.integers(0, Sk + 1, B)
        lens = rng.integers(0, Sk + 1, B)
        args = (torch.empty(B, Sq, nkv * G, 32), torch.empty(B, Sk, nkv, 32),
                torch.empty(B, Sk, nkv, 32), G, 0.1, torch.tensor(offs, dtype=torch.int32),
                torch.tensor(lens, dtype=torch.int32))
        plans.add(fp.plan_for(*args))
    (p,) = plans
    assert p.body == ("decode" if G * Sq <= fp.DECODE_ROWS else "prefill")
    if p.body == "decode":
        assert p.ranges == max(1, -(-Sk // fp.RANGE_KEYS)) and p.rows == G * Sq
    else:
        assert (p.ranges, p.rows) == (1, fp.PREFILL_ROWS)


@pytest.mark.parametrize("Sk", [0, 1, 127, 128, 129, 1000, 1152, 4097])
def test_key_ranges_cover_every_key_once(Sk):
    """The decode body's ranges, [r·RANGE_KEYS, min((r+1)·RANGE_KEYS, Sk))
    for r below the plan's count, hold every key below Sk exactly once;
    they start at fixed multiples, so a wider Sk only adds ranges at the
    end."""
    def ranges(S):
        n = fp.plan(2, 1, S, 8, 1).ranges
        return [(r * fp.RANGE_KEYS, min((r + 1) * fp.RANGE_KEYS, S)) for r in range(n)]
    covered = [j for a, b in ranges(Sk) for j in range(a, b)]
    assert covered == list(range(Sk))
    assert ranges(Sk + 500)[:len(ranges(Sk)) - 1] == ranges(Sk)[:-1]


@pytest.mark.parametrize("B,Sq,Sk,nkv,G,dh", [
    (7, 1, 1152, 4, 8, 64), (7, 2, 700, 2, 8, 32), (7, 16, 520, 4, 1, 32),
    (7, 5, 260, 1, 3, 32), (7, 40, 300, 2, 2, 32)])
def test_split_mirror_matches_plain(B, Sq, Sk, nkv, G, dh):
    """The decode body's split-and-merge order against the unsplit plain
    version: an empty lane (exact zeros), kv_len on a range boundary and
    ±1, a resumed window and a lane that sees every key."""
    R = fp.RANGE_KEYS
    lens = [0, R - 1, R, R + 1, 2 * R + 1, min(Sq + 3, Sk), Sk]
    offs = [max(0, n - Sq) for n in lens]
    args = _case(Sq, B, Sq, Sk, nkv, G, dh, offs, lens)
    got = ref.flash_split_ref(*args)
    torch.testing.assert_close(got, ref.flash_prefill_ref(*args), **TOL)
    assert float(got[0].abs().max()) == 0.0
    # ranges of other widths split the same function
    for keys in (16, 48):
        torch.testing.assert_close(ref.flash_split_ref(*args, range_keys=keys),
                                   ref.flash_prefill_ref(*args), **TOL)


def test_split_mirror_zero_keys():
    """Sk = 0: nothing to see, exact zeros."""
    args = _case(1, 2, 1, 0, 2, 4, 32, [0, 0], [0, 0])
    assert float(ref.flash_split_ref(*args).abs().max()) == 0.0


def test_decode_shape_split_matches_pallas():
    """Sq = 1, G = 4 through the decode body's order (ranges of 8 keys)
    against the JAX package's kernel in interpret mode."""
    B, Sq, Sk, nkv, G, dh = 4, 1, 32, 2, 4, 16
    offs, lens = [0, 9, 17, 31], [0, 10, 18, 32]
    args = _case(7, B, Sq, Sk, nkv, G, dh, offs, lens)
    q, k, v = (a.numpy() for a in args[:3])
    want = np.asarray(jax_fp.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), G, args[4], block_q=1, block_k=8,
        q_offset=jnp.asarray(np.asarray(offs, np.int32)),
        kv_lens=jnp.asarray(np.asarray(lens, np.int32)), interpret=True))
    got = ref.flash_split_ref(*args, range_keys=8)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)
    assert float(got[0].abs().max()) == 0.0


def test_shared_memory_formula_fits_two_ctas():
    """Both bodies' CTAs fit twice into an H100 SM's 228 KB at every head
    dim (1 KB reserved per CTA)."""
    for body in fp.BODIES:
        for dh in fp.HEAD_DIMS:
            assert 2 * (fp.smem_bytes(body, dh) + 1024) <= 233472, (body, dh)
