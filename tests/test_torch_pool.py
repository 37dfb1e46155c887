"""The port's pool bookkeeping that the JAX package's ``core/cache.py`` has
beside allocation: ``BlockAllocator.reset``, ``PagedKVPool.reset`` and
``PagedKVPool.floats_per_token``, held to the reference on the same
operations (pure host bookkeeping: equal lists, tables and counts)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.base import EliteKVConfig as JaxEliteKV
from repro.core.cache import BlockAllocator as JaxAllocator
from repro.core.cache import BlockManager as JaxManager
from repro.core.cache import PagedKVPool as JaxPool

from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core.cache import BlockAllocator, BlockManager, PagedKVPool


def test_allocator_reset_matches_reference():
    got, want = BlockAllocator(12), JaxAllocator(12)
    for a in (got, want):
        x = a.alloc(5)
        a.free(x[1:3])
        a.alloc(4)
        a.reset()
    assert got._free == want._free == list(range(11, -1, -1))
    assert got.num_free == want.num_free == 12
    assert (got.high_water, got.total_allocs) == (want.high_water, want.total_allocs)
    assert got.alloc(7) == want.alloc(7)


def _configs(lrd):
    kw = dict(enabled=True, elite_r=4, d_ckv=64, lrd=lrd, d_ck=24, d_cv=40)
    jcfg = dataclasses.replace(jax_get_config("tinyllama_1_1b").reduced(num_layers=2),
                               elitekv=JaxEliteKV(**kw))
    cfg = dataclasses.replace(get_config("tinyllama_1_1b").reduced(num_layers=2),
                              elitekv=EliteKVConfig(**kw))
    return jcfg, cfg


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("lrd", ["joint", "separate"])
def test_floats_per_token_matches_reference(lrd, dtype):
    jcfg, cfg = _configs(lrd)
    got = PagedKVPool(cfg, 8, 4, device="cpu", dtype=dtype)
    want = JaxPool(jcfg, 8, 4, dtype="int8" if dtype == "int8" else np.float32)
    assert got.floats_per_token() == want.floats_per_token()
    assert got.floats_per_token() == 2 * (2 * 4 * cfg.n_kv_heads + (
        64 if lrd == "joint" else 24 + 40))


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["plain", "prefix"])
def test_pool_reset_matches_reference(prefix_cache):
    """After chains, a shared prefix, a truncation and a reset, both pools
    hold no sequence, every block is free, and the next chains are the same
    blocks as a fresh pool's."""
    jcfg, cfg = _configs("joint")
    got = PagedKVPool(cfg, 16, 4, device="cpu")
    want = JaxPool(jcfg, 16, 4)
    fresh = PagedKVPool(cfg, 16, 4, device="cpu")
    if prefix_cache:
        BlockManager(got, prefix_cache=True)
        JaxManager(want, prefix_cache=True)
    for pool in (got, want):
        pool.ensure_capacity(0, 10)
        pool.ensure_capacity(1, 7)
        pool.share_prefix(2, pool.block_table(0)[:2])
        pool.ensure_capacity(2, 13)
        pool.truncate(1, 3)
        pool.reset()
    for pool in (got, want):
        assert pool.allocator.num_free == 16 and pool.cow_copies == 0
        assert pool.block_table(0) == [] and pool.length(2) == 0
        assert not pool._refcount and not pool._tables and not pool._lengths
        assert (pool.prefix is None) != prefix_cache
        if prefix_cache:
            assert not pool.prefix._by_hash and not pool.prefix._by_block
    for pool in (got, want, fresh):
        pool.ensure_capacity(5, 9)
        pool.ensure_capacity(6, 4)
    assert got.block_table(5) == want.block_table(5) == fresh.block_table(5)
    assert got.block_table(6) == want.block_table(6) == fresh.block_table(6)
