"""MoE, Mamba and hybrid stacks in the port, held to the JAX package on the
CPU (weights made by the reference's ``init`` and carried by
``repro_torch.interop``; inputs numpy, seeded):

* the four configs' fields, layer and FFN kinds, parameter counts and cache
  bytes per token equal the reference's, full and ``reduced()``;
* ``apply_train`` logits (1e-4) and summed balance loss of reduced
  Qwen3-MoE, Arctic, one period of Jamba and Falcon-Mamba;
* the contiguous cache: prefill + decode logits equal ``apply_train``'s
  (cache on == cache off), the Mamba states and attention rows equal the
  reference's prefill cache, and ``measured_cache_bytes`` splits them as
  the reference does;
* greedy streams: ``generate`` against the JAX ``generate`` (Jamba,
  Falcon-Mamba, Qwen3-MoE) and the ``Scheduler`` against the JAX
  ``Scheduler`` (Qwen3-MoE, Arctic).  A stream may part from the
  reference's only where the reference's next token is a near-tie (top-2
  logits margin under 1e-4) or a router came within ``ROUTE_GAP`` of
  another expert choice on its context; such tokens are counted and
  printed;
* the pool, the ``Scheduler`` and the paged entry points refuse a stack
  with Mamba layers (``ValueError``), and ``launch.serve`` refuses
  ``--stream`` for one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cache as jax_cache
from repro.models import lm as jax_lm
from repro.runtime import serve_loop as jax_sl

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import cache
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.runtime import serve_loop
from routing_margins import ROUTE_GAP, min_gap_per_token, recorded_gaps

LOGIT_TOL = dict(atol=1e-4, rtol=0)
NEAR_TIE = 1e-4
NEW = ("qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b", "falcon_mamba_7b")
FIELDS = ("name", "family", "num_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "d_head", "n_experts", "top_k", "moe_dff", "dense_residual",
          "moe_every", "moe_offset", "ssm_state", "ssm_conv", "ssm_expand", "attn_period",
          "attn_offset", "dt_rank", "ssm_chunk", "rope_theta", "norm_eps", "tie_embeddings",
          "padded_vocab", "head_dim", "q_group", "d_inner", "block_period",
          "attn_layer_indices", "n_attn_layers")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def _cfgs(arch, elitekv, **over):
    jcfg, cfg = jax_get_config(arch).reduced(**over), get_config(arch).reduced(**over)
    if elitekv and cfg.n_attn_layers:
        jcfg, cfg = jcfg.with_elitekv(), cfg.with_elitekv()
    return jcfg, cfg


def _models(arch, elitekv=True, seed=0, **over):
    jcfg, cfg = _cfgs(arch, elitekv, **over)
    jp, jb = jax_lm.init(jax.random.PRNGKey(seed), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jcfg, jp, jb, cfg, tp, tb


# one period of Jamba: 7 Mamba layers, attention at position 3, MoE at odd positions
JAMBA = dict(num_layers=8)


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_match_reference(arch):
    for got, want in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced()),
                      (get_config(arch).with_elitekv(), jax_get_config(arch).with_elitekv())):
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (arch, f)
        for i in range(got.num_layers):
            assert (got.layer_kind(i), got.ffn_kind(i)) == (want.layer_kind(i),
                                                            want.ffn_kind(i))
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.kv_cache_bytes_per_token() == want.kv_cache_bytes_per_token()
        assert cache.model_cache_floats_per_token(got) == \
            jax_cache.model_cache_floats_per_token(want)
        assert cache.ssm_state_floats(got, 3) == jax_cache.ssm_state_floats(want, 3)
    cfg = get_config(arch)
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.block_period)]
    if arch == "jamba_v0_1_52b":
        assert cfg.block_period == 8 and cfg.attn_layer_indices[:2] == (3, 11)
        assert kinds == [("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("attn", "moe"),
                         ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe")]
    if arch == "falcon_mamba_7b":
        assert kinds == [("ssm", "none")] and cfg.n_attn_layers == 0
    if arch in ("qwen3_moe_235b", "arctic_480b"):
        assert kinds == [("attn", "moe")] and cfg.n_attn_layers == cfg.num_layers


@pytest.mark.parametrize("arch,elitekv,over", [
    ("qwen3_moe_235b", True, {}), ("arctic_480b", False, {}),
    ("jamba_v0_1_52b", True, JAMBA), ("jamba_v0_1_52b", False, JAMBA),
    ("falcon_mamba_7b", False, {})],
    ids=["qwen3-elitekv", "arctic-baseline", "jamba-elitekv", "jamba-baseline", "falcon"])
def test_apply_train_matches_reference(arch, elitekv, over):
    """Logits (1e-4) and the summed balance loss (1e-6 relative, 0 without
    MoE layers); the ragged and dense MoE give the same logits."""
    jcfg, jp, jb, cfg, tp, tb = _models(arch, elitekv, **over)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = jax_lm.apply_train(jp, jb, jcfg, {"tokens": jnp.asarray(tokens)})
    with recorded_gaps([]) as calls:
        got, aux = lm.apply_train(tp, tb, cfg, torch.from_numpy(tokens).long(),
                                  return_aux=True)
    assert all(float(c.min()) > ROUTE_GAP for c in calls)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert (float(aux) > 0) == (cfg.n_experts > 0)
    dense = lm.apply_train(tp, tb, cfg, torch.from_numpy(tokens).long(), moe_impl="dense")
    np.testing.assert_allclose(dense[..., :V].numpy(), got[..., :V].numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("arch,elitekv,over", [
    ("jamba_v0_1_52b", True, JAMBA), ("jamba_v0_1_52b", False, JAMBA),
    ("falcon_mamba_7b", False, {}), ("qwen3_moe_235b", True, {})],
    ids=["jamba-elitekv", "jamba-baseline", "falcon", "qwen3-elitekv"])
def test_cache_on_equals_cache_off_and_reference_cache(arch, elitekv, over):
    """Prefill 9 tokens then decode 3 over ``init_cache`` == ``apply_train``
    on the 12; the cache after prefill equals the reference's, leaf for
    leaf, with the reference's keys, shapes and byte split."""
    jcfg, jp, jb, cfg, tp, tb = _models(arch, elitekv, ssm_chunk=4, **over)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    full = lm.apply_train(tp, tb, cfg, torch.from_numpy(tokens).long())
    c = lm.init_cache(cfg, 2, 16, device="cpu")
    jc = jax_lm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    shapes = lambda t: {k: {n: tuple(np.shape(a)) for n, a in v.items()}
                        for k, v in t["blocks"].items()}
    assert shapes(c) == shapes(jc)
    assert cache.measured_cache_bytes(c, 2, 16) == jax_cache.measured_cache_bytes(jc, 2, 16)
    measured = cache.measured_cache_bytes(c, 2, 16)
    assert measured["attn_bytes"] == 4 * cache.model_cache_floats_per_token(cfg) * 2 * 16
    assert measured["ssm_bytes"] == 4 * cache.ssm_state_floats(cfg, 2)
    V = cfg.vocab_size
    pre = lm.apply_prefill(tp, tb, cfg, torch.from_numpy(tokens[:, :9]).long(), c)
    np.testing.assert_allclose(pre[..., :V].numpy(), full[:, :9, :V].numpy(), **LOGIT_TOL)
    _, jc = jax_lm.apply_prefill(jp, jb, jcfg, {"tokens": jnp.asarray(tokens[:, :9])}, jc)
    for key, leaves in c["blocks"].items():
        for name, arr in leaves.items():
            want = np.asarray(jc["blocks"][key][name])
            np.testing.assert_allclose(arr.numpy(), want, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{key}/{name}")
    for t in range(9, 12):
        dec = lm.apply_decode(tp, tb, cfg, torch.from_numpy(tokens[:, t:t + 1]).long(), c)
        np.testing.assert_allclose(dec[..., :V].numpy(), full[:, t:t + 1, :V].numpy(),
                                   **LOGIT_TOL)
    assert c["index"] == 12


def _excused(tp, tb, cfg, context) -> str:
    """Why the reference's next token after ``context`` may go either way
    ("near-tie" or "routing"), else ''."""
    with recorded_gaps([]) as calls:
        logits = lm.apply_train(tp, tb, cfg, torch.from_numpy(
            np.asarray(context, np.int64)[None]))
    top = torch.topk(logits[0, -1].double(), 2).values
    if float(top[0] - top[1]) < NEAR_TIE:
        return "near-tie"
    if calls and float(min_gap_per_token(calls, len(context)).min()) < ROUTE_GAP:
        return "routing"
    return ""


def _compare(label, tp, tb, cfg, prompts, got, want) -> int:
    """Streams ``got`` against the reference's ``want`` (dicts uid → list):
    each may part only at an excused token; → the number excused."""
    excused = 0
    for uid, w in want.items():
        g = got[uid]
        diff = [t for t, (a, b) in enumerate(zip(g, w)) if a != b]
        if not diff:
            assert len(g) == len(w), (label, uid)
            continue
        t = diff[0]
        why = _excused(tp, tb, cfg, list(prompts[uid]) + list(w[:t]))
        assert why, f"{label} request {uid}: token {t} is {g[t]}, reference {w[t]}"
        excused += 1
    print(f"{label}: {len(want)} streams == the reference's, {excused} tokens excused "
          f"(near-tie or routing)")
    return excused


@pytest.mark.parametrize("arch,over", [("jamba_v0_1_52b", JAMBA), ("falcon_mamba_7b", {}),
                                       ("qwen3_moe_235b", {})],
                         ids=["jamba", "falcon", "qwen3"])
def test_generate_matches_jax_generate(arch, over):
    jcfg, jp, jb, cfg, tp, tb = _models(arch, True, **over)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want, jstats = jax_sl.generate(jp, jb, jcfg, jnp.asarray(prompts), 8)
    got, stats = serve_loop.generate(tp, tb, cfg, prompts, 8, device="cpu")
    assert got.shape == (3, 8) and stats.cache_bytes == jstats.cache_bytes
    c = lm.init_cache(cfg, 3, 18, device="cpu")
    assert stats.ssm_bytes == cache.measured_cache_bytes(c, 3, 18)["ssm_bytes"]
    assert (stats.ssm_bytes > 0) == (cfg.ssm_state > 0)
    _compare(f"generate {arch}", tp, tb, cfg, prompts,
             {b: list(got[b]) for b in range(3)}, {b: list(np.asarray(want)[b])
                                                   for b in range(3)})


def _requests(mod, vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(5, 14)))
                        .astype(np.int32), max_new_tokens=8, arrival=i * 0.5)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "arctic_480b"])
def test_moe_scheduler_matches_jax_scheduler(arch):
    """EliteKV MoE stacks through the paged ``Scheduler`` (chunked prefill
    of 4 tokens, 2 lanes): the JAX ``Scheduler``'s streams and counts."""
    jcfg, jp, jb, cfg, tp, tb = _models(arch, True)
    kw = dict(max_slots=2, block_size=4, num_blocks=64, max_len=32, prefill_bucket=4,
              prefill_chunk_tokens=4)
    jsched = jax_sl.Scheduler(jp, jb, jcfg, jax_sl.SchedulerConfig(**kw))
    jrep = jsched.run(_requests(jax_sl, jcfg.vocab_size, 3, seed=4))
    tsched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**kw),
                                  device="cpu")
    trep = tsched.run(_requests(serve_loop, cfg.vocab_size, 3, seed=4))
    prompts = {r.uid: r.prompt for r in tsched.finished}
    excused = _compare(f"Scheduler {arch}", tp, tb, cfg, prompts,
                       {r.uid: r.generated for r in tsched.finished},
                       {r.uid: r.generated for r in jsched.finished})
    assert trep.completed == jrep.completed == 3
    if not excused:
        assert (trep.decode_steps, trep.prefill_chunks) == (jrep.decode_steps,
                                                            jrep.prefill_chunks)


def test_stacks_with_mamba_layers_are_refused_by_paged_serving():
    _, _, _, cfg, tp, tb = _models("jamba_v0_1_52b", True, **JAMBA)
    with pytest.raises(ValueError, match="attention-only"):
        cache.PagedKVPool(cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(), device="cpu")
    tokens = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="attention-only"):
        lm.apply_decode_paged(tp, tb, cfg, tokens, {}, torch.zeros(1, dtype=torch.int32),
                              [[0]], [1], 4)
    with pytest.raises(ValueError, match="attention-only"):
        lm.apply_prefill_paged(tp, tb, cfg, tokens, {}, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(SystemExit):
        serve.main(["--arch", "jamba_v0_1_52b", "--reduced", "--elitekv", "--stream",
                    "--device", "cpu"])
    fcfg = get_config("falcon_mamba_7b").reduced()
    assert serve.build_config("falcon_mamba_7b", True, 0.25) == fcfg   # --elitekv ignored
    assert not fcfg.elitekv.enabled


def test_interop_places_superblock_positions_in_layer_order():
    """Reference ``blocks/p{pos}`` entry ``s`` is port layer ``s·8 + pos``."""
    jcfg, jp, jb, cfg, tp, tb = _models("jamba_v0_1_52b", True)      # 16 layers, 2 periods
    assert len(tp["layers"]) == 16
    for i, (layer, buf) in enumerate(zip(tp["layers"], tb["layers"])):
        pos, s = i % 8, i // 8
        ref = jp["blocks"][f"p{pos}"]
        np.testing.assert_array_equal(layer["attn_norm"]["scale"].numpy(),
                                      np.asarray(ref["attn_norm"]["scale"][s]))
        key = "wq" if cfg.layer_kind(i) == "attn" else "in_proj"
        np.testing.assert_array_equal(layer["attn"][key].numpy(),
                                      np.asarray(ref["attn"][key][s]))
        assert ("router" in layer["ffn"]) == (cfg.ffn_kind(i) == "moe")
        assert bool(buf) == (cfg.layer_kind(i) == "attn")
    p_shapes = lambda t: [{k: tuple(v.shape) for k, v in layer["attn"].items()}
                          for layer in t["layers"]]
    own, _ = lm.init(cfg, seed=0, device="cpu")
    assert p_shapes(own) == p_shapes(tp)
    assert dataclasses.asdict(cfg.elitekv) == dataclasses.asdict(jcfg.elitekv)
