"""The six dense architectures in the port, held to the JAX package.

Each config's fields equal the reference's (full and ``reduced()``); the
reduced models' logits equal ``models/lm.py``'s with EliteKV on and off
(weights carried by ``repro_torch.interop``; 1e-4 absolute, as
``tests/test_torch_model.py``), tied embeddings included; and a tied
architecture's greedy paged streams equal the JAX ``Scheduler``'s token for
token, where every token's top-1/top-2 margin exceeds that tolerance.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import make_inputs
from repro.models import lm as jax_lm
from repro.runtime import serve_loop as jax_sl

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.runtime import serve_loop

LOGIT_TOL = dict(atol=1e-4, rtol=0)
DENSE = ("tinyllama_1_1b", "llama2_7b", "llama2_13b", "yi_6b", "granite_3_2b", "minicpm_2b")
FIELDS = ("name", "num_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
          "d_head", "rope_theta", "norm_eps", "tie_embeddings", "padded_vocab", "head_dim",
          "q_group")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny shapes: threading only costs here
    yield
    torch.set_num_threads(n)


def test_arch_ids_are_the_dense_architectures():
    """The dense architectures, then the MoE, hybrid and Mamba stacks
    (``tests/test_torch_hybrid.py``), then the vision and audio frontends
    (``tests/test_torch_frontends.py``): the reference's whole registry."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert ARCH_IDS[:len(DENSE)] == DENSE
    assert ARCH_IDS[len(DENSE):] == ("qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b",
                                     "falcon_mamba_7b", "internvl2_2b", "musicgen_large")
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert all(get_config(a).family == "dense" for a in DENSE)
    assert [get_config(a).frontend for a in ARCH_IDS] == ["none"] * 10 + ["vision", "audio"]
    assert get_config("granite-3-2b").name == "granite_3_2b"
    with pytest.raises(KeyError):
        get_config("internvl2_8b")


@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_match_reference(arch):
    for got, want in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (arch, f)
        assert dataclasses.asdict(got.elitekv) == dataclasses.asdict(want.elitekv)
    cfg = get_config(arch)
    assert cfg.tie_embeddings == (arch in ("granite_3_2b", "minicpm_2b"))
    if arch == "minicpm_2b":
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.padded_vocab) == \
            (36, 36, 64, 122880)
    if arch == "granite_3_2b":
        assert cfg.padded_vocab == 49408
    if arch == "yi_6b":
        assert (cfg.rope_theta, cfg.vocab_size) == (5e6, 64000)


def _models(arch, elitekv, seed=0):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if elitekv:
        jcfg, cfg = jcfg.with_elitekv(), cfg.with_elitekv()
    jp, jb = jax_lm.init(jax.random.PRNGKey(seed), jcfg)
    tp, tb = interop.from_reference(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jb), jcfg, device="cpu")
    return jcfg, jp, jb, cfg, tp, tb


@pytest.mark.parametrize("elitekv", [False, True], ids=["baseline", "elitekv"])
@pytest.mark.parametrize("arch", DENSE)
def test_reduced_logits_match_reference(arch, elitekv):
    """Whole-sequence logits (and a contiguous prefill + decode for the
    lockstep path) of every reduced architecture; a tied model has no
    ``lm_head`` on either side."""
    jcfg, jp, jb, cfg, tp, tb = _models(arch, elitekv)
    assert ("lm_head" in tp) == (not cfg.tie_embeddings) == ("lm_head" in jp)
    batch = make_inputs(jcfg, 2, 12, "train", seed=1)
    tokens = torch.from_numpy(np.asarray(batch["tokens"]).astype(np.int64))
    want, _ = jax_lm.apply_train(jp, jb, jcfg, batch)
    got = lm.apply_train(tp, tb, cfg, tokens)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V], **LOGIT_TOL)
    if cfg.padded_vocab != V:
        assert bool((got[..., V:] == -1e30).all())
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    pre = lm.apply_prefill(tp, tb, cfg, tokens[:, :11], cache)
    dec = lm.apply_decode(tp, tb, cfg, tokens[:, 11:], cache)
    np.testing.assert_allclose(pre[..., :V].numpy(), got[:, :11, :V].numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(dec[..., :V].numpy(), got[:, 11:, :V].numpy(), **LOGIT_TOL)


def test_port_init_builds_lm_head_only_when_untied():
    for arch in ("granite_3_2b", "tinyllama_1_1b"):
        cfg = get_config(arch).reduced()
        params, _ = lm.init(cfg, seed=0, device="cpu")
        assert ("lm_head" in params) == (not cfg.tie_embeddings)
        logits = lm.apply_train(params, {"layers": [{}] * cfg.num_layers}, cfg,
                                torch.zeros((1, 3), dtype=torch.int64))
        assert logits.shape == (1, 3, cfg.padded_vocab) and torch.isfinite(
            logits[..., :cfg.vocab_size]).all()


def _margin(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def _requests(mod, vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(5, 14)))
                        .astype(np.int32), max_new_tokens=8, arrival=i * 0.5)
            for i in range(n)]


def test_tied_architecture_streams_match_jax_scheduler():
    """Reduced Granite-3.0-2B (tied embeddings, G = 1 after reduction, EliteKV
    on): the port's greedy ``Scheduler`` on the CPU gives the JAX
    ``Scheduler``'s streams and step counts, chunked prefill of 4 tokens."""
    jcfg, jp, jb, cfg, tp, tb = _models("granite_3_2b", True)
    kw = dict(max_slots=2, block_size=4, num_blocks=64, max_len=32, prefill_bucket=4,
              prefill_chunk_tokens=4)
    jsched = jax_sl.Scheduler(jp, jb, jcfg, jax_sl.SchedulerConfig(**kw))
    margins = []
    decode, sample_one = jsched._decode, jsched._sample_one

    def rec_decode(params, buffers, tokens, pages, sm, bt, lengths):
        logits, pages = decode(params, buffers, tokens, pages, sm, bt, lengths)
        margins.extend(_margin(r) for r in
                       np.asarray(logits[:, -1])[np.asarray(lengths) > 0])
        return logits, pages

    def rec_sample_one(req, row, count):
        margins.append(_margin(row))
        return sample_one(req, row, count)

    jsched._decode, jsched._sample_one = rec_decode, rec_sample_one
    jrep = jsched.run(_requests(jax_sl, jcfg.vocab_size, 3, seed=4))
    tsched = serve_loop.Scheduler(tp, tb, cfg, serve_loop.SchedulerConfig(**kw),
                                  device="cpu")
    trep = tsched.run(_requests(serve_loop, cfg.vocab_size, 3, seed=4))
    assert min(margins) > LOGIT_TOL["atol"], "an argmax too close to call"
    assert {r.uid: r.generated for r in tsched.finished} == \
        {r.uid: r.generated for r in jsched.finished}
    assert (trep.completed, trep.decode_steps, trep.prefill_chunks) == \
        (jrep.completed, jrep.decode_steps, jrep.prefill_chunks) == \
        (3, jrep.decode_steps, jrep.prefill_chunks)


@pytest.mark.parametrize("name", ["torch_ropelite_search", "torch_serve_compressed"])
def test_torch_examples_run_on_cpu(name, capsys):
    """The port's examples run end to end on the CPU when asked."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert ("greedy pick order" in out) if "ropelite" in name else ("ratio=0.250" in out)
