"""Quickstart in the PyTorch port: build a small RoPE LM, convert it to
EliteKV at a 25% KV cache, and check that the compressed model decodes
what its full forward computes.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import convert
from repro_torch.core.cache import cache_ratio, model_cache_floats_per_token
from repro_torch.models import lm


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    # 1. a small llama-family model (the TinyLlama config family, reduced)
    cfg = get_config("tinyllama_1_1b").reduced(num_layers=4)
    params, buffers = lm.init(cfg, seed=0, device=dev)
    print(f"baseline: {cfg.name}  cache/token = {model_cache_floats_per_token(cfg)} floats")

    # 2. RoPElite search + joint low-rank decomposition (paper §3) at ~25%
    rng = np.random.default_rng(1)
    calib = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(dev)
    ek = EliteKVConfig(enabled=True, elite_r=4,
                       d_ckv=int(0.25 * 2 * cfg.n_kv_heads * cfg.head_dim)
                       - 2 * 4 * cfg.n_kv_heads)
    eparams, ebuffers, ecfg = convert.elitekv_from_baseline(params, buffers, cfg, calib, ek)
    print(f"elitekv:  r={ek.elite_r} d_ckv={ek.d_ckv}  cache/token = "
          f"{model_cache_floats_per_token(ecfg)} floats  "
          f"(ratio {cache_ratio(ecfg, cfg):.3f})")

    # 3. the compressed model decodes: prefill + absorbed decode against the
    #    compressed cache only, held to the full forward's logits
    B, S = 2, 32
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    full = lm.apply_train(eparams, ebuffers, ecfg, tokens)
    cache = lm.init_cache(ecfg, B, S, device=dev)
    lp = lm.apply_prefill(eparams, ebuffers, ecfg, tokens[:, :S - 4], cache)
    err = float((lp - full[:, :S - 4]).abs().max())
    for t in range(S - 4, S):
        ld = lm.apply_decode(eparams, ebuffers, ecfg, tokens[:, t:t + 1], cache)
        err = max(err, float((ld[:, 0] - full[:, t]).abs().max()))
    print(f"absorbed-decode max |Δlogit| vs full forward: {err:.2e}  "
          f"(cache never re-rotated)")
    assert err < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
