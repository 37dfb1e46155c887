"""Batched serving with the compressed EliteKV cache in the PyTorch port: a
reduced Yi-6B, baseline GQA against EliteKV at a quarter of the cache, each
converted from the same baseline weights (RoPElite search + J-LRD), with
lockstep prefill + greedy decode and the measured cache.

    PYTHONPATH=src python examples/torch_serve_compressed.py              # the card
    PYTHONPATH=src python examples/torch_serve_compressed.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import convert
from repro_torch.core.cache import cache_ratio
from repro_torch.models import lm
from repro_torch.runtime import serve_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    base = get_config("yi_6b").reduced(num_layers=4)
    params, buffers = lm.init(base, seed=0, device=dev)
    rng = np.random.default_rng(1)
    calib = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 32))).to(dev)
    ek = EliteKVConfig(enabled=True, elite_r=4, d_ckv=32)
    eparams, ebuffers, elite = convert.elitekv_from_baseline(params, buffers, base, calib, ek)
    prompts = rng.integers(0, base.vocab_size, (8, 24)).astype(np.int32)

    for tag, cfg, p, b in [("baseline-GQA", base, params, buffers),
                           ("EliteKV-25%", elite, eparams, ebuffers)]:
        t0 = time.time()
        out, stats = serve_loop.generate(p, b, cfg, prompts, 16, device=dev)
        dt = time.time() - t0
        print(f"{tag:14s} ratio={cache_ratio(cfg, base):5.3f}  "
              f"cache={stats.cache_bytes / 2**20:7.2f} MiB  "
              f"{stats.decoded_tokens / dt:6.1f} tok/s  "
              f"sample={out[0, :8].tolist()}")

    print("\nRatio of measured cache bytes should equal the paper formula "
          "(2·r·n_kv + d_ckv) / (2·n_kv·d_h) — see tests/test_torch_contiguous.py.")


if __name__ == "__main__":
    main()
