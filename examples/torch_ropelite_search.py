"""RoPElite frequency preferences (paper Fig. 2) in the PyTorch port, as
ASCII heat rows: which frequency chunks each head of each layer keeps at
r=8, under the three selection methods, and each method's score distance.

    PYTHONPATH=src python examples/torch_ropelite_search.py              # the card
    PYTHONPATH=src python examples/torch_ropelite_search.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ropelite
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config("llama2_7b").reduced(
        num_layers=3, n_heads=8, n_kv_heads=8, d_head=32, d_model=256)
    params, buffers = lm.init(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 48))).to(dev)
    caps = lm.capture_attn_inputs(params, buffers, cfg, tokens)
    pos = torch.arange(tokens.shape[1], device=dev)

    C = cfg.head_dim // 2
    for method in ("greedy", "contribution", "uniform"):
        sets = ropelite.search_model(params, buffers, cfg, tokens, r=8, method=method)
        print(f"\n=== {method} (chunk 0 = highest frequency, {C - 1} = lowest) ===")
        for li in sorted(sets):
            idx = sets[li].cpu().numpy()
            q, k = ropelite.layer_qk(params["layers"][li]["attn"], caps[li])
            dist = float(ropelite.score_distance(q, k, pos, cfg.rope_theta, cfg.q_group,
                                                 sets[li]).sum())
            for h in range(idx.shape[0]):
                row = ["·"] * C
                for rank, c in enumerate(idx[h]):
                    row[int(c)] = str(min(rank + 1, 9))
                tail = f"   |Δs|₁ = {dist:.4e}" if h == 0 else ""
                print(f"L{li}H{h:<2d} {''.join(row)}{tail}")
    print("\ndigits = greedy pick order (1 = most important chunk)")


if __name__ == "__main__":
    main()
