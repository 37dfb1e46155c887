"""The paper's §4 loop at miniature scale in the PyTorch port: pretrain a
small RoPE LM on the synthetic corpus, convert it to EliteKV at several
cache ratios, uptrain each, and print the recovery table.

    PYTHONPATH=src python examples/torch_convert_and_uptrain.py             # the card
    PYTHONPATH=src python examples/torch_convert_and_uptrain.py --device cpu \\
        --pretrain-steps 60 --uptrain-steps 30

(Defaults are small; raise the flags on the card.)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import EliteKVConfig, get_config
from repro_torch.core import convert
from repro_torch.core.cache import cache_ratio
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves


@torch.no_grad()
def eval_ppl(params, buffers, cfg, device, seed=123, batches=4):
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    batch_size=4, seed=seed), device=device)
    tot = sum(float(lm.loss_fn(params, buffers, cfg, next(data))[0]) for _ in range(batches))
    return float(np.exp(tot / batches))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--uptrain-steps", type=int, default=150)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config("tinyllama_1_1b").reduced(
        num_layers=args.layers, d_model=args.dim, n_heads=8, n_kv_heads=4,
        d_head=args.dim // 8, d_ff=args.dim * 3, vocab_size=512)
    params, buffers = lm.init(cfg, seed=0, device=dev)
    n = sum(t.numel() for t in leaves(params))
    print(f"model: {n / 1e6:.2f}M params, vocab {cfg.vocab_size}")

    tc = train_loop.TrainConfig(lr=3e-3)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    batch_size=8, seed=0), device=dev)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    t0 = time.time()
    params, _, _ = train_loop.train(
        params, buffers, cfg, tc, data, args.pretrain_steps,
        checkpointer=ck, ckpt_every=100, log_every=50,
        callback=lambda s, m: s % 50 == 0 and print(
            f"  pretrain step {s}: loss {float(m['loss']):.3f}", flush=True))
    base_ppl = eval_ppl(params, buffers, cfg, dev)
    print(f"baseline ppl: {base_ppl:.2f}  ({time.time() - t0:.0f}s)")

    calib = next(TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                          batch_size=2, seed=77), device=dev))
    full = 2 * cfg.n_kv_heads * cfg.head_dim
    print(f"\n{'ratio':>6} {'r':>3} {'d_ckv':>6} {'ppl@0':>8} {'ppl@up':>8} "
          f"{'Δvs base':>9}")
    for ratio in (0.5, 0.25, 0.125):
        budget = int(ratio * full)
        r = max(1, min(budget // (4 * cfg.n_kv_heads), cfg.head_dim // 2 - 1))
        d_ckv = budget - 2 * r * cfg.n_kv_heads
        ek = EliteKVConfig(enabled=True, elite_r=r, d_ckv=max(8, d_ckv))
        ep, eb, ecfg = convert.elitekv_from_baseline(params, buffers, cfg,
                                                     calib["tokens"], ek)
        ppl0 = eval_ppl(ep, eb, ecfg, dev)
        data_up = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                           batch_size=8, seed=1), device=dev)
        ep, _, _ = train_loop.train(ep, eb, ecfg, tc, data_up, args.uptrain_steps,
                                    log_every=0)
        ppl1 = eval_ppl(ep, eb, ecfg, dev)
        print(f"{cache_ratio(ecfg, cfg):6.3f} {r:3d} {ek.d_ckv:6d} "
              f"{ppl0:8.2f} {ppl1:8.2f} {ppl1 - base_ppl:+9.2f}")
    print("\n(lower ratio → larger initial hit and slower recovery — paper Fig. 6)")


if __name__ == "__main__":
    main()
