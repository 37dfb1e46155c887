"""End-to-end training driver of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
        --steps 200 --batch 8 --seq 256 --elitekv --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 3 --batch 2 --seq 32 --log-every 1

The counterpart of the JAX package's ``launch/train.py`` on one device
(``--device``, the card unless told otherwise; ``--reduced`` for the tiny
same-family config).  Weights are random from ``--seed``; with
``--elitekv`` the model is EliteKV at ``--cache-ratio``.  Checkpoints are
committed atomically and a restart resumes from the newest committed step
with the same data stream.  Matmuls stay out of TF32, as in serving.  The
token pipeline feeds text: ``internvl2_2b`` trains on it without patches;
the audio model ``musicgen_large`` has no token embedding and is refused
with ``ValueError`` (``lm.loss_fn`` trains it on ``frames`` batches).
Every architecture of ``--arch`` trains: dense, MoE (``qwen3_moe_235b``,
``arctic_480b``), the hybrid ``jamba_v0_1_52b`` and the pure Mamba
``falcon_mamba_7b``.  ``--moe-impl`` picks how MoE layers dispatch in the
loss: "ragged" (the default) or the "dense" oracle; "ep" (expert
parallelism) is not ported (ROADMAP item 15) and raises ``ValueError``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_moe_235b \
        --reduced --device cpu --steps 2 --batch 2 --seq 16 --moe-impl dense
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.serve import build_config
from repro_torch.models import lm, moe
from repro_torch.optim import schedule as sched_lib
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="constant", choices=["constant", "cosine", "wsd"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--elitekv", action="store_true")
    ap.add_argument("--cache-ratio", type=float, default=0.25)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' plain versions)")
    ap.add_argument("--moe-impl", choices=("ragged", "dense", "ep"), default="ragged",
                    help="MoE dispatch: ragged (sorted groups) or the dense "
                         "oracle; ep is not ported (ValueError)")
    args = ap.parse_args(argv)
    moe.check_impl(args.moe_impl)
    if get_config(args.arch).frontend == "audio":
        raise ValueError(f"{args.arch} is an audio model with no token embedding: it "
                         "trains on frame embeddings through lm.loss_fn, not on the "
                         "token pipeline this launcher feeds")

    # the reference is f32 end to end: keep matmuls out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = build_config(args.arch, args.reduced, args.cache_ratio, args.elitekv)
    params, buffers = lm.init(cfg, seed=args.seed, device=args.device)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"elitekv={cfg.elitekv.enabled} "
          f"cache/token/layer={cfg.elitekv.cache_per_token_per_layer(cfg.n_kv_heads, cfg.head_dim)}")

    if args.schedule == "constant":
        sched = sched_lib.constant(args.lr)
    elif args.schedule == "cosine":
        sched = sched_lib.cosine(args.lr, warmup=args.steps // 20 + 1, total=args.steps)
    else:
        sched = sched_lib.wsd(args.lr, warmup=args.steps // 20 + 1,
                              stable=args.steps // 2, decay=args.steps // 3 + 1)

    tc = train_loop.TrainConfig(optimizer=AdamWConfig(), lr=args.lr, schedule=sched,
                                grad_accum=args.grad_accum, moe_impl=args.moe_impl)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    batch_size=args.batch, seed=args.seed),
                         device=args.device)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    t0 = time.time()

    def cb(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  gnorm {float(metrics['grad_norm']):.2f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)

    params, opt_state, history = train_loop.train(
        params, buffers, cfg, tc, data, args.steps,
        checkpointer=ckpt, ckpt_every=args.ckpt_every, callback=cb)
    if history:         # empty when a checkpoint already held every step
        print(f"final loss: {history[-1][1]:.4f}  ({args.steps} steps, "
              f"{time.time() - t0:.0f}s)")
    return history


if __name__ == "__main__":
    main()
