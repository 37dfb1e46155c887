"""Training step and loop: gradient accumulation, layer remat, AdamW with
f32/bf16/int8 moments, optional int8 gradient compression with error
feedback, checkpoint/restart.

The port's own copy of the JAX package's ``runtime/train_loop.py``, for
every stack: dense, MoE (``TrainConfig.moe_impl``, "ragged" or the "dense"
oracle, with the balance loss weighted by ``aux_weight``), Mamba and
hybrid (the scan recomputed per chunk, ``models/mamba.py``).  The
reference's ``jax.grad``
becomes a backward of ``lm.loss_fn`` into fresh leaves that share the
params' storage; its ``lax.scan`` over microbatches a Python loop whose
gradients add up in those leaves' ``.grad`` in the same order.  On the card the step runs through the
rotary kernel forward and backward (``kernels/ops.py``); every other
operation is plain PyTorch, as the reference leaves it to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    lr: float = 3e-4
    schedule: Optional[Callable] = None          # step → lr (overrides lr)
    grad_accum: int = 1                          # microbatch steps per update
    grad_compression: bool = False               # int8 with error feedback
    aux_weight: float = 0.01
    moe_impl: str = "ragged"                     # MoE dispatch: ragged | dense


def _compress_grads(grads, err):
    """int8-quantize the grads plus the carried residual (error feedback).
    → (g_hat, new_err): the dequantized grads and what they lost."""
    def one(g, e):
        g = g.float() + e
        g_hat = adamw._dequant(adamw._quant(g))
        return g_hat, g - g_hat

    outs = map_tree(one, grads, err)
    return map_tree(lambda o: o[0], outs), map_tree(lambda o: o[1], outs)


def _trainable(params):
    """``params`` as fresh leaves (sharing storage) that require grad."""
    return map_tree(lambda p: p.detach().requires_grad_(True), params)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, constrain=None):
    """→ ``train_step(params, buffers, opt_state, batch)`` →
    (params, opt_state, metrics).  Inputs are left as they are; the new
    params do not require grad.  ``batch`` is ``lm.loss_fn``'s (tokens and
    labels; a vision model's ``patch_embeds`` or an audio model's
    ``frames`` pass through as they are); each of its tensors splits along
    its first axis into ``tc.grad_accum`` microbatches, whose gradients add
    up in the leaves' ``.grad`` and are then averaged.  ``constrain`` is
    ``lm.loss_fn``'s sharding hook: with params, optimizer state and batch
    placed as ``DTensor``s (``distributed/sharding.py``) the step is the
    sharded step, its gradients and moments placed as their parameters."""
    sched = tc.schedule or (lambda s: torch.tensor(tc.lr, dtype=torch.float32))
    n = tc.grad_accum

    def train_step(params, buffers, opt_state, batch):
        params = _trainable(params)
        mbs = ([{k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                for i in range(n)] if n > 1 else [batch])
        lsum = 0.0
        for mb in mbs:
            with torch.enable_grad():
                loss, metrics = lm.loss_fn(params, buffers, cfg, mb, moe_impl=tc.moe_impl,
                                           aux_weight=tc.aux_weight, constrain=constrain)
                loss.backward()
            lsum = lsum + loss.detach()
        grads = map_tree(lambda p: p.grad / n if n > 1 else p.grad, params)
        loss = lsum / n
        metrics = {"ce": loss} if n > 1 else {k: v.detach() for k, v in metrics.items()}
        new_err = None
        if tc.grad_compression:
            grads, new_err = _compress_grads(grads, opt_state.get("err"))
        lr = sched(opt_state["step"])
        new_params, new_opt, om = adamw.update(grads, opt_state, params, lr, tc.optimizer)
        if new_err is not None:
            new_opt["err"] = new_err
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return new_params, new_opt, metrics

    return train_step


def init_opt_state(params, tc: TrainConfig):
    st = adamw.init(params, tc.optimizer)
    if tc.grad_compression:
        st["err"] = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
    return st


def train(params, buffers, cfg: ModelConfig, tc: TrainConfig, data_iter,
          num_steps: int, checkpointer=None, ckpt_every: int = 0,
          log_every: int = 50, callback=None):
    """Single-device training loop with checkpoint/restart.

    Starts from ``params`` (left as they are) or, where ``checkpointer``
    holds a committed step, from that step's params and optimizer state,
    onto the params' device, and moves ``data_iter`` on by the steps done
    (a ``TokenPipeline`` in O(1) through its ``state.step``).  Saves every
    ``ckpt_every`` steps.  → (params that no longer require grad, opt_state,
    history [(step, loss)] every ``log_every`` steps and the last)."""
    device = next(leaves(params)).device
    step_fn = make_train_step(cfg, tc)
    opt_state = init_opt_state(params, tc)
    start = 0
    if checkpointer is not None:
        restored = checkpointer.restore_latest(device=device)
        if restored is not None:
            params, opt_state, extra = restored
            start = int(extra["step"])
            # fast-forward the data stream so restart == uninterrupted run
            if hasattr(data_iter, "state"):
                data_iter.state.step += start      # O(1) seek (TokenPipeline)
            else:
                for _ in range(start):
                    next(data_iter)
    history = []
    for step in range(start, num_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, buffers, opt_state, batch)
        if log_every and (step % log_every == 0 or step == num_steps - 1):
            history.append((step, float(metrics["loss"])))
        if callback is not None:
            callback(step, metrics)
        if checkpointer is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            checkpointer.save(params, opt_state, {"step": step + 1})
    return params, opt_state, history
