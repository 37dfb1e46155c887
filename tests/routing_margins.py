"""How close a MoE router came to another expert choice: the checks'
arithmetic for routing flips, used by ``tests/test_torch_moe.py``,
``tests/test_torch_hybrid.py`` and ``chip_smoke.py`` (phase 3l).  No
serving path uses it.

A token's top-k experts are decided by the gap between its k-th and
(k+1)-th router probabilities.  Two computations of the same forward that
differ by rounding may pick another expert only where that gap is within
rounding; the comparisons excuse a differing token only where the
reference's gap was under ``ROUTE_GAP``, and count it.
"""
import contextlib

import torch

from repro_torch.models import moe

#: k-th/(k+1)-th router probability gap under which rounding may swap experts
ROUTE_GAP = 1e-6


def route_gaps(probs: torch.Tensor, k: int) -> torch.Tensor:
    """probs [T, E] → the k-th minus the (k+1)-th largest, [T] (f64)."""
    top = torch.topk(probs.double(), min(k + 1, probs.shape[-1]), dim=-1).values
    if top.shape[-1] <= k:
        return torch.full(probs.shape[:1], float("inf"), dtype=torch.float64)
    return top[:, k - 1] - top[:, k]


@contextlib.contextmanager
def recorded_gaps(calls: list):
    """Within the block every ``moe._route`` call appends its tokens' gaps
    [T] (f64, on the router's device) to ``calls``, in call order."""
    real = moe._route

    def rec(params, cfg, xf):
        probs = torch.softmax((xf @ params["router"].to(xf.dtype)).float(), dim=-1)
        calls.append(route_gaps(probs, cfg.top_k))
        return real(params, cfg, xf)

    moe._route = rec
    try:
        yield calls
    finally:
        moe._route = real


def min_gap_per_token(calls: list, n_tokens: int) -> torch.Tensor:
    """The least gap of each of ``n_tokens`` tokens over the layers of one
    forward (every call in ``calls`` routed those tokens)."""
    return torch.stack([c[:n_tokens].cpu() for c in calls]).amin(0)
