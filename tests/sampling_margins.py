"""How far a sampled draw is from changing: the checks' arithmetic for
sampled streams, used by ``tests/test_torch_sampling.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (phase 3g).  No serving
path uses it.

A draw is the argmax of the sorted scaled logits plus Gumbel noise by
sorted position (``serve_loop.sample_tokens``).  If every logit may move by
``tol``, neighbours in sorted order less than ``2·tol / temperature`` apart
may swap positions and so their noise; the draw is decided when its winner
beats every rival under the worst such move.
"""
import numpy as np
import torch

from repro_torch.runtime.serve_loop import _gumbel_scores, _nucleus

#: distance of the nucleus boundary's excluded mass from top_p under which
#: two computations' f32 softmax and cumsum may cut at another token
NUCLEUS_TOL = 1e-5


def decided_by(sl, noise, excl, top_ps, tau, nucleus_tol: float = NUCLEUS_TOL):
    """By how much each lane's winner beats every rival when each sorted
    scaled logit may move by ``tau`` [B, 1]: > 0 means no such move
    changes the draw.  ``sl``, ``noise`` and ``excl`` [B, V] are the sorted
    scaled logits, the noise by sorted position and the mass before each
    position (the reference's or the port's).  A token may take any noise
    of its run of neighbours less than ``2·tau`` apart (at ``tau`` 0 none:
    the sort is stable); rivals are the nucleus members and positions whose
    membership is in doubt (excluded mass within ``nucleus_tol`` of top_p,
    or a run that straddles the boundary).  -inf when the winner's own
    membership is in doubt.  → [B] float64."""
    sl, noise, excl = sl.double(), noise.double(), excl.double()
    top_ps = top_ps.double()
    kept = _nucleus(excl, top_ps)
    run = torch.cat([torch.zeros_like(sl[:, :1], dtype=torch.int64),
                     torch.cumsum((sl[:, :-1] - sl[:, 1:] >= 2 * tau).long(), dim=-1)], dim=-1)
    lo_g = torch.full_like(noise, float("inf")).scatter_reduce(-1, run, noise, "amin")
    hi_g = torch.full_like(noise, float("-inf")).scatter_reduce(-1, run, noise, "amax")
    n_kept = torch.zeros_like(noise).scatter_add(-1, run, kept.double())
    n_all = torch.zeros_like(noise).scatter_add(-1, run, torch.ones_like(noise))
    doubt = ((excl - top_ps[:, None]).abs() <= nucleus_tol) | \
        ((n_kept.gather(-1, run) > 0) & (n_kept.gather(-1, run) < n_all.gather(-1, run)))
    doubt[:, 0] = False
    win = (noise + sl).masked_fill(~kept, float("-inf")).argmax(-1, keepdim=True)
    low = (sl + lo_g.gather(-1, run) - tau).gather(-1, win)[:, 0]
    high = (sl + hi_g.gather(-1, run) + tau).masked_fill(~(kept | doubt), float("-inf"))
    margin = low - high.scatter(-1, win, float("-inf")).amax(-1)
    return torch.where(doubt.gather(-1, win)[:, 0], torch.full_like(margin, float("-inf")),
                       margin)


def sample_margins(logits, temps, top_ps, seeds, counts, tol=0.0,
                   nucleus_tol: float = NUCLEUS_TOL) -> np.ndarray:
    """``decided_by`` of the port's own draws when every logit may move by
    up to ``tol`` (a float, or one per lane); a greedy lane's is the top-2
    logits gap minus ``2·tol``.  → [B] float64."""
    _, sl, noise, excl = _gumbel_scores(logits, temps, top_ps, seeds, counts)
    tol = torch.as_tensor(tol, dtype=torch.float64, device=sl.device)
    tau = (tol / temps.double().clamp(min=1e-6)).reshape(-1, 1)
    margin = decided_by(sl, noise, excl, top_ps, tau, nucleus_tol)
    top = torch.topk(logits.double(), 2, dim=-1).values
    return torch.where(temps > 0, margin, top[:, 0] - top[:, 1] - 2 * tol).cpu().numpy()


def flip_distance(logits, temps, top_ps, seeds, counts, hi: float = 10.0) -> np.ndarray:
    """The smallest move of the logits (each by at most this much) that may
    change each lane's token, from ``sample_margins`` by bisection: half
    the top-2 gap for a greedy lane.  → [B] float64 in [0, hi]."""
    lo_t, hi_t = np.zeros(len(temps)), np.full(len(temps), hi)
    for _ in range(40):
        mid = (lo_t + hi_t) / 2
        ok = sample_margins(logits, temps, top_ps, seeds, counts, mid) > 0
        lo_t, hi_t = np.where(ok, mid, lo_t), np.where(ok, hi_t, mid)
    return lo_t
