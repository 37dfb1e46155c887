"""Low-rank decomposition of the KV projections (paper §3.2), and the rank
truncation of the joint factors for the draft model of self-speculative
decode.

J-LRD (the paper's choice): jointly factorize
    W^kv = [W^k_nonelite(all heads), W^v(all heads)]  ≈  A^kv · B^kv,
    B^kv = [B^k_J, B^v_J]
so K-up and V-up share one latent — cache/token/layer = 2·r·n_kv + d_ckv.
S-LRD (ablation): factorize W^k_nonelite and W^v separately with ranks
(d_ck, d_cv); ``optimal_slrd_split`` picks the error-minimizing split of a
cache budget from the two singular spectra.

Counterpart of the JAX package's ``core/lrd.py``.  The factorizations
are float64 SVDs (``torch.linalg.svd``) on the weights' device: the
card's where a model converts there (a [2048, 3584] MusicGen-large layer
takes ~0.4 s there against ~4 s in numpy on the host), the host for numpy
arrays and CPU tensors.  The factors return as float32 numpy arrays, which
``core/convert.py`` puts on the model's device; the error measures and
the S-LRD split stay numpy float64, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _f64(w) -> np.ndarray:
    """A numpy float64 copy of ``w`` (numpy array or tensor on any device)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, np.float64)


def _device(*ws) -> torch.device:
    """The first tensor argument's device; the host if there is none."""
    return next((w.device for w in ws if isinstance(w, torch.Tensor)), torch.device("cpu"))


def _t64(w, device) -> torch.Tensor:
    """``w`` (numpy array or tensor) as a float64 tensor on ``device``."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.asarray(w))
    return w.detach().to(device=device, dtype=torch.float64)


def svd_lowrank(W, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """W [m,n] ≈ A [m,rank] @ B [rank,n]   (A = U, B = Σ Vᵀ as in paper §2.3),
    a float64 SVD on W's device; float32 numpy factors."""
    U, s, Vt = torch.linalg.svd(_t64(W, _device(W)), full_matrices=False)
    return (U[:, :rank].float().cpu().numpy(),
            (s[:rank, None] * Vt[:rank, :]).float().cpu().numpy())


def jlrd(wk_ne, wv, d_ckv: int):
    """Joint factorization, on the device of the first tensor argument.

    wk_ne [d, n_kv, d_nope]; wv [d, n_kv, d_h]
    → a_kv [d, d_ckv], bk [d_ckv, n_kv, d_nope], bv [d_ckv, n_kv, d_h]
    """
    dev = _device(wk_ne, wv)
    wk_ne, wv = _t64(wk_ne, dev), _t64(wv, dev)
    d, nkv, d_nope = wk_ne.shape
    dh = wv.shape[2]
    W = torch.cat([wk_ne.reshape(d, nkv * d_nope), wv.reshape(d, nkv * dh)], dim=1)
    A, B = svd_lowrank(W, d_ckv)
    return (A, B[:, :nkv * d_nope].reshape(d_ckv, nkv, d_nope),
            B[:, nkv * d_nope:].reshape(d_ckv, nkv, dh))


def slrd(wk_ne, wv, d_ck: int, d_cv: int):
    """Separate factorizations, on the device of the first tensor argument
    → (a_k [d, d_ck], a_v [d, d_cv], bk [d_ck, n_kv, d_nope],
    bv [d_cv, n_kv, d_h])."""
    dev = _device(wk_ne, wv)
    wk_ne, wv = _t64(wk_ne, dev), _t64(wv, dev)
    d, nkv, d_nope = wk_ne.shape
    dh = wv.shape[2]
    a_k, Bk = svd_lowrank(wk_ne.reshape(d, nkv * d_nope), d_ck)
    a_v, Bv = svd_lowrank(wv.reshape(d, nkv * dh), d_cv)
    return a_k, a_v, Bk.reshape(d_ck, nkv, d_nope), Bv.reshape(d_cv, nkv, dh)


def reconstruction_error(W, A, B) -> float:
    """‖W − A·B‖_F / ‖W‖_F, in float64."""
    W = _f64(W)
    R = W - _f64(A) @ _f64(B)
    return float(np.linalg.norm(R) / max(np.linalg.norm(W), 1e-12))


def optimal_slrd_split(wk_ne, wv, budget: int, align: int = 1) -> Tuple[int, int]:
    """Best (d_ck, d_cv) with d_ck + d_cv = budget, minimizing the total
    squared reconstruction error  Σ_{i>d_ck} σ_k,i² + Σ_{i>d_cv} σ_v,i²."""
    wk_ne, wv = _f64(wk_ne), _f64(wv)
    d = wk_ne.shape[0]
    sk = np.linalg.svd(wk_ne.reshape(d, -1), compute_uv=False)
    sv = np.linalg.svd(wv.reshape(d, -1), compute_uv=False)
    tail = lambda s, r: float(np.sum(s[r:] ** 2))
    best, best_err = None, np.inf
    for ck in range(align, budget, align):
        cv = budget - ck
        if cv < 1 or ck > len(sk) or cv > len(sv):
            continue
        err = tail(sk, ck) + tail(sv, cv)
        if err < best_err:
            best, best_err = (ck, cv), err
    assert best is not None
    return best


def truncate_joint_rank(bk: np.ndarray, bv: np.ndarray, rank: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Project the joint up-projection onto its top ``rank`` left singular
    directions.

    bk [d_ckv, n_kv, d_nope]; bv [d_ckv, n_kv, d_h].  With
    ``B = [bk | bv]`` [d_ckv, m] and ``P`` its top-``rank`` left singular
    vectors [d_ckv, rank], returns ``bk' = P Pᵀ bk`` and ``bv' = P Pᵀ bv``
    in the inputs' shapes and dtypes: only their rank drops, so the draft
    reads the same d_ckv-wide latent the full model writes.  ``P Pᵀ`` does
    not depend on the signs the SVD picks, and is unique wherever
    ``σ_rank > σ_rank+1``.  ``rank >= d_ckv`` returns the inputs unchanged.
    """
    d_ckv = bk.shape[0]
    if rank >= d_ckv:
        return bk, bv
    Bk = np.asarray(bk, np.float64).reshape(d_ckv, -1)
    Bv = np.asarray(bv, np.float64).reshape(d_ckv, -1)
    U, _, _ = np.linalg.svd(np.concatenate([Bk, Bv], axis=1), full_matrices=False)
    proj = U[:, :rank] @ U[:, :rank].T                       # [d_ckv, d_ckv]
    bk_r = (proj @ Bk).reshape(bk.shape).astype(np.float32).astype(bk.dtype)
    bv_r = (proj @ Bv).reshape(bv.shape).astype(np.float32).astype(bv.dtype)
    return bk_r, bv_r
