"""Rank truncation of the joint low-rank factors, for the draft model of
self-speculative decode.

Counterpart of the JAX package's ``core/lrd.py::truncate_joint_rank`` (the
rest of that module, J-LRD/S-LRD conversion, is ROADMAP Queue 1 item 13).
Plain numpy in float64, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
