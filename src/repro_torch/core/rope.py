"""Rotary position embeddings, including EliteKV's per-head partial RoPE.

Conventions (same as the JAX package):

* Interleaved pairing: chunk ``i`` of a head vector is ``(x[2i], x[2i+1])``.
* Chunk ``i`` carries frequency ``theta_i = base ** (-2 i / d_h)`` — chunk 0
  is the highest frequency.
* EliteKV models store, per KV head, the ``r`` elite frequencies
  (``elite_freqs`` — theta values, not indices; projection columns are
  permuted so elite chunks occupy the first ``2r`` dims).

Angles are computed in f32.  All rotations are one function, the
``rope_elite`` kernel's: the full RoPE is the elite rotation with
``chunk_freqs`` shared by all heads, and the RoPElite search's masked
rotation (``apply_rope_subset``) the same with masked frequencies set to
0.  A layer rotates its q and k in one call (``apply_rope_qk``; EliteKV's
attention calls ``kernels.ops.rope_elite_qk`` itself), which launches the
kernel for a CUDA tensor and runs the plain math (``kernels/ref.py``:
``cos_sin``, ``rotate``) for a CPU one.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import cos_sin  # noqa: F401  (the plain tables)


def chunk_freqs(d_head: int, theta: float = 10000.0, device="cuda") -> torch.Tensor:
    """theta_i for each 2-D chunk: shape [d_head // 2], descending frequency."""
    i = torch.arange(d_head // 2, dtype=torch.float32, device=device)
    return theta ** (-2.0 * i / d_head)


@functools.lru_cache(maxsize=16)
def _full_freqs(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """``chunk_freqs`` built once per (head dim, theta, device): the full
    RoPE rotates q and k in every layer with the same table."""
    return chunk_freqs(d_head, theta, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Full RoPE.  x: [B, S, H, D]; positions: [B, S] or [S]."""
    H, D = x.shape[-2:]
    f = _full_freqs(D, float(theta), x.device)
    return ops.rope_elite(x, positions, f.expand(H, D // 2))


def apply_rope_subset(x: torch.Tensor, positions: torch.Tensor, theta: float,
                      chunk_mask: torch.Tensor) -> torch.Tensor:
    """RoPE applied only where ``chunk_mask`` is True (per-head masks
    allowed); the other chunks pass through unrotated (the RoPElite
    "linear" dims).  x: [B, S, H, D]; chunk_mask: [C] or [H, C] booleans;
    positions: [B, S] or [S].

    One ``rope_elite`` call with each head's frequencies times its mask: a
    zero frequency gives the angle 0, so cos = 1 and sin = 0 exactly, which
    is the reference's masked rotation ``cos·m + (1 − m)``, ``sin·m``."""
    H, D = x.shape[-2:]
    f = _full_freqs(D, float(theta), x.device)
    m = chunk_mask.to(device=x.device, dtype=torch.float32)
    return ops.rope_elite(x, positions, (f * m).expand(H, D // 2).contiguous())


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float):
    """Full RoPE of a layer's q [B,S,nh,D] and k [B,S,nkv,D] in one call;
    positions [B,S] or [S].  → (q_rot, k_rot), contiguous."""
    D = q.shape[-1]
    f = _full_freqs(D, float(theta), q.device)[None]              # [1, D/2]
    return ops.rope_elite_qk(q, k, positions, f, q.shape[-2], k.shape[-2])


def apply_elite_rope(x: torch.Tensor, positions: torch.Tensor,
                     elite_freqs: torch.Tensor) -> torch.Tensor:
    """Per-head RoPE over the packed elite dims.

    x: [B, S, H, 2r] — the elite slice (may be a strided view);
    elite_freqs: [H, r] (theta values per head).  positions: [S] or [B, S].
    → a new contiguous [B, S, H, 2r] tensor.
    """
    return ops.rope_elite(x, positions, elite_freqs)


def expand_kv_to_q(per_kv: torch.Tensor, q_group: int) -> torch.Tensor:
    """[n_kv, ...] → [n_kv * q_group, ...]: query head h uses kv head h // q_group."""
    return torch.repeat_interleave(per_kv, q_group, dim=0)
