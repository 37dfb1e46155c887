"""Model configuration for the PyTorch port: EliteKV hyper-parameters and the
decoder-only architecture description, plus the ``--arch`` registry.

Counterpart of ``repro/configs/base.py``, cut to what the port's dense
architectures read: attention + SwiGLU-MLP stacks, with the LM head tied to
the embedding table or not, and the training knobs (query-chunked
attention, sequence-chunked loss, layer remat); no MoE, SSM or frontend
fields, no shape cells or dry-run input specs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class EliteKVConfig:
    """EliteKV (paper) hyper-parameters.

    ``elite_r``  — number of 2-D RoPE chunks kept (rotated) per KV head.
    ``d_ckv``    — rank of the joint low-rank latent (shared K/V cache dim).
    ``lrd``      — "joint" (J-LRD, the paper's choice) or "separate" (S-LRD).
    ``d_ck/d_cv``— S-LRD ranks (ignored for J-LRD).
    """

    enabled: bool = False
    elite_r: int = 8
    d_ckv: int = 512
    lrd: str = "joint"
    d_ck: int = 256
    d_cv: int = 256

    def cache_per_token_per_layer(self, n_kv: int, d_head: int) -> int:
        """Floats of cache per token per attention layer (paper §3.2)."""
        if not self.enabled:
            return 2 * n_kv * d_head
        rot = 2 * self.elite_r * n_kv
        if self.lrd == "joint":
            return rot + self.d_ckv
        return rot + self.d_ck + self.d_cv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of an attention + MLP decoder-only LM."""

    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None     # explicit head dim; default d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False     # logits = h @ embed.table^T, no lm_head
    attn_chunk_q: Optional[int] = None   # training attention: None = chunk at S >= 4096
    loss_chunk: int = 0                  # seq-chunked CE (never the whole [B,S,V] logits)
    remat: bool = True                   # recompute layers in the backward
    remat_policy: str = "full"           # full (recompute the layer) | dots | none
    dtype: Any = torch.float32
    elitekv: EliteKVConfig = dataclasses.field(default_factory=EliteKVConfig)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; padded logit columns are
        masked to -1e30 so they never win an argmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_elitekv(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, elitekv=dataclasses.replace(self.elitekv, enabled=True, **kw))

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny config for CPU tests (the reference's reduced widths)."""
        base = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            d_head=32,
            d_ff=256,
            vocab_size=min(self.vocab_size, 512),
            elitekv=dataclasses.replace(
                self.elitekv, elite_r=4, d_ckv=64, d_ck=32, d_cv=32),
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


ARCH_IDS = ("tinyllama_1_1b", "llama2_7b", "llama2_13b", "yi_6b", "granite_3_2b",
            "minicpm_2b")


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
