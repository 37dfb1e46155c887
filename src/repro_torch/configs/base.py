"""Model configuration for the PyTorch port: EliteKV hyper-parameters and the
decoder-only architecture description, plus the ``--arch`` registry.

Counterpart of ``repro/configs/base.py``: dense attention + SwiGLU-MLP
stacks with the LM head tied to the embedding table or not, mixture-of-
experts FFNs (``n_experts``/``top_k``, Arctic's ``dense_residual``), Mamba
layers and attention/Mamba hybrids (``ssm_state``, ``attn_period``), and the
training knobs (query-chunked attention, sequence-chunked loss, layer
remat).  Layer ``i``'s mixer is ``layer_kind(i)`` ("attn" or "ssm") and its
FFN ``ffn_kind(i)`` ("mlp", "moe" or "none"); both repeat every
``block_period`` layers.  The frontends are stubs, as in the reference: a
vision model (``frontend="vision"``) takes ``n_frontend_tokens`` precomputed
patch embeddings before its text, an audio model (``"audio"``) takes
precomputed frame embeddings and has no token embedding; ``make_inputs``
draws the reference's seeded batches.  The shape cells of the dry run
(``ShapeConfig``, ``SHAPES``, ``cell_applicable``) and its shape-only
inputs (``input_specs``: meta tensors) are the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
    """Architecture of a decoder-only LM: attention or Mamba mixers, MLP or
    MoE FFNs."""

    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "dense"            # dense | moe | ssm | hybrid | audio | vlm
    d_head: Optional[int] = None     # explicit head dim; default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dff: Optional[int] = None    # expert hidden dim (defaults to d_ff)
    dense_residual: bool = False     # arctic: parallel dense MLP + MoE
    moe_every: int = 1               # FFN of layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0               # mamba d_state (0 = no mamba layers)
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_period: int = 1             # hybrid: layer i is attention iff i % attn_period == attn_offset
    attn_offset: int = 0             # (attn_period=1 → all-attention; 0 attn layers for pure ssm)
    dt_rank: Optional[int] = None    # mamba Δ rank (default ceil(d_model/16))

    # --- frontends (stubs: precomputed embeddings) ---
    frontend: str = "none"           # none | audio | vision
    n_frontend_tokens: int = 0       # vision: number of patch tokens prepended

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False     # logits = h @ embed.table^T, no lm_head
    attn_chunk_q: Optional[int] = None   # training attention: None = chunk at S >= 4096
    ssm_chunk: int = 128                 # mamba scan chunk length
    ssm_unroll: bool = False             # no per-chunk recompute of the mamba scan
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer index i."""
        if self.ssm_state == 0:
            return "attn"
        if self.attn_period <= 0:
            return "ssm"
        return "attn" if (i % self.attn_period == self.attn_offset and self.family != "ssm") else "ssm"

    def ffn_kind(self, i: int) -> str:
        """'moe', 'mlp' or 'none' for layer index i."""
        if self.d_ff == 0 and self.n_experts == 0:
            return "none"
        if self.n_experts > 0 and (i % self.moe_every == self.moe_offset):
            return "moe"
        return "mlp" if self.d_ff > 0 else "none"

    @property
    def block_period(self) -> int:
        """Smallest period after which (layer_kind, ffn_kind) repeats."""
        p = 1
        if self.ssm_state and self.attn_period > 1:
            p = np.lcm(p, self.attn_period)
        if self.n_experts and self.moe_every > 1:
            p = np.lcm(p, self.moe_every)
        return int(p)

    @property
    def attn_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers) if self.layer_kind(i) == "attn")

    @property
    def n_attn_layers(self) -> int:
        return len(self.attn_layer_indices)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied; an
        audio model has no embedding table and always an LM head)."""
        d, dh = self.d_model, self.head_dim
        n_vocab_mats = ((0 if self.frontend == "audio" else 1)
                        + (1 if (self.frontend == "audio" or not self.tie_embeddings) else 0))
        total = self.vocab_size * d * n_vocab_mats
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                e = self.elitekv
                if e.enabled:
                    r2 = 2 * e.elite_r
                    nope = self.n_kv_heads * (dh - r2)
                    total += d * self.n_heads * dh               # W^q
                    total += d * self.n_kv_heads * r2            # W^k elite
                    if e.lrd == "joint":
                        total += d * e.d_ckv + e.d_ckv * (nope + self.n_kv_heads * dh)
                    else:
                        total += d * e.d_ck + e.d_ck * nope
                        total += d * e.d_cv + e.d_cv * self.n_kv_heads * dh
                    total += self.n_heads * dh * d               # W^o
                else:
                    total += d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
                total += d  # attn norm
            else:  # mamba block
                di = self.d_inner
                dtr = self.dt_rank or -(-d // 16)
                total += d * 2 * di                    # in_proj (x, z)
                total += di * self.ssm_conv + di       # conv weight + bias
                total += di * (dtr + 2 * self.ssm_state)  # x_proj -> (dt, B, C)
                total += dtr * di + di                 # dt_proj
                total += di * self.ssm_state + di      # A_log, D
                total += di * d                        # out_proj
                total += d                             # norm
            fk = self.ffn_kind(i)
            if fk == "mlp":
                total += 3 * d * self.d_ff + d
            elif fk == "moe":
                mdff = self.moe_dff or self.d_ff
                total += self.n_experts * 3 * d * mdff + d * self.n_experts + d
                if self.dense_residual:
                    total += 3 * d * self.d_ff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        mdff = self.moe_dff or self.d_ff
        total = self.param_count()
        for i in range(self.num_layers):
            if self.ffn_kind(i) == "moe":
                total -= (self.n_experts - self.top_k) * 3 * self.d_model * mdff
        return total

    def kv_cache_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Whole-model attention cache bytes per token (Mamba states are per
        sequence, not per token)."""
        per = self.elitekv.cache_per_token_per_layer(self.n_kv_heads, self.head_dim)
        return self.n_attn_layers * per * dtype_bytes

    def with_elitekv(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, elitekv=dataclasses.replace(self.elitekv, enabled=True, **kw))

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's reduced
        widths): two block periods deep."""
        base = dict(
            num_layers=min(self.num_layers, 2 * self.block_period),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            d_head=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_dff=128 if self.n_experts else None,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            elitekv=dataclasses.replace(
                self.elitekv, elite_r=4, d_ckv=64, d_ck=32, d_cv=32),
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def make_inputs(cfg: ModelConfig, batch: int, seq: int, kind: str,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Small seeded inputs, drawn as the reference's ``make_inputs`` draws
    them from ``np.random.default_rng(seed)`` (the same values; ids as
    int64, embeddings f32), as numpy arrays: the caller moves them to
    tensors.  ``seq`` counts every position: a vision batch holds
    ``n_frontend_tokens`` patch embeddings and ``seq - n_frontend_tokens``
    tokens; an audio batch holds ``frames`` [batch, seq, d_model].
    ``kind == "train"`` adds ``labels`` for the text (or frame) positions."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    def embeds(n):
        return rng.standard_normal((batch, n, cfg.d_model), dtype=np.float32) * 0.02

    def ids(n):
        return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int64)

    if cfg.frontend == "audio":
        out["frames"] = embeds(seq)
        n_text = seq
    elif cfg.frontend == "vision":
        out["patch_embeds"] = embeds(cfg.n_frontend_tokens)
        n_text = seq - cfg.n_frontend_tokens
        out["tokens"] = ids(n_text)
    else:
        n_text = seq
        out["tokens"] = ids(n_text)
    if kind == "train":
        out["labels"] = ids(n_text)
    return out


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) runs; long_500k skips pure full-attention archs."""
    if shape.name == "long_500k" and cfg.ssm_state == 0:
        return False, "long_500k skipped: pure full-attention arch (needs sub-quadratic path)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins for every model input: ``torch.empty`` on the
    meta device, which allocates nothing (the reference's
    ``ShapeDtypeStruct``s).  Ids are int64, as ``make_inputs`` gives them;
    embeddings ``dtype``.  A frontend's encoder is a stub, as in the
    reference: the backbone takes precomputed frame or patch embeddings."""
    B, S = shape.global_batch, shape.seq_len
    emb = lambda n: torch.empty((B, n, cfg.d_model), dtype=dtype, device="meta")
    ids = lambda n: torch.empty((B, n), dtype=torch.int64, device="meta")
    nv = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":          # one new token against a cache of S
        if cfg.frontend == "audio":
            specs["frames"] = emb(1)
        else:
            specs["tokens"] = ids(1)
        return specs
    if cfg.frontend == "audio":
        specs["frames"] = emb(S)
    else:
        if nv:
            specs["patch_embeds"] = emb(nv)
        specs["tokens"] = ids(S - nv)
    if shape.kind == "train":
        specs["labels"] = ids(S - nv)
    return specs


ARCH_IDS = ("tinyllama_1_1b", "llama2_7b", "llama2_13b", "yi_6b", "granite_3_2b",
            "minicpm_2b", "qwen3_moe_235b", "arctic_480b", "jamba_v0_1_52b",
            "falcon_mamba_7b", "internvl2_2b", "musicgen_large")


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
