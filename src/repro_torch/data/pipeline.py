"""Token data pipeline: deterministic synthetic corpus + file-backed shards.

The port's own copy of the JAX package's ``data/pipeline.py``: the numpy
token stream is the reference's bit for bit; batches come out as torch
tensors on the pipeline's device (tokens and labels int64, ``loss_mask``
f32).

Design goals (the things that matter at 1000-node scale):
  * deterministic & resumable — iterator state is (epoch, step); restoring a
    checkpoint restores the exact batch stream, so restarts don't skew data.
  * per-host sharding — each data-parallel host reads only its slice
    (``host_id``/``num_hosts``); no coordinator.
  * loss masking + next-token shifting handled here, not in the model.

The synthetic corpus is a fixed-seed Zipf-ish Markov stream — enough
structure that perplexity falls during uptraining (benchmarks/fig6) while
remaining fully offline and reproducible.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int                  # per-host batch
    seed: int = 0
    kind: str = "synthetic"          # synthetic | file
    path: Optional[str] = None       # token shard dir for kind="file"
    host_id: int = 0
    num_hosts: int = 1


class SyntheticCorpus:
    """Markov-chain token stream with a Zipf marginal — deterministic."""

    def __init__(self, vocab: int, seed: int = 0, order_mix: float = 0.7):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        k = min(vocab, 64)
        # sparse transition structure: each token prefers k successors
        self.succ = rng.integers(0, vocab, size=(vocab, k))
        self.succ_p = rng.dirichlet(np.ones(k) * 0.5, size=vocab)
        self.zipf_p = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self.zipf_p /= self.zipf_p.sum()
        self.order_mix = order_mix

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        tok = int(rng.integers(0, self.vocab))
        for i in range(n):
            out[i] = tok
            if rng.random() < self.order_mix:
                j = rng.choice(self.succ.shape[1], p=self.succ_p[tok])
                tok = int(self.succ[tok, j])
            else:
                tok = int(rng.choice(self.vocab, p=self.zipf_p))
        return out


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    step: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class TokenPipeline:
    """Resumable batch iterator.

    Every (host, epoch, step) triple maps to one deterministic RNG stream, so
    resume == replay and elastic re-sharding (num_hosts change) only requires
    re-deriving host slices.
    """

    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None,
                 device="cuda"):
        self.cfg = cfg
        self.state = state or PipelineState()
        self.device = torch.device(device)
        if cfg.kind == "synthetic":
            self.corpus = SyntheticCorpus(cfg.vocab_size, cfg.seed)
            self._shards = None
        else:
            self._shards = sorted(Path(cfg.path).glob("*.npy"))
            if not self._shards:
                raise FileNotFoundError(f"no .npy token shards under {cfg.path}")
            self.corpus = None

    # -- deterministic per-(host, epoch, step) randomness --
    def _rng(self) -> np.random.Generator:
        s = (self.cfg.seed * 1_000_003
             + self.state.epoch * 7_919
             + self.state.step * 104_729
             + self.cfg.host_id)
        return np.random.default_rng(s)

    def _tokens(self, rng) -> np.ndarray:
        B, L = self.cfg.batch_size, self.cfg.seq_len + 1
        if self.corpus is not None:
            return np.stack([self.corpus.sample(rng, L) for _ in range(B)])
        # file mode: random window reads from this host's shard slice
        shards = self._shards[self.cfg.host_id::self.cfg.num_hosts] or self._shards
        out = np.empty((B, L), np.int32)
        for b in range(B):
            arr = np.load(shards[int(rng.integers(len(shards)))], mmap_mode="r")
            start = int(rng.integers(0, max(1, len(arr) - L)))
            seg = np.asarray(arr[start:start + L], np.int32)
            if len(seg) < L:
                seg = np.pad(seg, (0, L - len(seg)), mode="wrap")
            out[b] = seg % self.cfg.vocab_size
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        rng = self._rng()
        toks = torch.from_numpy(self._tokens(rng).astype(np.int64)).to(self.device)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": torch.ones((toks.shape[0], toks.shape[1] - 1),
                                    dtype=torch.float32, device=self.device),
        }
        self.state.step += 1
        if self.state.step % 10_000 == 0:
            self.state.epoch += 1
        return batch


def write_token_shards(tokens: np.ndarray, out_dir: str, shard_size: int = 1 << 20):
    """Utility: dump a token array into .npy shards for kind="file"."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(0, len(tokens), shard_size):
        np.save(out / f"shard_{i // shard_size:05d}.npy",
                tokens[i:i + shard_size].astype(np.int32))
