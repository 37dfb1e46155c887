"""Atomic, resumable checkpointing (npz shards + a JSON manifest).

The port's own copy of the JAX package's ``checkpoint/checkpointer.py``,
with the same layout and contract, so each package reads the other's
directories:

    <dir>/step_00000123/
        manifest.json          — step, flat key list, extra
        arrays_h000.npz        — this host's copy of every leaf
        _COMMITTED             — written last; a checkpoint without it is
                                 garbage (crash mid-write) and is ignored

  * save is atomic: write to step_xxx.tmp, fsync the manifest, rename, then
    ``_COMMITTED``.
  * ``restore_latest()`` takes the newest committed step, so a job that
    dies anywhere (mid-save too) restarts from the last good step.
  * ``keep_last`` bounds disk use; older committed steps are pruned.

Keys are the tree paths joined by "/" (``params/...``, ``opt/...``): the
port's trees give ``params/layers/3/attn/wq``, the reference's stacked
ones ``params/blocks/p0/attn/wq``.  ``restore`` rebuilds the tree from the
keys alone, as tensors on a device (a dict whose keys are all digits
becomes a list: the port's layers), or as numpy arrays with
``as_numpy=True``, which is how a checkpoint of the JAX package is read
(``interop`` then carries its trees across).  bf16 leaves are stored as
2-byte records, which is what numpy makes of a JAX bf16 array, so both
packages' bf16 read back the same way.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.interop import tensor_from_numpy
from repro_torch.tree import items


def _to_numpy(t) -> np.ndarray:
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # 2-byte records, as JAX's bf16 saves
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = leaf
    return out


def _listify(tree):
    """Dicts whose keys are all digits → lists (in index order)."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _listify(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3, host_id: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.host_id = host_id

    # ------------------------------------------------------------------
    def save(self, params, opt_state, extra: Dict[str, Any]):
        step = int(extra["step"])
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        flat = dict(items({"params": params, "opt": opt_state}))
        arrays = {k: _to_numpy(v) for k, v in flat.items()}
        np.savez(tmp / f"arrays_h{self.host_id:03d}.npz", **arrays)
        manifest = {
            "step": step,
            "extra": {k: v for k, v in extra.items() if k != "step"},
            "keys": sorted(arrays.keys()),
            "treedef": None,
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (final / "_COMMITTED").touch()
        self._prune()
        return final

    def _prune(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def committed_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "_COMMITTED").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return out

    def restore(self, step: int, device="cuda", as_numpy: bool = False):
        """(params, opt_state, extra) of a committed step: tensors on
        ``device`` in the port's trees, or with ``as_numpy`` the stored
        numpy arrays as nested dicts (a JAX checkpoint's trees)."""
        d = self.dir / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        with np.load(d / f"arrays_h{self.host_id:03d}.npz") as data:
            flat = {k: data[k] if as_numpy else tensor_from_numpy(data[k], device)
                    for k in manifest["keys"]}
        tree = _nest(flat)
        if not as_numpy:
            tree = _listify(tree)
        extra = dict(manifest["extra"], step=manifest["step"])
        return tree.get("params", {}), tree.get("opt", {}), extra

    def restore_latest(self, device="cuda", as_numpy: bool = False):
        steps = self.committed_steps()
        if not steps:
            return None
        return self.restore(steps[-1], device=device, as_numpy=as_numpy)
