"""Carry the JAX package's weights into the port.

The JAX model's ``(params, buffers)`` arrive as nested dicts of **numpy**
arrays (a caller holding JAX arrays maps ``np.asarray`` over them first), so
the port never sees a JAX type.  The reference stacks layers along a leading
``n_super`` axis under ``params["blocks"]["p0"]``; the port keeps one dict
per layer, so that axis is unstacked here.  Leaf names are unchanged.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layer(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    return _tensor(tree[i], device)


def from_reference(params: Dict, buffers: Dict, cfg, device="cuda") -> Tuple[Dict, Dict]:
    """Reference (params, buffers) of numpy arrays → the port's layout on
    ``device``.  Only single-position superblocks (attention + MLP stacks)
    exist in the port; ``lm_head`` is carried where the model has one (a
    tied model has none)."""
    blocks, bufs = params["blocks"], buffers["blocks"]
    if set(blocks) != {"p0"}:
        raise ValueError(f"expected one layer position, got {sorted(blocks)}")
    n = cfg.num_layers
    out = {"embed": {"table": _tensor(params["embed"]["table"], device)}}
    if "lm_head" in params:
        out["lm_head"] = {"w": _tensor(params["lm_head"]["w"], device)}
    out.update(final_norm={"scale": _tensor(params["final_norm"]["scale"], device)},
               layers=[_layer(blocks["p0"], i, device) for i in range(n)])
    return out, {"layers": [_layer(bufs["p0"], i, device) for i in range(n)]}
