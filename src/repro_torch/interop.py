"""Carry the JAX package's weights and optimizer state into the port.

The JAX model's ``(params, buffers)`` and AdamW state arrive as nested dicts
of **numpy** arrays (a caller holding JAX arrays maps ``np.asarray`` over
them first), so the port never sees a JAX type; a bf16 array arrives as
2-byte records, which is what numpy makes of one, and becomes a bf16
tensor.  The reference groups layers into superblocks of ``P =
cfg.block_period`` positions and stacks position ``pos`` of every
superblock along a leading ``n_super`` axis under
``params["blocks"]["p{pos}"]``; the port keeps one dict per layer in
absolute order, so reference ``p{pos}`` entry ``s`` becomes port layer
``s·P + pos`` (attention or Mamba mixer, MLP or MoE FFN alike; a position's
buffers are ``{}`` where it holds no attention).  Leaf names are unchanged.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (2-byte records: bf16) → a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:       # bf16 (as 2-byte records)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layer(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    return tensor_from_numpy(tree[i], device)


def _whole(tree, device):
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _layers(tree, cfg, device):
    """The stacked ``blocks/p{pos}`` entries → one dict per layer, in
    absolute layer order."""
    P = cfg.block_period
    want = {f"p{pos}" for pos in range(P)}
    if set(tree["blocks"]) != want:
        raise ValueError(f"expected layer positions {sorted(want)}, got "
                         f"{sorted(tree['blocks'])}")
    return [_layer(tree["blocks"][f"p{i % P}"], i // P, device)
            for i in range(cfg.num_layers)]


def params_tree_from_reference(tree: Dict, cfg, device="cuda") -> Dict:
    """A tree of the reference params' structure (the params themselves,
    their grads, or an AdamW moment, whose leaves may be int8 ``{"q", "s"}``
    pairs) → the port's layout: the stacked ``blocks/p{pos}`` axes
    unstacked into ``layers``, every other entry carried whole."""
    out = {k: _whole(v, device) for k, v in tree.items() if k != "blocks"}
    out["layers"] = _layers(tree, cfg, device)
    return out


def from_reference(params: Dict, buffers: Dict, cfg, device="cuda") -> Tuple[Dict, Dict]:
    """Reference (params, buffers) of numpy arrays → the port's layout on
    ``device``; ``embed`` and ``lm_head`` are carried where the model has
    them (a tied model has no ``lm_head``, an audio model no ``embed``)."""
    return (params_tree_from_reference(params, cfg, device),
            {"layers": _layers(buffers, cfg, device)})


def opt_state_from_reference(opt_state: Dict, cfg, device="cuda") -> Dict:
    """The reference's AdamW state (``adamw.init``/``train_loop``'s:
    ``step``, moments ``m``/``v`` as f32, bf16 or int8 ``{"q", "s"}``
    leaves, and ``err`` with gradient compression) of numpy arrays → the
    port's, with the params' unstacking."""
    out = {"step": tensor_from_numpy(opt_state["step"], device).to(torch.int32)}
    for name in ("m", "v", "err"):
        if name in opt_state:
            out[name] = params_tree_from_reference(opt_state[name], cfg, device)
    return out
