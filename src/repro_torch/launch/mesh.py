"""The production mesh shapes, as ``{axis name: size}`` in mesh order.

The port's counterpart of the JAX package's ``launch/mesh.py::
make_production_mesh``: 16 × 16 = 256 chips per pod, and a "pod" axis of
2 in front for two pods.  Only the shapes: ``distributed/sharding.py``
sizes what each device holds from them.  Device meshes, serving meshes and
replica meshes place tensors on cards and are ROADMAP item 15.
"""
from __future__ import annotations

from typing import Dict


def production_mesh_axes(*, multi_pod: bool = False) -> Dict[str, int]:
    """16×16 ``("data", "model")``; ``multi_pod`` adds ``"pod"`` = 2 in front."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}
