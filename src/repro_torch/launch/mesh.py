"""The production mesh shapes, and where serving replicas are placed.

The port's counterpart of the JAX package's ``launch/mesh.py``.
``production_mesh_axes`` gives ``make_production_mesh``'s shapes as
``{axis name: size}``: 16 × 16 = 256 chips per pod, and a "pod" axis of 2
in front for two pods; ``distributed/sharding.py`` sizes what each device
holds from them.

``serving_devices``/``replica_devices`` are the counterparts of
``make_serving_mesh``/``replica_meshes``: the devices of each
data-parallel replica behind ``runtime/router.py``.  A bare ``"cuda"``
spreads the replicas over the visible cards, replica ``i`` on ``cuda:i``;
an explicit device (``"cuda:0"``, ``"cpu"``) places every replica on it —
the port's stand-in for the reference's forced host-device count, which is
how one card or the CPU serves ``dp > 1``.  Tensor-parallel *serving*
(``tp > 1`` replicas behind the scheduler and the launcher) is ROADMAP item
15b.2 and raises ``ValueError``.

``TPMesh`` is one replica's ``("model",)`` submesh: the ``tp`` devices its
attention heads are split over, head shard ``r`` on ``devices[r]``.  The
port's tensor parallelism is single-controller, as the reference's
``shard_map`` is: one process drives every shard, and a shard's device may
repeat (every shard on ``cuda:0`` on one card, on ``cpu`` in the tests).
The paged pool (``core/cache.py``), the paged forwards (``models/lm.py``)
and the head-sharded attention wrappers (``kernels/ops.py``) take it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

TP_NOT_PORTED = ("tensor-parallel serving (tp > 1) is not ported yet: ROADMAP "
                 "Queue 1 item 15b.2 (the Scheduler's mesh, serving_devices(tp > 1), "
                 "the launcher's --tp and sharded_check --tp/--parity)")


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The devices of one replica's head shards: shard ``r`` on
    ``devices[r]``; repeats allowed.  ``tp = len(devices)``."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a TPMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def tp(self) -> int:
        return len(self.devices)

    @classmethod
    def on(cls, device, tp: int) -> "TPMesh":
        """``tp`` shards, every one on ``device``."""
        return cls((torch.device(device),) * tp)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def production_mesh_axes(*, multi_pod: bool = False) -> Dict[str, int]:
    """16×16 ``("data", "model")``; ``multi_pod`` adds ``"pod"`` = 2 in front."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def serving_devices(tp: int = 1, dp: int = 1, device="cuda") -> List[List[torch.device]]:
    """The ``(dp, tp)`` serving layout: one list of ``tp`` devices per
    replica.  A bare ``"cuda"`` takes the first ``dp * tp`` visible cards
    (replica ``i`` on ``cuda:i``); any other device hosts every replica."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp and dp must be >= 1, got tp={tp} dp={dp}")
    if tp > 1:
        raise ValueError(TP_NOT_PORTED)
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [[dev] for _ in range(dp)]
    need = dp * tp
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if need > visible:
        raise ValueError(
            f"serving mesh needs {need} devices (tp={tp} x dp={dp}) but only "
            f"{visible} are visible; pass an explicit device (cuda:0 or cpu) to "
            f"place every replica on it")
    return [[torch.device("cuda", i * tp + j) for j in range(tp)] for i in range(dp)]


def replica_devices(dp: int = 1, device="cuda", tp: int = 1) -> List[torch.device]:
    """One device per data-parallel replica (``tp == 1``)."""
    return [devs[0] for devs in serving_devices(tp=tp, dp=dp, device=device)]
