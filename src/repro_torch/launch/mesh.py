"""The production and debug meshes, and where serving replicas are placed.

The port's counterpart of the JAX package's ``launch/mesh.py``.
``production_mesh_axes`` gives ``make_production_mesh``'s shapes as
``{axis name: size}``: 16 × 16 = 256 chips per pod, and a "pod" axis of 2
in front for two pods; ``distributed/sharding.py`` sizes what each device
holds from them.

``make_production_mesh`` and ``make_debug_mesh`` build those meshes as
``torch.distributed`` ``DeviceMesh``es over the initialised default process
group, which the sharded train and prefill steps place their tensors on
(``distributed/sharding.py``).  ``fake_group(world)`` initialises a
process group of ``world`` ranks in which this process is rank 0 and every
collective moves no data: the port's counterpart of the reference's 512
placeholder host devices, on which the dry run traces a production mesh's
step (``launch/dryrun.py``).  A real group (gloo on the CPU, NCCL across
cards) is the caller's to initialise, with its address, world size and
rank.

``serving_devices``/``replica_meshes`` are the counterparts of
``make_serving_mesh``/``replica_meshes``: the ``[dp, tp]`` serving layout,
one ``TPMesh`` per data-parallel replica behind ``runtime/router.py``.  A
bare ``"cuda"`` spreads the shards over the visible cards, replica ``i``'s
shard ``j`` on ``cuda:(i·tp + j)``; an explicit device (``"cuda:0"``,
``"cpu"``) hosts every shard of every replica — the port's stand-in for
the reference's forced host-device count, which is how one card or the CPU
serves ``tp > 1`` and ``dp > 1``.  ``replica_devices`` gives each replica's
one device at ``tp == 1``.

``TPMesh`` is one replica's ``("model",)`` submesh: the ``tp`` devices its
attention heads are split over, head shard ``r`` on ``devices[r]``.  The
port's tensor parallelism is single-controller, as the reference's
``shard_map`` is: one process drives every shard, and a shard's device may
repeat (every shard on ``cuda:0`` on one card, on ``cpu`` in the tests).
The ``Scheduler`` (``runtime/serve_loop.py``), the router's replicas, the
paged pool (``core/cache.py``), the paged forwards (``models/lm.py``) and
the head-sharded attention wrappers (``kernels/ops.py``) take it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 × 16 ``("data", "model")`` mesh, or 2 × 16 × 16 with
    ``("pod", "data", "model")``, over the default process group (256 or
    512 ranks: a ``fake_group`` of that size, or real ones)."""
    axes = production_mesh_axes(multi_pod=multi_pod)
    return _device_mesh(device_type, tuple(axes.values()), tuple(axes))


def make_debug_mesh(shape: Optional[Sequence[int]] = None,
                    axes: Sequence[str] = ("data", "model"), device_type: str = "cuda"):
    """A small mesh over the default process group.  The default shape
    follows the group's size, as the reference's follows the device count:
    the largest ``(n // 2, 2)`` grid, or all ones on one process, so no
    group size makes it raise (one process still needs a group: a
    ``fake_group(1)`` or a real one of one rank)."""
    axes = tuple(axes)
    if shape is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        shape = (n // 2, 2) if n >= 2 else (1,) * len(axes)
        shape = tuple(shape[:len(axes)]) + (1,) * (len(axes) - len(shape))
    return _device_mesh(device_type, tuple(shape), axes)


def _device_mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised process group: "
                           "torch.distributed.init_process_group, or fake_group(world)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _register_fake() -> None:
    """Register the ``"fake"`` backend (PyTorch registers it only when its
    test helpers are imported): every collective completes at once and
    moves no data."""
    from torch._C._distributed_c10d import FakeProcessGroup
    dist.Backend.register_backend(
        "fake", lambda common, opts: FakeProcessGroup._create_internal(
            common.group_rank, common.group_size, opts),
        extended_api=True, devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_group(world: int, device_type: str = "cuda") -> Iterator[None]:
    """This process as rank 0 of a ``world``-rank group whose collectives
    move no data (outputs are allocated, never filled from other ranks):
    what one device of a ``world``-chip mesh allocates, launches and sends
    can be measured, its values cannot.  The group is destroyed on exit,
    whatever happens inside; it refuses to start over a group already
    initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already initialised")
    try:
        _register_fake()
        dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
        if device_type == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(0)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def serving_devices(tp: int = 1, dp: int = 1, device="cuda") -> List[List[torch.device]]:
    """The ``(dp, tp)`` serving layout: one list of ``tp`` devices per
    replica.  A bare ``"cuda"`` takes the first ``dp * tp`` visible cards
    (replica ``i``'s shard ``j`` on ``cuda:(i·tp + j)``, ``make_serving_mesh``'s
    ``[dp, tp]`` order); any other device hosts every shard of every replica."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp and dp must be >= 1, got tp={tp} dp={dp}")
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [[dev] * tp for _ in range(dp)]
    need = dp * tp
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if need > visible:
        raise ValueError(
            f"serving mesh needs {need} devices (tp={tp} x dp={dp}) but only "
            f"{visible} are visible; pass an explicit device (cuda:0 or cpu) to "
            f"place every replica on it")
    return [[torch.device("cuda", i * tp + j) for j in range(tp)] for i in range(dp)]


def replica_meshes(tp: int = 1, dp: int = 1, device="cuda") -> List[TPMesh]:
    """One ``TPMesh`` per data-parallel replica over ``serving_devices``:
    replica ``i``'s head shards on its own ``tp`` devices."""
    return [TPMesh(tuple(devs)) for devs in serving_devices(tp=tp, dp=dp, device=device)]


def replica_devices(dp: int = 1, device="cuda") -> List[torch.device]:
    """One device per data-parallel replica at ``tp == 1``."""
    return [devs[0] for devs in serving_devices(tp=1, dp=dp, device=device)]
