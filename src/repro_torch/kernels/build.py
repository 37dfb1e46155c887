"""Build the CUDA C++ kernels under ``csrc/`` with nvcc, at first use.

Each source has a plain ``extern "C"`` interface (one or more entries) and
compiles on its own into a shared library that ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/kernels/`` at the repository root, named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  ``build()`` starts one nvcc per source, all at
once, and returns what ``-Xptxas -v`` reported (registers, shared memory,
spills) for each source it compiled.

A meta tensor (the dry run's shape-only trace, ``launch/dryrun.py``)
reaches a launcher's meta version: it allocates what the CUDA launcher
allocates (outputs, this module's scratch) and, instead of launching,
adds the call's bytes and FLOPs to ``META_CALLS`` (``meta_call``), never
to a launch count.  Its plan takes the target card's SMs and opt-in shared
memory from ``TARGET_SMS`` and ``TARGET_SMEM_OPTIN``.

``launch`` calls an entry on the current stream.  With a kernel tracer
armed (``ops.set_kernel_tracer``) it brackets the call with two CUDA events
and leaves a span on the tracer's ``kernel`` track, read when the trace is;
disarmed, the cost is one ``is None`` test.  The host issues a launch well
after it records the start event, and an idle card stamps that event at
once, so a traced launch is *gated*: the stream first waits
(``cuStreamWaitValue32``) for a pinned host counter that the host bumps
once the start event, the launch and the end event are all queued.  The
card then runs the three back to back and the span measures the card: the
launch, not the host's time to issue it.  Nothing on the host waits; the
card waits only for work the host had not yet issued.  CUDA loads a kernel
lazily at its first launch, and loading waits for the whole context, so a
first launch behind the gate would wait for itself: arming the tracer on a
device (``anchor``) first loads every kernel of every source there (each
source's ``<name>_preload`` entry, ``PRELOAD``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("elite_decode_paged", "flash_prefill", "rope_elite")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: each source's entry that loads all its kernels on the current device
PRELOAD = {"elite_decode_paged": "elite_decode_preload",
           "flash_prefill": "flash_prefill_preload", "rope_elite": "rope_elite_preload"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_SCRATCH: Dict[tuple, tuple] = {}
_PRELOADED: set = set()                    # device indices whose kernels are loaded

#: the card a meta call is planned for, the H100 SXM5: 132 SMs (NVIDIA H100
#: Tensor Core GPU Architecture whitepaper, H100 SXM5) and 227 KiB of
#: shared memory per block by opt-in (CUDA C++ Programming Guide, compute
#: capability 9.0); ``chip_smoke.py`` phase 3o checks both against the card
TARGET_SMS = 132
TARGET_SMEM_OPTIN = 227 * 1024
#: the kernels' meta versions' calls since ``reset_meta_calls``:
#: {entry name: {"calls", "bytes", "flops"}}
META_CALLS: Dict[str, Dict[str, int]] = {}

#: the tracer kernel launches report to (``ops.set_kernel_tracer``), or None
TRACER = None
#: the launch gate: cuStreamWaitValue32, the pinned counter (its device
#: address and a host view) and the last value issued; set up by ``anchor``
_GATE: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "with the CUDA toolkit's nvcc at first use")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library; raises with
    nvcc's output if any compile fails.  → {name: ptxas report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return reports


def load(symbol: str, argtypes, restype=ctypes.c_int, source: str = ""):
    """The C function ``symbol`` from the library of ``csrc/<source>.cu``
    (``source`` defaults to ``symbol``; built if needed), with its
    ``argtypes``/``restype`` declared."""
    source = source or symbol
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def scratch(dev, key: str, n_partial: int, n_counters: int):
    """The split-KV scratch of the kernels of ``key`` on device ``dev``:
    partials (f32) and counters (int32 zeros), allocated at first use and
    grown when a call needs more.  The kernels leave every counter at 0."""
    part, cnt = _SCRATCH.get((dev, key), (None, None))
    if part is None or part.numel() < n_partial:
        part = torch.empty(max(n_partial, 1), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=dev)
    _SCRATCH[(dev, key)] = part, cnt
    return part, cnt


def free_scratch(dev) -> None:
    """Drop the split-KV scratch held for device ``dev`` (it is allocated
    again, at the size a call needs, by the next call)."""
    for key in [k for k in _SCRATCH if k[0] == dev]:
        del _SCRATCH[key]


def meta_call(name: str, nbytes: int, flops: int) -> None:
    """Count one call of ``name``'s meta version, with the bytes and FLOPs
    the CUDA kernel needs for it."""
    rec = META_CALLS.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0})
    rec["calls"] += 1
    rec["bytes"] += int(nbytes)
    rec["flops"] += int(flops)


def reset_meta_calls() -> None:
    META_CALLS.clear()


def check(t, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel reading raw pointers needs."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _gate() -> Dict[str, object]:
    """The launch gate, made once per process: libcuda's stream wait
    (``cuStreamWaitValue32``) and a pinned, device-mapped uint32 counter
    at 0."""
    if not _GATE:
        cuda = ctypes.CDLL("libcuda.so.1")
        wait = getattr(cuda, "cuStreamWaitValue32_v2", None) or cuda.cuStreamWaitValue32
        wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint]
        mapped = cuda.cuMemHostGetDevicePointer_v2
        mapped.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_uint]
        flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        addr = ctypes.c_uint64()
        err = mapped(ctypes.byref(addr), ctypes.c_void_p(flag.data_ptr()), 0)
        if err:
            raise RuntimeError(f"cuMemHostGetDevicePointer failed: CUDA error {err}")
        _GATE.update(wait=wait, flag=flag, addr=addr.value, issued=0,
                     host=ctypes.c_uint32.from_address(flag.data_ptr()))
    return _GATE


def preload(dev) -> None:
    """Load every kernel of every source on ``dev`` (once per device), so
    that no launch behind the gate is a kernel's first."""
    if dev.index in _PRELOADED:
        return
    with torch.cuda.device(dev):
        for source, symbol in PRELOAD.items():
            err = load(symbol, [], source=source)()
            if err:
                raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    _PRELOADED.add(dev.index)


def anchor(tracer, dev) -> None:
    """Tie ``tracer``'s device spans on ``dev`` to its clock: wait for the
    card, take the host time, record an event on the idle card.  Also makes
    the launch gate, so a traced launch allocates nothing, and loads every
    kernel on ``dev`` (``preload``)."""
    _gate()
    preload(dev)
    torch.cuda.synchronize(dev)
    ev = torch.cuda.Event(enable_timing=True)
    t = tracer.now()
    ev.record(torch.cuda.current_stream(dev))
    tracer.anchor(dev.index, ev, t)


def launch(name: str, fn, args, first) -> None:
    """Call the C entry ``fn(*args, stream)`` on the current stream of
    ``first``'s device; raise on a CUDA error.  With a kernel tracer armed,
    the call goes behind the gate between two CUDA events on that stream
    and a ``name`` span (arg ``shape``: ``first``'s) goes to the ``kernel``
    track; nothing here waits for the card (a device the tracer was not
    armed on is anchored at its first launch, the one wait)."""
    dev = first.device
    stream = torch.cuda.current_stream(dev)
    tr = TRACER
    if tr is None:
        err = fn(*args, stream.cuda_stream)
    else:
        if not tr.has_anchor(dev.index):
            anchor(tr, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        handle = stream.cuda_stream
        gate = _GATE
        value = gate["issued"] = (gate["issued"] + 1) & 0xFFFFFFFF
        # CU_STREAM_WAIT_VALUE_GEQ: a counter that moved on releases it too
        werr = gate["wait"](handle, gate["addr"], value, 0)
        if werr:
            raise RuntimeError(f"cuStreamWaitValue32 failed: CUDA error {werr}")
        try:
            start.record(stream)
            err = fn(*args, handle)
            end.record(stream)
        finally:
            gate["host"].value = value          # release, whatever happened
        if not err:
            tr.device_span(name, dev.index, start, end, shape=str(tuple(first.shape)))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
