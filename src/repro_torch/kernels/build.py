"""Build the CUDA C++ kernels under ``csrc/`` with nvcc, at first use.

Each source has a plain ``extern "C"`` interface (one or more entries) and
compiles on its own into a shared library that ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/kernels/`` at the repository root, named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  ``build()`` starts one nvcc per source, all at
once, and returns what ``-Xptxas -v`` reported (registers, shared memory,
spills) for each source it compiled.
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

_LIBS: Dict[str, ctypes.CDLL] = {}
_SCRATCH: Dict[tuple, tuple] = {}


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
