"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled at
first use by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``. Libraries land in ``build/repro_torch/`` at the root of the
checkout, keyed on a hash of the source, so an edited kernel rebuilds and
an unchanged one loads at once. Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def align16(n: int) -> int:
    """``n`` rounded up to a multiple of 16 (the kernels' shared-memory
    regions start 16-byte aligned)."""
    return (n + 15) // 16 * 16


def nvcc_path() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def ptxas_summary(log: str) -> str:
    """The ptxas register, shared-memory and spill lines of an nvcc log,
    one string."""
    return " | ".join(
        line.strip() for line in log.splitlines()
        if re.search(r"ptxas info\s*: (Used|Compiling)|bytes spill", line)
    )


def ptxas_info(name: str) -> str:
    """The ptxas summary (registers, shared memory, spills) of the built
    library of ``name``, kept beside it by :func:`build_all`."""
    p = library_path(name).with_suffix(".ptxas")
    return p.read_text() if p.exists() else "not built"


def build_all(names) -> dict[str, str]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: ptxas summary} for the
    kernels built by this call; raises with nvcc's stderr on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        logs[name] = ptxas_summary(stderr + stdout)
        out.with_suffix(".ptxas").write_text(logs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


_TICKETS: dict = {}


def ticket_counters(device, n: int):
    """The kernels' ticket counters for the current stream: zeros between
    launches (the CTA that draws a counter's last ticket resets it), at
    least ``n`` of them; one buffer per device and stream, so launches on
    two streams never share one, and kernels on one stream run in turn."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


class CudaKernel:
    """One hand-written kernel: its library, its C entry point and the count
    of its launches. ``launches`` rises by one where the wrapper launches the
    kernel and nowhere else."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            build_all([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def function(self, symbol: str, argtypes: list):
        """Another C function of the kernel's library, returning an int
        error code: a query, which launches nothing and counts nothing."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args):
        """Call the C entry point on the current stream; raise when the
        launch was refused (its ``cudaGetLastError`` is not 0)."""
        fn = self._load()
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1
