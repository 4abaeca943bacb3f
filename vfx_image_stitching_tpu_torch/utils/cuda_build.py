"""Build, load and launch a library of hand-written CUDA kernels.

Each library (the SIFT kernels of ``models/sift/kernels.py``, the compose
fold of ``compose/blend.py``) is a set of ``csrc/`` sources with a plain C
interface, compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/<hash>/lib<name>.so`` at the repository root and loaded
with ctypes by a :class:`Library`, which launches its entry points and
counts the launches.  The hash covers the library's name,
its sources and headers and the flags, so a changed file builds anew and
an unchanged one is loaded as built.  Every library is compiled with
``-fmad=false`` and without ``--use_fast_math``: each float is one IEEE
single operation, as in the plain PyTorch versions beside the kernels,
and division stays correctly rounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# the compiler's output of each library's last build in this process
# (``-Xptxas -v``: registers, shared memory and spills of each kernel)
BUILD_LOGS: Dict[str, str] = {}


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, sources: Sequence[Path],
                  headers: Sequence[Path] = ()) -> Path:
    """Compile ``sources`` into ``lib<name>.so`` (once per content hash)
    and return its path; ``headers`` are the files the sources include."""
    digest = hashlib.sha256(name.encode())
    for src in (*sources, *headers):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, lib)
    return lib


class Library:
    """One library's wrapper state: built and loaded once at the first
    launch, each C entry point given its argument types (every entry
    returns an int status and takes the stream last), and a launch count
    per kernel name in ``launches``, which the mesh layer's slot threads
    update under a lock (plain-version calls on CPU tensors do not
    count)."""

    def __init__(self, name: str, sources: Sequence[Path],
                 headers: Sequence[Path], signatures: Mapping[str, Sequence],
                 kernels: Sequence[str]):
        self.name, self.sources, self.headers = name, sources, headers
        self.signatures = signatures
        self.launches: Dict[str, int] = {k: 0 for k in kernels}
        self._lib: Optional[ctypes.CDLL] = None
        self._lib_lock = threading.Lock()
        self._count_lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self) -> Path:
        return build_library(self.name, self.sources, self.headers)

    def load(self) -> ctypes.CDLL:
        with self._lib_lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for entry, argtypes in self.signatures.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, name: str, dev: torch.device, entry: str, *args) -> None:
        """Call C entry ``entry`` with ``args`` and ``dev``'s current
        stream; raise if the launch was refused; count it as ``name``."""
        with torch.cuda.device(dev):
            fn = getattr(self.load(), entry)
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        self.count(name)

    def count(self, name: str) -> None:
        """Add one to ``launches[name]``, safely from any thread."""
        with self._count_lock:
            self.launches[name] += 1

    def reset(self) -> None:
        with self._count_lock:
            for name in self.launches:
                self.launches[name] = 0
