"""Build and bind the hand-written CUDA kernels.

Each kernel is one `.cu` file under `csrc/` with a plain C entry point. It is
compiled by nvcc for sm_90a at first use into `_build/` (listed in
.gitignore), named by the hash of its sources and flags, and bound with
ctypes. A failed build raises; nothing falls back.

`build_all` starts one nvcc per kernel and waits for all of them, so a caller
that needs every kernel pays for the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a CUDA machine")
    return path


class CudaKernel:
    """One `.cu` source, its C entry point and the loaded library.

    `name` names the library; `source` and `headers` are file names under
    `csrc/` (headers only enter the hash); `entry` is the C function and
    `argtypes` its ctypes signature (it returns the CUDA error code);
    `extra_flags` are nvcc flags beyond NVCC_FLAGS (they enter the hash).
    `info` records the build: path, seconds, cached, and the ptxas report."""

    def __init__(self, name: str, source: str, entry: str, argtypes: Sequence,
                 headers: Sequence[str] = (), extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.headers = [os.path.join(CSRC_DIR, h) for h in headers]
        self.entry = entry
        self.argtypes = list(argtypes)
        self.flags = [*NVCC_FLAGS, *extra_flags]
        self.info: dict = {}
        self._fn = None

    def _target(self) -> str:
        h = hashlib.sha256()
        for path in [self.source, *self.headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def _start(self):
        """Start nvcc unless the hashed .so exists → (so, tmp, process, t0)."""
        so = self._target()
        if os.path.exists(so):
            self.info.update(path=so, seconds=0.0, cached=True)
            return so, None, None, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *self.flags, "-I", CSRC_DIR, "-o", tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return so, tmp, proc, time.perf_counter()

    def _finish(self, so, tmp, proc, t0) -> str:
        if proc is None:
            return so
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {self.source}:\n{out}\n{err}")
        os.replace(tmp, so)
        self.info.update(path=so, seconds=time.perf_counter() - t0, cached=False,
                         ptxas=(out + err).strip())
        return so

    def build(self) -> str:
        """Compile the kernel (if its hashed .so is missing) and return its path."""
        return self._finish(*self._start())

    def fn(self):
        """The bound C entry point (built and loaded at first use)."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(self.build()), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def registers(self) -> list:
        """The ptxas lines that report register use, and those that report
        spills where there are any (empty for a cached build)."""
        lines = [ln.strip() for ln in self.info.get("ptxas", "").splitlines()]
        return [ln for ln in lines if "registers" in ln
                or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln)]

    def register_counts(self) -> dict:
        """{entry function, as ptxas names it: registers} (empty for a cached build)."""
        counts, entry = {}, "?"
        for ln in self.info.get("ptxas", "").splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "Used " in ln and " registers" in ln:
                counts[entry] = int(ln.split("Used ")[1].split(" registers")[0])
        return counts


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build several kernels at once: every nvcc is started before any is waited for."""
    started = [(k, k._start()) for k in kernels]
    for k, job in started:
        k._finish(*job)
