"""Build and load the host-side C++ libraries (g++, no CUDA).

A library is one `.cpp` source compiled with `g++ -O2 -shared -fPIC
-std=c++17` into `_build/` (the directory of the CUDA kernels, listed in
.gitignore), named by the hash of its source and flags, so an edited source
never loads a stale build. Nothing is written beside the source.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence

from .cuda_build import BUILD_DIR

GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
GXX_TIMEOUT_S = 120.0


def build_shared(name: str, source: str, libs: Sequence[str] = ()) -> str:
    """Compile `source` (unless its hashed .so exists) → the .so's path.
    Raises RuntimeError with the compiler's message where it fails."""
    flags = [*GXX_FLAGS, *(f"-l{lib}" for lib in libs)]
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # the libraries go after the source: the linker resolves left to right
    proc = subprocess.run([gxx, *GXX_FLAGS, source, "-o", tmp, *flags[len(GXX_FLAGS):]],
                          capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}: {proc.stderr.strip()}")
    os.replace(tmp, so)   # atomic: a concurrent builder never loads a partial file
    return so
