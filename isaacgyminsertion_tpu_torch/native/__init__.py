"""Native host runtime: the C++ trajectory writer, bound with ctypes.

Port of `isaacgyminsertion_tpu/native/__init__.py`. This directory also
holds `hwbridge.cpp`, the deploy transport's message codec, which
`deploy/transport.py` builds and binds. `trajlog.cpp` is built at first use into
the package's `_build/` (`utils/host_build.py`), never beside its source. If
the toolchain or zlib is missing, `load` returns None and `BUILD_ERROR` says
why; the data logger then falls back to the numpy writer. `read_trajectory`
parses the `.itraj` chunked format back into numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trajlog.cpp")
MAGIC = 0x4A525449   # 'ITRJ'
_LOCK = threading.Lock()

# the codes trajlog.cpp writes; any other dtype is stored as float32
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
    np.dtype(bool): 5,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

_lib = None
LIB_PATH: str | None = None     # the loaded library
BUILD_ERROR: str | None = None  # why it could not be built or loaded


def stored_dtype(dtype) -> np.dtype:
    """The dtype an array of `dtype` has in an `.itraj` file."""
    dtype = np.dtype(dtype)
    return dtype if dtype in _DTYPE_CODES else np.dtype(np.float32)


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, LIB_PATH, BUILD_ERROR
    with _LOCK:
        if _lib is not None:
            return _lib
        from ..utils.host_build import build_shared

        try:
            path = build_shared("trajlog", SOURCE, libs=("z",))
            lib = ctypes.CDLL(path)
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            BUILD_ERROR = str(e)
            return None
        lib.trajlog_create.restype = ctypes.c_void_p
        lib.trajlog_create.argtypes = [ctypes.c_int]
        lib.trajlog_destroy.argtypes = [ctypes.c_void_p]
        lib.trajlog_begin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.trajlog_add_array.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint64,
        ]
        lib.trajlog_commit.argtypes = [ctypes.c_void_p]
        lib.trajlog_drain.argtypes = [ctypes.c_void_p]
        lib.trajlog_written.restype = ctypes.c_int64
        lib.trajlog_written.argtypes = [ctypes.c_void_p]
        _lib, LIB_PATH, BUILD_ERROR = lib, path, None
        return _lib


class NativeTrajectoryWriter:
    """C++ thread-pool writer with the `TrajectoryWriter` interface: one
    `traj_{idx:06d}.itraj` per `submit`."""

    def __init__(self, out_dir: str, num_workers: int = 4):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError(f"native trajlog unavailable: {BUILD_ERROR}")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.pool = self.lib.trajlog_create(num_workers)
        self.count = 0
        self._lock = threading.Lock()

    def submit(self, data: dict[str, np.ndarray]):
        with self._lock:
            idx = self.count
            self.count += 1
        path = os.path.join(self.out_dir, f"traj_{idx:06d}.itraj")
        self.lib.trajlog_begin(self.pool, path.encode())
        for name, arr in data.items():
            arr = np.ascontiguousarray(arr)
            code = _DTYPE_CODES.get(arr.dtype)
            if code is None:
                arr = arr.astype(np.float32)
                code = 0
            dims = (ctypes.c_uint64 * arr.ndim)(*arr.shape) if arr.ndim else (
                ctypes.c_uint64 * 1)(1)
            # trajlog_add_array copies the bytes before it returns
            self.lib.trajlog_add_array(
                self.pool, name.encode(), arr.ctypes.data_as(ctypes.c_void_p),
                dims, max(arr.ndim, 1), code, arr.nbytes,
            )
        self.lib.trajlog_commit(self.pool)

    def close(self):
        self.lib.trajlog_drain(self.pool)
        self.lib.trajlog_destroy(self.pool)
        self.pool = None


def read_trajectory(path: str) -> dict[str, np.ndarray]:
    """Parse one .itraj file back into {name: array}."""
    import zlib

    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (magic,) = struct.unpack_from("<I", data, off)
        off += 4
        if magic != MAGIC:
            break
        (name_len,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + name_len].decode()
        off += name_len
        (ndim,) = struct.unpack_from("<I", data, off)
        off += 4
        dims = struct.unpack_from(f"<{ndim}Q", data, off)
        off += 8 * ndim
        (code,) = struct.unpack_from("<I", data, off)
        off += 4
        raw_len, comp_len = struct.unpack_from("<QQ", data, off)
        off += 16
        raw = zlib.decompress(data[off:off + comp_len], bufsize=raw_len)
        off += comp_len
        out[name] = np.frombuffer(raw, dtype=_CODE_DTYPES[code]).reshape(dims)
    return out
