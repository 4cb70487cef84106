"""Deploy transport: remote HardwareInterface over plain TCP.

The reference's real-robot layer is a ROS stack (algo/deploy/env/*, 3.6k LoC:
openhand/allsight/camera/moveit wrappers over roscpp transports). ROS is not
a TPU-framework dependency, so the equivalent here is a thin, explicit wire
protocol: the robot-side process wraps its drivers in a HardwareInterface
and calls `serve_hardware`; the training-side HardwarePlayer connects a
`RemoteInterface`, which satisfies the same Protocol as SimInterface — the
players (deploy/hardware_player.py) are transport-agnostic.

Message = dict[str, np.ndarray], encoded by the native C++ codec
(native/hwbridge.cpp via ctypes) when available, else the pure-Python
equivalent; framed on the socket as [u64 length][message bytes].

Port of `isaacgyminsertion_tpu/deploy/transport.py`: the same bytes from
either codec. The codec source is the port's own copy, built with g++ into
the package's `_build/` at first use (`utils/host_build.py`); where it cannot
be built the Python codec takes over, and unlike the reference the module
says which codec it took, and why, once (`CODEC`, `CODEC_NOTE`).
"""

from __future__ import annotations

import ctypes
import os
import socket
import socketserver
import struct
import subprocess
import threading

import numpy as np

from ..native import _CODE_DTYPES, _DTYPE_CODES   # the codes of trajlog.cpp and hwbridge.cpp

_MAGIC = 0x42574849


# --------------------------------------------------------------------------- #
# codec (native with pure-python fallback)
# --------------------------------------------------------------------------- #

class CodecError(ValueError):
    """Malformed hwbridge message (bad magic / truncated / oversized field)."""


def _py_pack(msg: dict[str, np.ndarray]) -> bytes:
    out = [struct.pack("<II", _MAGIC, len(msg))]
    for name, arr in msg.items():
        # NOT ascontiguousarray: it promotes 0-d scalars to 1-d; tobytes()
        # already linearizes any layout
        arr = np.asarray(arr)
        code = _DTYPE_CODES[np.dtype(arr.dtype)]
        nb = name.encode()
        if len(nb) > 255:
            # contract shared with the native codec (hwbridge.cpp hwb_pack):
            # names are <256 bytes so both unpack paths agree byte-for-byte
            raise CodecError(f"hwbridge array name too long ({len(nb)} bytes)")
        out.append(struct.pack("<I", len(nb)))
        out.append(nb)
        out.append(struct.pack("<II", code, arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b"")
        raw = arr.tobytes()
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def _py_unpack(buf: bytes) -> dict[str, np.ndarray]:
    # real exceptions (not assert: stripped under python -O) so the server
    # can drop a malformed connection gracefully instead of crashing
    if len(buf) < 8:
        raise CodecError("hwbridge message truncated")
    magic, n = struct.unpack_from("<II", buf, 0)
    if magic != _MAGIC:
        raise CodecError("bad hwbridge magic")
    off = 8
    msg = {}
    try:
        for _ in range(n):
            (name_len,) = struct.unpack_from("<I", buf, off)
            off += 4
            name = buf[off:off + name_len].decode()
            off += name_len
            code, ndim = struct.unpack_from("<II", buf, off)
            off += 8
            dims = struct.unpack_from(f"<{ndim}Q", buf, off) if ndim else ()
            off += 8 * ndim
            (plen,) = struct.unpack_from("<Q", buf, off)
            off += 8
            if plen > len(buf) - off:
                raise CodecError("hwbridge payload overruns message")
            dtype = _CODE_DTYPES.get(code)
            if dtype is None:
                raise CodecError(f"unknown hwbridge dtype code {code}")
            msg[name] = np.frombuffer(buf[off:off + plen], dtype=dtype).reshape(dims).copy()
            off += plen
    except (struct.error, UnicodeDecodeError, ValueError) as e:
        if isinstance(e, CodecError):
            raise
        raise CodecError(f"malformed hwbridge message: {e}") from e
    return msg


SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                      "hwbridge.cpp")
_LOCK = threading.Lock()
_native = None
_native_tried = False
CODEC: str | None = None       # "native" or "python", once the codec is chosen
CODEC_NOTE: str | None = None  # the library's path, or why the native codec is unavailable


def _load_native():
    """The native codec (built at first use into the package's `_build/`), or
    None; the choice and its reason are printed once."""
    global _native, _native_tried, CODEC, CODEC_NOTE
    with _LOCK:
        if _native_tried:
            return _native
        _native_tried = True
        from ..utils.host_build import build_shared

        try:
            path = build_shared("hwbridge", SOURCE)
            lib = ctypes.CDLL(path)
            lib.hwb_pack.restype = ctypes.c_uint64
            lib.hwb_count.restype = ctypes.c_int32
            lib.hwb_array_info.restype = ctypes.c_int64
            _native, CODEC, CODEC_NOTE = lib, "native", path
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _native, CODEC, CODEC_NOTE = None, "python", f"native codec unavailable: {e}"
        print(f"transport: codec {CODEC} ({CODEC_NOTE})", flush=True)
        return _native


def codec() -> tuple[str, str]:
    """(the codec this process packs and unpacks with, its library's path or
    why the native one is unavailable)."""
    _load_native()
    return CODEC, CODEC_NOTE


def pack(msg: dict[str, np.ndarray]) -> bytes:
    lib = _load_native()
    if lib is None:
        return _py_pack(msg)
    arrs = [(k, np.asarray(v)) for k, v in msg.items()]
    n = len(arrs)
    names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in arrs])
    codes = (ctypes.c_uint32 * n)(*[_DTYPE_CODES[np.dtype(a.dtype)] for _, a in arrs])
    ndims = (ctypes.c_uint32 * n)(*[a.ndim for _, a in arrs])
    dims_flat = [d for _, a in arrs for d in a.shape]
    dims = (ctypes.c_uint64 * max(len(dims_flat), 1))(*dims_flat)
    bufs = [a.tobytes() for _, a in arrs]
    payloads = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[ctypes.cast(ctypes.create_string_buffer(b, len(b)),
                      ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    plens = (ctypes.c_uint64 * n)(*[len(b) for b in bufs])
    out = ctypes.POINTER(ctypes.c_uint8)()
    total = lib.hwb_pack(n, names, codes, ndims, dims, payloads, plens,
                         ctypes.byref(out))
    if not total:
        return _py_pack(msg)
    data = ctypes.string_at(out, total)
    lib.hwb_free(out)
    return data


def unpack(buf: bytes) -> dict[str, np.ndarray]:
    lib = _load_native()
    if lib is None:
        return _py_unpack(buf)
    n = lib.hwb_count(buf, len(buf))
    if n < 0:
        return _py_unpack(buf)  # raises on garbage, same as native would
    msg = {}
    for i in range(n):
        name = ctypes.create_string_buffer(256)
        code = ctypes.c_uint32()
        ndim = ctypes.c_uint32()
        dims = (ctypes.c_uint64 * 8)()
        plen = ctypes.c_uint64()
        off = lib.hwb_array_info(buf, len(buf), i, name, 256,
                                 ctypes.byref(code), ctypes.byref(ndim), dims,
                                 ctypes.byref(plen))
        if off < 0:
            return _py_unpack(buf)
        dtype = _CODE_DTYPES.get(code.value)
        if dtype is None:
            raise CodecError(f"unknown hwbridge dtype code {code.value}")
        shape = tuple(dims[d] for d in range(ndim.value))
        arr = np.frombuffer(buf[off:off + plen.value], dtype=dtype)
        try:
            msg[name.value.decode()] = arr.reshape(shape).copy()
        except ValueError as e:  # payload_len inconsistent with dims
            raise CodecError(f"malformed hwbridge message: {e}") from e
    return msg


# --------------------------------------------------------------------------- #
# framing + RPC
# --------------------------------------------------------------------------- #

def _send_msg(sock: socket.socket, msg: dict):
    payload = pack(msg)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("hardware connection closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> dict:
    (length,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return unpack(_recv_exact(sock, length))


class RemoteInterface:
    """HardwareInterface client: forwards calls to a serve_hardware peer."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7451,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, op: str, **arrays) -> dict:
        msg = {"_op": np.frombuffer(op.encode(), dtype=np.uint8)}
        msg.update(arrays)
        _send_msg(self.sock, msg)
        return _recv_msg(self.sock)

    def reset(self) -> None:
        self._call("reset")

    def get_observation(self) -> dict:
        return self._call("obs")

    def apply_action(self, delta_pos, delta_rot) -> None:
        delta_pos, delta_rot = wire_deltas(delta_pos, delta_rot)
        self._call("act", delta_pos=delta_pos, delta_rot=delta_rot)

    def close(self):
        self.sock.close()


def wire_deltas(delta_pos, delta_rot) -> tuple[np.ndarray, np.ndarray]:
    """The action deltas as the wire carries them (float32)."""
    return np.asarray(delta_pos, np.float32), np.asarray(delta_rot, np.float32)


class WireDeltas:
    """A HardwareInterface fed the deltas as `RemoteInterface` sends them: a
    local run through it takes a served run's actions to the bit."""

    def __init__(self, hw):
        self.hw = hw

    def __getattr__(self, name):
        return getattr(self.hw, name)

    def apply_action(self, delta_pos, delta_rot) -> None:
        self.hw.apply_action(*wire_deltas(delta_pos, delta_rot))


def serve_hardware(hw, host: str = "127.0.0.1", port: int = 7451,
                   max_requests: int | None = None) -> threading.Thread:
    """Expose a HardwareInterface on a TCP port (robot-side daemon).

    Returns the serving thread; pass the server's own drivers as `hw` on the
    robot, or a SimInterface for loopback testing. `max_requests` bounds the
    session for tests.
    """

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            count = 0
            while max_requests is None or count < max_requests:
                try:
                    msg = _recv_msg(self.request)
                except (ConnectionError, struct.error, CodecError):
                    # malformed input drops this connection; the server and
                    # other sessions keep running
                    return
                if "_op" not in msg:
                    return  # not a valid RPC frame: drop the connection
                try:
                    op = msg.pop("_op").tobytes().decode()
                except UnicodeDecodeError:
                    return  # non-UTF-8 op: drop like the CodecError path
                if op == "reset":
                    hw.reset()
                    reply = {"ok": np.asarray([1], np.int32)}
                elif op == "obs":
                    reply = {k: np.asarray(v) for k, v in hw.get_observation().items()}
                elif op == "act":
                    # a well-framed but wrong-fielded message must drop the
                    # connection, not raise in the handler (round-3 ADVICE)
                    if "delta_pos" not in msg or "delta_rot" not in msg:
                        return
                    hw.apply_action(msg["delta_pos"], msg["delta_rot"])
                    reply = {"ok": np.asarray([1], np.int32)}
                else:
                    reply = {"error": np.asarray([1], np.int32)}
                _send_msg(self.request, reply)
                count += 1

    class Server(socketserver.TCPServer):
        allow_reuse_address = True
        daemon_threads = True

    server = Server((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.server = server  # type: ignore[attr-defined]
    thread.start()
    return thread
