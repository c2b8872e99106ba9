"""The port's native core: the SPSC shared-memory ring of the shm transport.

Counterpart of distributed_ddpg_tpu/native/__init__.py (ShmRing and its
loader), trimmed to the ring. `ring.cpp` is built with g++ at first use
into distributed_ddpg_tpu_torch/build/libring-<hash>.so (git-ignored), the
hash over the source, the flags and the compiler's version, so an edited
source or another toolchain rebuilds; then it is loaded with ctypes:

  g++ -O2 -std=c++17 -shared -fPIC -o build/libring-<hash>.so native/ring.cpp

`load()` raises with the compiler's output when the build fails;
`available()` says whether it can be loaded (transport 'auto' resolves to
the ring exactly when it is). Nothing is built outside the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ring.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _target() -> str:
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                 check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ not usable: {e!r}") from e
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode() + version.encode())
    return os.path.join(BUILD_DIR, f"libring-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders race benignly


def load() -> ctypes.CDLL:
    """The loaded ring library, built first if needed; raises (with the
    compiler's output) when it cannot be built or loaded. A failure is
    remembered, so later calls raise the same without building again."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        out = _target()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
    except Exception as e:
        _error = f"the shm ring's native library is unavailable: {e}"
        raise RuntimeError(_error) from e
    _VOID, _I = ctypes.c_void_p, ctypes.c_int64
    _F32 = ctypes.POINTER(ctypes.c_float)
    lib.ring_init.argtypes = [_VOID]
    lib.ring_push.argtypes = [_VOID, _I, _I, _F32, _I]
    lib.ring_push.restype = _I
    lib.ring_pop.argtypes = [_VOID, _I, _I, _F32, _I]
    lib.ring_pop.restype = _I
    lib.ring_size.argtypes = [_VOID]
    lib.ring_size.restype = _I
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ShmRing:
    """SPSC f32-row ring over a shared-memory buffer (ring.cpp). One
    producer process, one consumer process; the buffer comes from the
    caller (actors/pool.py gives each worker an anonymous mp.Array, which
    spawned children inherit).

    Layout: a 128-byte header (two cache-line-separated int64 counters
    owned by the C++) and capacity * width f32 rows."""

    HEADER_BYTES = 128

    def __init__(self, buf, capacity: int, width: int, init: bool = False):
        self._lib = load()
        self.capacity = int(capacity)
        self.width = int(width)
        # Keep the raw buffer and a flat uint8 view of it alive; the void*
        # handed to the C++ is the view's base.
        self._buf = buf
        self._view = np.frombuffer(buf, dtype=np.uint8)
        if len(self._view) < self.nbytes(capacity, width):
            raise ValueError(f"ring buffer too small: {len(self._view)} < "
                             f"{self.nbytes(capacity, width)}")
        self._ptr = ctypes.c_void_p(self._view.ctypes.data)
        if init:
            self._lib.ring_init(self._ptr)

    @staticmethod
    def nbytes(capacity: int, width: int) -> int:
        return ShmRing.HEADER_BYTES + 4 * capacity * width

    def push(self, rows: np.ndarray) -> int:
        """Append [n, width] f32 rows; returns the rows accepted (the ring
        may be full: the caller keeps the rest)."""
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.width:
            raise ValueError(f"expected [n, {self.width}] rows, got {rows.shape}")
        return int(self._lib.ring_push(self._ptr, self.capacity, self.width, _ptr(rows),
                                       rows.shape[0]))

    def pop(self, max_rows: int) -> np.ndarray:
        """Pop up to max_rows rows; returns an owned [n, width] f32 array."""
        out = np.empty((int(max_rows), self.width), np.float32)
        n = int(self._lib.ring_pop(self._ptr, self.capacity, self.width, _ptr(out),
                                   out.shape[0]))
        # A short pop copies, so only n rows stay alive.
        return out[:n].copy() if n < max_rows else out

    def __len__(self) -> int:
        return int(self._lib.ring_size(self._ptr))
