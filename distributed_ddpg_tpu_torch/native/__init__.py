"""The port's native core: the shm transport's ring and the host sum tree.

Counterpart of distributed_ddpg_tpu/native/__init__.py: ShmRing over
`ring.cpp` (the SPSC shared-memory ring of the shm transport), and
NativeSumTree and make_sum_tree over `replay_core.cpp` (the host PER sum
tree's set, sample and get). Each source is built with g++ at first use
into distributed_ddpg_tpu_torch/build/lib<name>-<hash>.so (git-ignored),
the hash over the source, the flags and the compiler's version, so an
edited source or another toolchain rebuilds; then it is loaded with
ctypes:

  g++ -O2 -std=c++17 -shared -fPIC -o build/libring-<hash>.so native/ring.cpp
  g++ -O2 -std=c++17 -shared -fPIC -o build/libreplay_core-<hash>.so native/replay_core.cpp

`load()` and `load_sum_tree()` raise with the compiler's output when the
build fails; `available()` and `sum_tree_available()` say whether each can
be loaded. Transport 'auto' resolves to the ring exactly when it can be;
make_sum_tree takes the C++ tree exactly when it can be, else the numpy
tree, which draws the same indices (the JAX package's rule: a missing
toolchain costs speed, never a result). Nothing is built outside the
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from distributed_ddpg_tpu_torch.replay.sum_tree import SumTree

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ring.cpp")
SUM_TREE_SRC = os.path.join(_DIR, "replay_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_st_lib: Optional[ctypes.CDLL] = None
_st_error: Optional[str] = None


def _target(src: str, stem: str) -> str:
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                 check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ not usable: {e!r}") from e
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode() + version.encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _build(src: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, "-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders race benignly


def _built(src: str, stem: str) -> ctypes.CDLL:
    out = _target(src, stem)
    if not os.path.exists(out):
        _build(src, out)
    return ctypes.CDLL(out)


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
        lib = _built(SRC, "ring")
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


def _ptr(arr: np.ndarray, ctype=ctypes.POINTER(ctypes.c_float)):
    return arr.ctypes.data_as(ctype)


# --- the host sum tree ----------------------------------------------------------

_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)


def load_sum_tree() -> ctypes.CDLL:
    """The loaded sum-tree library (replay_core.cpp), built first if
    needed; raises as load() does, and remembers a failure the same way."""
    global _st_lib, _st_error
    if _st_lib is not None:
        return _st_lib
    if _st_error is not None:
        raise RuntimeError(_st_error)
    try:
        lib = _built(SUM_TREE_SRC, "replay_core")
    except Exception as e:
        _st_error = f"the sum tree's native library is unavailable: {e}"
        raise RuntimeError(_st_error) from e
    _I = ctypes.c_int64
    lib.st_set.argtypes = [_F64, _I, _I64, _F64, _I]
    lib.st_set.restype = None
    lib.st_sample.argtypes = [_F64, _I, _F64, _I64, _I]
    lib.st_sample.restype = None
    lib.st_get.argtypes = [_F64, _I, _I64, _F64, _I]
    lib.st_get.restype = None
    _st_lib = lib
    return lib


def sum_tree_available() -> bool:
    try:
        load_sum_tree()
    except RuntimeError:
        return False
    return True


class NativeSumTree(SumTree):
    """replay/sum_tree.SumTree with the hot loops (set, get, sample) in C++
    (replay_core.cpp). The layout, the rounding and the stratified draw are
    inherited: the numpy class stays the one source of those semantics and
    the oracle."""

    def __init__(self, capacity: int):
        self._lib = load_sum_tree()
        super().__init__(capacity)

    def set(self, indices, priorities) -> None:
        idx = np.ascontiguousarray(indices, np.int64)
        prio = np.ascontiguousarray(priorities, np.float64)
        self._lib.st_set(_ptr(self.tree, _F64), self.capacity, _ptr(idx, _I64),
                         _ptr(prio, _F64), len(idx))

    def get(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int64)
        out = np.empty(len(idx), np.float64)
        self._lib.st_get(_ptr(self.tree, _F64), self.capacity, _ptr(idx, _I64),
                         _ptr(out, _F64), len(idx))
        return out

    def sample(self, values) -> np.ndarray:
        v = np.ascontiguousarray(values, np.float64)
        out = np.empty(len(v), np.int64)
        self._lib.st_sample(_ptr(self.tree, _F64), self.capacity, _ptr(v, _F64),
                            _ptr(out, _I64), len(v))
        return out


def make_sum_tree(capacity: int):
    """NativeSumTree when the toolchain builds it, else the numpy SumTree,
    which draws the same indices."""
    return NativeSumTree(capacity) if sum_tree_available() else SumTree(capacity)


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
