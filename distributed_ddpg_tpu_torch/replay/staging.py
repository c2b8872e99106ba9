"""Host-side staging ring for replay ingest.

A copy of distributed_ddpg_tpu/replay/staging.py (numpy, no framework),
trimmed to what the port's DeviceReplay uses. A preallocated [capacity, D]
float32 ring: push is one bounded memcpy into the tail, pop one bounded
memcpy out of the head (two on wraparound), pop_into the same into a
caller's buffer (the host-buffer pool's, transfer/hostbuf.py). FIFO order
is exact.

The ring is not thread-safe; DeviceReplay serializes every access under
its staging condition (the lock its backpressure waits on).
"""

from __future__ import annotations

import numpy as np


class HostStagingRing:
    """Preallocated FIFO ring of packed [*, width] float32 rows.

    Capacity grows by doubling only when a push cannot fit even after the
    consumer has drained (a single oversized add) — the steady state never
    allocates.
    """

    def __init__(self, width: int, capacity_rows: int):
        if capacity_rows < 1:
            raise ValueError(f"capacity_rows must be >= 1, got {capacity_rows}")
        self.width = int(width)
        self._buf = np.zeros((int(capacity_rows), self.width), np.float32)
        self._head = 0          # next row to pop
        self._size = 0          # live rows

    def __len__(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    def _grow(self, need_rows: int) -> None:
        new_cap = self.capacity
        while new_cap < need_rows:
            new_cap *= 2
        new_buf = np.zeros((new_cap, self.width), np.float32)
        if self._size:
            new_buf[: self._size] = self.peek(self._size)
        self._buf = new_buf
        self._head = 0

    def push(self, rows: np.ndarray) -> None:
        """Append rows (any length) in FIFO order; grows if needed."""
        n = len(rows)
        if n == 0:
            return
        if rows.shape[1:] != (self.width,):
            raise ValueError(
                f"expected [*, {self.width}] rows, got {rows.shape}"
            )
        if self._size + n > self.capacity:
            self._grow(self._size + n)
        tail = (self._head + self._size) % self.capacity
        first = min(n, self.capacity - tail)
        self._buf[tail : tail + first] = rows[:first]
        if n > first:
            self._buf[: n - first] = rows[first:]
        self._size += n

    def pop(self, n: int) -> np.ndarray:
        """Remove and return the n oldest rows as an owned contiguous
        array (always a copy — the region is overwritten by later pushes)."""
        if n > self._size:
            raise ValueError(f"pop({n}) from ring holding {self._size}")
        out = self.peek(n)
        self._head = (self._head + n) % self.capacity
        self._size -= n
        return out

    def pop_into(self, n: int, out: np.ndarray) -> np.ndarray:
        """pop(), but into a caller-owned [n, width] buffer (the transfer
        host-buffer pool's): the same FIFO semantics, no allocation."""
        if n > self._size:
            raise ValueError(f"pop_into({n}) from ring holding {self._size}")
        if out.shape != (n, self.width):
            raise ValueError(
                f"pop_into needs a [{n}, {self.width}] buffer, got {out.shape}"
            )
        first = min(n, self.capacity - self._head)
        out[:first] = self._buf[self._head : self._head + first]
        if n > first:
            out[first:] = self._buf[: n - first]
        self._head = (self._head + n) % self.capacity
        self._size -= n
        return out

    def peek(self, n: int) -> np.ndarray:
        """Copy of the n oldest rows without consuming them."""
        if n > self._size:
            raise ValueError(f"peek({n}) from ring holding {self._size}")
        first = min(n, self.capacity - self._head)
        if first == n:
            return self._buf[self._head : self._head + n].copy()
        out = np.empty((n, self.width), np.float32)
        out[:first] = self._buf[self._head :]
        out[first:] = self._buf[: n - first]
        return out

    def peek_cols(self, col: int, ncols: int, max_n: int) -> np.ndarray:
        """Copy of the oldest min(len, max_n) rows' columns [col, col +
        ncols), without copying whole rows (reward_sample reads only the
        reward and discount pair)."""
        n = min(self._size, max_n)
        first = min(n, self.capacity - self._head)
        out = np.empty((n, ncols), np.float32)
        out[:first] = self._buf[self._head : self._head + first, col : col + ncols]
        if n > first:
            out[first:] = self._buf[: n - first, col : col + ncols]
        return out
