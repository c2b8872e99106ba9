"""Host-side staging ring for replay ingest.

A copy of distributed_ddpg_tpu/replay/staging.py (numpy, no framework),
trimmed to what the port's DeviceReplay uses. A preallocated [capacity, D]
float32 ring: push is one bounded memcpy into the tail, pop one bounded
memcpy out of the head (two on wraparound). FIFO order is exact.

The ring is not thread-safe; the port's DeviceReplay uses it from the
learner thread only.
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
