"""Pooled host staging buffers for a super-block's H2D copy.

Counterpart of distributed_ddpg_tpu/transfer/hostbuf.py, with the same
contract:

  acquire(rows)       -> a writable [rows, width] float32 numpy buffer
  commit(buf, fence)  -> back to the pool; not handed out again until
                         `fence` completes (None: at once)

A pool keeps `depth` buffers a shape (the power-of-two coalesce sizes give
a bounded set) and recycles them double-buffered: under depth it
allocates, at depth it blocks on the oldest in-flight fence, and when
every pooled buffer of a shape was lost (a caller that failed between
acquire and commit) it allocates again rather than wait forever.

With pin=True (on the card) each buffer is a page-locked CPU tensor,
torch.empty(..., pin_memory=True), handed out as its numpy view, so the
insert's copy from it is asynchronous (queued on the learner's stream,
behind the running chunk, without holding the host). The fence is then a
torch.cuda.Event recorded on that stream right after the insert that read
the buffer, and waiting on it is event.synchronize(). A failed pinned
allocation raises: there is no fallback to pageable memory. With
pin=False (the CPU) the buffers are plain memory and the fence is None.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict

import numpy as np


class HostBufferPool:
    def __init__(self, width: int, depth: int = 2, pin: bool = False):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.width = int(width)
        self.depth = int(depth)
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: Dict[int, deque] = {}
        # rows -> deque of (buf, fence) awaiting their consumer.
        self._inflight: Dict[int, deque] = {}
        self._allocated: Dict[int, int] = {}
        # The pinned tensors behind the numpy views handed out.
        self._pinned = []
        self.allocations = 0
        self.fence_waits = 0

    def _allocate(self, rows: int) -> np.ndarray:
        if not self.pin:
            return np.empty((rows, self.width), np.float32)
        import torch

        t = torch.empty((rows, self.width), dtype=torch.float32, pin_memory=True)
        self._pinned.append(t)
        return t.numpy()

    def acquire(self, rows: int) -> np.ndarray:
        """A writable [rows, width] float32 buffer: a free one, a new one
        while under `depth` for this shape, else the oldest in-flight one
        once its fence has completed."""
        rows = int(rows)
        with self._lock:
            free = self._free.setdefault(rows, deque())
            if free:
                return free.popleft()
            inflight = self._inflight.setdefault(rows, deque())
            if self._allocated.get(rows, 0) < self.depth or not inflight:
                buf = self._allocate(rows)
                self._allocated[rows] = self._allocated.get(rows, 0) + 1
                self.allocations += 1
                return buf
            buf, fence = inflight.popleft()
        # Wait outside the lock: commit() must stay callable.
        self.fence_waits += 1
        _wait_fence(fence)
        return buf

    def commit(self, buf: np.ndarray, fence) -> None:
        """Return `buf` to the pool, gated on `fence` (an object with
        synchronize(), such as a torch.cuda.Event, or None)."""
        rows = buf.shape[0]
        with self._lock:
            if fence is None:
                self._free.setdefault(rows, deque()).append(buf)
            else:
                self._inflight.setdefault(rows, deque()).append((buf, fence))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "transfer_pool_buffers": sum(self._allocated.values()),
                "transfer_pool_fence_waits": self.fence_waits,
            }


def _wait_fence(fence) -> None:
    """Block until the op that read the buffer has run on the device."""
    fence.synchronize()
