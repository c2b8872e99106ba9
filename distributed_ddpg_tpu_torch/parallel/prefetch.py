"""The host replay's chunk pipeline: sample on a thread, copy ahead of the learner.

Counterpart of distributed_ddpg_tpu/parallel/prefetch.py. A daemon thread
samples K minibatches from the host replay (under the trainer's
replay_lock, which also guards its inserts and priority updates), stacks
them into one [K, B, ...] chunk and hands it to `put_chunk`
(ShardedLearner.put_chunk: packed into a pinned buffer and copied to the
card on a side stream, so the copy overlaps the running chunk). `depth`
bounds the queue of chunks ready for the learner: 2 is double buffering.
The sampled indices stay on the host and ride along for PER's priority
updates after the chunk's td comes back.

With a transfer scheduler (transfer/scheduler.py) the put is submitted as
a `prefetch`-class item, so its copy shares the scheduler's byte-fair
queue with the ingest ships; the sampling stays on this thread (CPU work,
not bus work). The JAX module's chaos site (`prefetch:sample`) is not
ported: a `prefetch:*` fault spec raises in faults.py.

Failures: an exception on the thread is raised at the next `next()` as
PrefetchError (the cause chained); a `next()` that waits past its timeout
with the thread alive raises PrefetchTimeout. `stop()` joins the thread,
draining the queue while it waits, so a thread blocked on a full queue
exits.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np

# How long the thread grants an in-flight put to land after stop is
# asked, before it leaves it to the scheduler (whose close() fails
# pending tickets). A bound on the shutdown's courtesy, not a deadline:
# next()'s PrefetchTimeout is that.
_STOP_DRAIN_S = 5.0


class PrefetchError(RuntimeError):
    """The prefetch thread died; its exception rides along as __cause__."""


class PrefetchTimeout(RuntimeError):
    """next() waited past its deadline with the thread alive: the replay
    starves or a device copy is wedged, not a crash (a dead thread raises
    PrefetchError)."""


class ChunkPrefetcher:
    def __init__(
        self,
        replay,
        put_chunk,                  # ShardedLearner.put_chunk (or any placer)
        batch_size: int,
        chunk_size: int,
        depth: int = 2,
        lock: Optional[threading.Lock] = None,
        scheduler=None,             # transfer.TransferScheduler (optional)
    ):
        self._replay = replay
        self._put = put_chunk
        self._sched = scheduler
        self._batch_size = batch_size
        self._chunk = chunk_size
        self._lock = lock or threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="prefetch")

    def start(self) -> "ChunkPrefetcher":
        self._thread.start()
        return self

    def _sample_chunk(self) -> Dict[str, np.ndarray]:
        samples = []
        with self._lock:
            for _ in range(self._chunk):
                samples.append(self._replay.sample(self._batch_size))
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                chunk = self._sample_chunk()
                indices = chunk.pop("indices")
                # Stop asked while we sampled: do not start a copy nobody
                # will take.
                if self._stop.is_set():
                    return
                if self._sched is not None:
                    nbytes = sum(getattr(v, "nbytes", 0) for v in chunk.values())
                    ticket = self._sched.submit(
                        "prefetch", lambda: self._put(chunk), nbytes=nbytes,
                        label="prefetch_h2d")
                    # Bounded waits, so a stop() during a stalled scheduler
                    # still joins; a dead scheduler fails the ticket
                    # (TransferError), which next() raises as PrefetchError.
                    while not ticket.done():
                        if self._stop.is_set():
                            ticket.wait(_STOP_DRAIN_S)
                            break
                        ticket.wait(0.1)
                    if not ticket.done():
                        return
                    device_chunk = ticket.result(timeout=0.0)
                else:
                    device_chunk = self._put(chunk)
                # Block here while the queue is full: the backpressure that
                # makes `depth` the bound.
                while not self._stop.is_set():
                    try:
                        self._q.put((device_chunk, indices), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:   # raised at next()
            self._exc = e

    def next(self, timeout: float = 60.0):
        """(device_chunk, host indices [K, B]). A dead thread's exception is
        raised as soon as it is seen, not after the timeout; a deadline with
        the thread alive raises PrefetchTimeout."""
        deadline = time.monotonic() + timeout
        while True:
            if self._exc is not None:
                raise PrefetchError("prefetch thread died") from self._exc
            try:
                return self._q.get(timeout=min(0.5, max(0.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise PrefetchTimeout(
                        f"no prefetched chunk within {timeout:.1f}s with the worker "
                        "alive: replay starvation or a wedged device transfer") from None

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the thread and join it, draining the queue again and again
        while it waits (a thread blocked on the full queue refills the slot
        a one-off drain frees). Returns False, with a warning, when the
        thread is still alive at the deadline (wedged in a device copy);
        the daemon thread is left rather than hang the teardown."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        if self._thread.is_alive():
            warnings.warn(f"prefetch worker did not exit within {timeout:.1f}s (blocked "
                          "in a device transfer?); leaking the daemon thread")
            return False
        return True
