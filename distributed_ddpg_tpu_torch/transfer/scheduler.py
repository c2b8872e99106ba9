"""The host <-> device transfer scheduler.

A trimmed copy of distributed_ddpg_tpu/transfer/scheduler.py (one
dispatch thread and prioritized work classes, one owner of every host <->
device stream instead of a private thread each):

  lockstep   host-initiated collective beats: strict FIFO and absolute
             priority, so every process issues them in the same order;
  shard_exchange  a sharded replay's beats (replay/device.py): queued in
             the lockstep lane itself (one FIFO, the same pod deadline),
             counted apart in transfer_shard_exchange_*;
  ingest     inbound staged-replay super-blocks (the H2D copy + insert);
  prefetch   outbound sampled-chunk H2D (a host replay's);
  serve      policy-inference batch dispatches;
  d2h        learner params and metrics pulls: learner-critical, so they
             run INLINE on the caller's thread (run_inline), accounted
             like the rest but never queued.

Between ingest, prefetch and serve the scheduler does start-time fair
queuing by bytes (a virtual time a class, advanced by bytes / weight): an
item of one class waits at most about one in-flight item of another, and
a class that was idle re-enters at the current virtual time, so it cannot
bank credit. In the port the device replay's ships are submitted as
ingest items, the host replay's chunk copies (parallel/prefetch.py) as
prefetch items, and a pod's background sync_ship beats and its ordered
gathers (train.py run_ordered) as lockstep items. With
`lockstep_timeout_s` > 0 (a pod: the pod deadline) every lockstep item
runs under parallel/multihost.call_with_deadline, so a beat whose peer
died fails its ticket with PodPeerLost at the deadline instead of
wedging the lane, and the lane goes on serving; so does every
shard_exchange item.

Failures: an exception thrown by a work item lands in its ticket (the
submitter's problem; the replay turns it into its bounded-restart and
IngestError path). An exception in the loop itself (an injected fault at
the `fault` site, ticked once an item before it runs) kills the thread,
which restarts itself up to `max_restarts` times; within that budget the
crash is transparent (the item goes back to the head of its queue), past
it every pending and future ticket raises TransferError.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.metrics import TransferStats

LOCKSTEP = "lockstep"
INGEST = "ingest"
PREFETCH = "prefetch"
SERVE = "serve"
D2H = "d2h"
SHARD_EXCHANGE = "shard_exchange"

_QUEUED_CLASSES = (LOCKSTEP, INGEST, PREFETCH, SERVE, SHARD_EXCHANGE)
# The classes of the strict-FIFO ordered lane (one deque, LOCKSTEP's).
_ORDERED_CLASSES = (LOCKSTEP, SHARD_EXCHANGE)
_FAIR_CLASSES = (INGEST, PREFETCH, SERVE)


def _lane(cls: str) -> str:
    """The queue a class waits in: shard_exchange shares lockstep's."""
    return LOCKSTEP if cls == SHARD_EXCHANGE else cls


class TransferError(RuntimeError):
    """The transfer scheduler thread is dead (restart budget spent) or
    closed; the original exception rides along as __cause__."""


class TransferTicket:
    """Completion handle of one submitted work item. `result()` returns the
    item's return value, re-raises its exception, or raises TransferError
    if the scheduler died or closed before the item ran."""

    __slots__ = ("label", "_done", "_result", "_exc")

    def __init__(self, label: str = ""):
        self.label = label
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def _finish(self, result=None, exc: Optional[BaseException] = None) -> None:
        self._result = result
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block up to `timeout` for completion; True when done. Never
        raises."""
        return self._done.wait(timeout)

    @property
    def exception(self) -> Optional[BaseException]:
        return self._exc if self._done.is_set() else None

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"transfer item {self.label or '<unnamed>'} not done within {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._result


class _Item:
    __slots__ = ("cls", "fn", "nbytes", "ticket")

    def __init__(self, cls: str, fn: Callable, nbytes: int, ticket: TransferTicket):
        self.cls = cls
        self.fn = fn
        self.nbytes = int(nbytes)
        self.ticket = ticket


class TransferScheduler:
    def __init__(
        self,
        stats: Optional[TransferStats] = None,
        fault=None,
        max_restarts: int = 3,
        weights: Optional[Dict[str, float]] = None,
        lockstep_timeout_s: float = 0.0,
    ):
        self.stats = stats or TransferStats()
        # Any object with a tick() (the JAX package's FaultSite interface),
        # ticked once a dequeued item, outside the item's own try.
        self._fault = fault
        # The pod deadline of every lockstep item (see the module
        # docstring); 0 = off, a direct call.
        self._lockstep_timeout_s = float(lockstep_timeout_s)
        self._max_restarts = int(max_restarts)
        self.restarts = 0
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {c: deque() for c in (LOCKSTEP,) + _FAIR_CLASSES}
        self._weights = {c: 1.0 for c in _FAIR_CLASSES}
        self._weights.update(weights or {})
        self._vt = {c: 0.0 for c in _FAIR_CLASSES}
        self._global_vt = 0.0
        self._stop = False
        self._dead_exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def start(self) -> "TransferScheduler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="transfer-sched")
        self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Stop the dispatch thread. Queued items that have not started
        fail with TransferError before the join (close runs no stale
        work); the one in flight, if any, runs to its end. A submitter
        that needs its items landed flushes first."""
        with self._cv:
            self._stop = True
        self._fail_pending(TransferError("transfer scheduler closed"))
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        # One that raced the stop flag is failed too, not stranded.
        self._fail_pending(TransferError("transfer scheduler closed"))

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every item queued now has been dispatched."""
        deadline = time.monotonic() + timeout
        with self._cv:
            tickets = [item.ticket for q in self._queues.values() for item in q]
        for t in tickets:
            t._done.wait(max(0.0, deadline - time.monotonic()))

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and self._dead_exc is None)

    # --- submission ---

    def submit(self, cls: str, fn: Callable, nbytes: int = 0,
               label: str = "") -> TransferTicket:
        """Queue one work item; returns its ticket. An ingest callable may
        return an int, the bytes it moved (unknown at submit time under
        coalescing); other classes' return values are payloads."""
        if cls not in _QUEUED_CLASSES:
            raise ValueError(f"unknown transfer class {cls!r}")
        ticket = TransferTicket(label or cls)
        with self._cv:
            if self._dead_exc is not None:
                raise TransferError("transfer scheduler thread died") from self._dead_exc
            if self._stop:
                raise TransferError("transfer scheduler closed")
            q = self._queues[_lane(cls)]
            if cls in self._vt and not q:
                # The class re-enters the fair queue at the current
                # virtual time.
                self._vt[cls] = max(self._vt[cls], self._global_vt)
            q.append(_Item(cls, fn, nbytes, ticket))
            self.stats.record_queue_depth(cls, len(q))
            self._cv.notify_all()
        return ticket

    def run_ordered(self, fn: Callable, label: str = "", timeout: float = 600.0):
        """Run `fn` on the scheduler thread in the lockstep lane and wait
        for its result."""
        return self.submit(LOCKSTEP, fn, label=label).result(timeout=timeout)

    def run_inline(self, cls: str, fn: Callable, nbytes_of=None, label: str = ""):
        """Run `fn` on the caller's thread, accounted as transfer traffic
        of class `cls` (d2h: absolute priority, no queueing)."""
        t0 = time.perf_counter()
        with trace.span(f"transfer_{cls}", label=label):
            result = fn()
        nbytes = int(nbytes_of(result)) if nbytes_of is not None else 0
        self.stats.record_dispatch(cls, nbytes, time.perf_counter() - t0)
        return result

    def queue_depths(self) -> Dict[str, int]:
        with self._cv:
            return {c: len(q) for c, q in self._queues.items()}

    def snapshot(self) -> Dict[str, float]:
        """The transfer_* fields (metrics.TransferStats), with the queue
        depths now and the cumulative restart count."""
        return self.stats.snapshot(queue_depths=self.queue_depths(),
                                   restarts=self.restarts)

    # --- dispatch loop ---

    def _pick_locked(self) -> Optional[_Item]:
        if self._queues[LOCKSTEP]:
            return self._queues[LOCKSTEP].popleft()
        backlogged = [c for c in _FAIR_CLASSES if self._queues[c]]
        if not backlogged:
            return None
        cls = min(backlogged, key=lambda c: self._vt[c])
        return self._queues[cls].popleft()

    def _charge(self, cls: str, nbytes: int) -> None:
        if cls in self._vt:
            # At least one unit an item, so zero-byte items still rotate.
            self._vt[cls] += max(nbytes, 1) / self._weights.get(cls, 1.0)
            self._global_vt = self._vt[cls]

    def _run(self) -> None:
        item: Optional[_Item] = None
        try:
            while True:
                with self._cv:
                    item = self._pick_locked()
                    while item is None and not self._stop:
                        self._cv.wait(0.1)
                        item = self._pick_locked()
                    if item is None and self._stop:
                        return
                if self._fault is not None:
                    self._fault.tick()
                self._dispatch(item)
                item = None   # completed: never requeued by a later crash
        except Exception as e:
            self._on_thread_death(e, item)

    def _dispatch(self, item: _Item) -> None:
        t0 = time.perf_counter()
        try:
            with trace.span(f"transfer_{item.cls}", label=item.ticket.label):
                if item.cls in _ORDERED_CLASSES and self._lockstep_timeout_s > 0:
                    from distributed_ddpg_tpu_torch.parallel import multihost

                    ret = multihost.call_with_deadline(
                        item.fn, timeout_s=self._lockstep_timeout_s,
                        label=item.ticket.label or LOCKSTEP)
                else:
                    ret = item.fn()
        except Exception as e:   # the submitter's problem, not ours
            self.stats.record_dispatch(item.cls, item.nbytes, time.perf_counter() - t0)
            self._charge(item.cls, item.nbytes)
            item.ticket._finish(exc=e)
            return
        # Only an ingest item reports the bytes it moved as its result.
        nbytes = (
            int(ret)
            if item.cls == INGEST and item.nbytes == 0
            and isinstance(ret, (int, float)) and not isinstance(ret, bool)
            else item.nbytes
        )
        self.stats.record_dispatch(item.cls, nbytes, time.perf_counter() - t0)
        self._charge(item.cls, nbytes)
        item.ticket._finish(result=ret)

    def _on_thread_death(self, exc: Exception, item: Optional[_Item]) -> None:
        """The loop itself died, before the item's callable ran (_dispatch
        catches around the callable). Within the budget the item goes back
        to the head of its queue and the thread restarts; past it every
        waiter sees the failure."""
        if self.restarts < self._max_restarts and not self._stop:
            self.restarts += 1
            trace.instant("transfer_restart", n=self.restarts)
            print(f"[transfer] scheduler thread died ({exc!r}); restarting "
                  f"({self.restarts}/{self._max_restarts})", file=sys.stderr, flush=True)
            with self._cv:
                if item is not None and not item.ticket.done():
                    self._queues[_lane(item.cls)].appendleft(item)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="transfer-sched")
            self._thread.start()
            return
        if item is not None and not item.ticket.done():
            item.ticket._finish(exc=exc)
        with self._cv:
            self._dead_exc = exc
        self._fail_pending(TransferError("transfer scheduler thread died"), cause=exc)

    def _fail_pending(self, err: TransferError, cause=None) -> None:
        if cause is not None:
            err.__cause__ = cause
        with self._cv:
            items = [i for q in self._queues.values() for i in q]
            for q in self._queues.values():
                q.clear()
        for i in items:
            if not i.ticket.done():
                i.ticket._finish(exc=err)
