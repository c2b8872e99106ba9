"""Dynamic request batcher of the policy-inference service.

A copy of distributed_ddpg_tpu/serve/batcher.py without its trace spans
(tracing is ROADMAP.md Queue 1 item 12). Clients enqueue single
observations; one dispatcher thread collects them into batches and
dispatches when whichever trigger fires first:

  - the batch reached `max_batch` rows (dispatch at once, never wait out
    the latency window on a full batch), or
  - the OLDEST pending request has waited `max_latency_s` (dispatch the
    partial batch).

Contracts (tests/test_torch_serve.py):

  - Bounded queue with typed backpressure: at most `max_queue` requests
    may be pending; `submit` past that raises `ServeOverload` (an actor
    client degrades to its local act() path, the network front sheds).
  - Flush on shutdown loses nothing: `close()` stops admissions, then the
    dispatcher drains every pending request (partial batches go at once)
    before the thread exits. Every accepted request gets exactly one
    completion callback.
  - A failing batch apply fails typed: every request of that batch
    completes with a `ServeDispatchError` (cause attached), the thread
    survives, and later batches serve normally.

Fault injection (faults.py): `serve:batcher:stall@k` sleeps the k-th
dispatch before its apply (clients time out and fall back locally);
`serve:dispatch:crash@k` raises inside the k-th batch apply.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np


class ServeOverload(RuntimeError):
    """The batcher's bounded request queue is full: typed backpressure.
    The service is shedding load, not broken: retry later or degrade."""


class ServeClosed(RuntimeError):
    """submit() after close(): the service is shutting down (or its
    dispatcher died). Callers degrade as for ServeOverload."""


class ServeDispatchError(RuntimeError):
    """The batch apply of this request's batch raised; the original
    exception rides along as __cause__."""


class ServeTimeout(RuntimeError):
    """A blocking client gave up waiting for its response (its own
    deadline; the request may still complete later, into an abandoned
    ticket)."""


class _Pending:
    __slots__ = ("obs", "callback", "t_enq")

    def __init__(self, obs, callback, t_enq: float):
        self.obs = obs
        self.callback = callback
        self.t_enq = t_enq


class Batcher:
    """One dispatcher thread and a bounded pending deque. `apply_fn` maps a
    stacked [n, obs_dim] f32 batch to [n, out_dim] rows (the
    InferenceServer provides it; n <= max_batch)."""

    def __init__(
        self,
        apply_fn: Callable[[np.ndarray], np.ndarray],
        max_batch: int,
        max_latency_s: float,
        max_queue: int,
        stats=None,
        fault_batcher=None,
        fault_dispatch=None,
        name: str = "serve-batcher",
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._apply = apply_fn
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.max_queue = int(max_queue)
        self.stats = stats
        self._fault_batcher = fault_batcher
        self._fault_dispatch = fault_dispatch
        self._name = name
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def start(self) -> "Batcher":
        self._thread = threading.Thread(target=self._run, daemon=True, name=self._name)
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop admissions, flush every pending request, join. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    # --- submission ---

    def submit(self, obs: np.ndarray, callback: Callable) -> None:
        """Enqueue one observation row. `callback(result)` fires exactly
        once from the dispatcher thread: an [out_dim] f32 row on success,
        an Exception instance (ServeDispatchError / ServeClosed) on
        failure. Raises ServeOverload / ServeClosed when the request was
        NOT accepted (no callback will fire)."""
        p = _Pending(obs, callback, time.monotonic())
        with self._cv:
            if self._closed:
                raise ServeClosed("inference batcher is closed")
            if len(self._q) >= self.max_queue:
                if self.stats is not None:
                    self.stats.record_overload()
                raise ServeOverload(f"serve request queue full ({self.max_queue} pending)")
            self._q.append(p)
            if self.stats is not None:
                self.stats.record_request(len(self._q))
            self._cv.notify_all()

    # --- dispatch loop ---

    def _collect_locked(self) -> List[_Pending]:
        n = min(len(self._q), self.max_batch)
        return [self._q.popleft() for _ in range(n)]

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._q and not self._closed:
                        self._cv.wait(0.05)
                    if not self._q and self._closed:
                        return
                    # The deadline of the OLDEST pending request; a full
                    # batch or shutdown (flush: no deadline wait) cuts the
                    # wait short.
                    deadline = self._q[0].t_enq + self.max_latency_s
                    while len(self._q) < self.max_batch and not self._closed:
                        now = time.monotonic()
                        if now >= deadline:
                            break
                        self._cv.wait(min(deadline - now, 0.05))
                    batch = self._collect_locked()
                if batch:
                    self._dispatch(batch)
        except BaseException as e:  # the dispatcher machinery died: fail loudly
            self._die(e)

    def _dispatch(self, batch: List[_Pending]) -> None:
        try:
            if self._fault_batcher is not None:
                # serve:batcher:stall@k sleeps here: the requests are
                # collected, so their responses arrive late and blocking
                # clients hit their timeout fallback.
                self._fault_batcher.tick()
            # Inside the try: a malformed observation (a wrong obs_dim from
            # a misbehaving client) fails THIS batch typed, not the thread.
            obs = np.stack([p.obs for p in batch]).astype(np.float32, copy=False)
            if self._fault_dispatch is not None:
                self._fault_dispatch.tick()  # serve:dispatch:crash@k
            actions = np.asarray(self._apply(obs))
        except BaseException as e:
            if self.stats is not None:
                self.stats.record_error()
            err = ServeDispatchError(f"inference batch of {len(batch)} failed: {e!r}")
            err.__cause__ = e
            for p in batch:
                self._complete(p, err)
            return
        now = time.monotonic()
        if self.stats is not None:
            self.stats.record_batch(len(batch), [now - p.t_enq for p in batch])
        for i, p in enumerate(batch):
            self._complete(p, actions[i])

    @staticmethod
    def _complete(p: _Pending, result) -> None:
        try:
            p.callback(result)
        except Exception:
            # A client that died mid-wait must not take the service down.
            pass

    def _die(self, exc: BaseException) -> None:
        """The dispatch loop itself crashed (not a batch apply: those are
        caught per batch). Mark closed so submits raise typed, and fail
        every pending request: a client blocked on a dead service gets its
        error, not a hang."""
        err = ServeClosed(f"inference batcher thread died: {exc!r}")
        err.__cause__ = exc
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
        for p in pending:
            self._complete(p, err)
