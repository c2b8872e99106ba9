"""Serve clients: the in-process blocking handle and the served-actor
front.

A copy of distributed_ddpg_tpu/serve/client.py. `ServeClient.act(obs)`
blocks until the server's batcher delivers this request's action row, or
raises typed (ServeOverload / ServeClosed when the request was shed,
ServeDispatchError when its batch failed, ServeTimeout when the client's
own deadline passed). tools/serve_bench.py drives load through it.

`ServeFront` bridges the actor pool's multiprocessing transport onto the
in-process batcher: worker processes put `(worker_id, request_id, obs)` on
one shared bounded request queue (actors/pool.py builds it under
config.serve_actors), the front drains it into `Batcher.submit`, and each
completion pushes `(request_id, action | None)` onto that worker's own
response queue. `None` tells the worker the service could not serve this
request: it degrades to its local act() path (actors/worker.py
`served_mu`). A stalled or crashed serving stack costs latency, never a
deadlock.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Optional

import numpy as np

from distributed_ddpg_tpu_torch.serve.batcher import ServeClosed, ServeOverload, ServeTimeout


class ServeClient:
    """Blocking in-process handle over one InferenceServer."""

    def __init__(self, server, timeout_s: float = 1.0, tenant: str = "local"):
        self._server = server
        self.timeout_s = float(timeout_s)
        self.tenant = tenant
        self._rid = 0

    def act(self, obs, timeout_s: Optional[float] = None) -> np.ndarray:
        """One observation row in, one action row out; raises typed on a
        shed, failed or late request."""
        done = threading.Event()
        box: list = []

        def _cb(result):
            box.append(result)
            done.set()

        self._server.batcher.submit(np.asarray(obs, np.float32), _cb)
        if not done.wait(self.timeout_s if timeout_s is None else timeout_s):
            raise ServeTimeout(f"no response within {timeout_s or self.timeout_s}s")
        result = box[0]
        if isinstance(result, BaseException):
            raise result
        if getattr(self._server, "sac", False):
            # SAC's head: the batch apply returns [mean | log_std]; sample
            # with this client's per-request key (server.sample).
            self._rid += 1
            return self._server.sample(result, tenant=self.tenant, request_id=self._rid)
        return result


class ServeFront:
    """Drain thread: the pool's request queue -> batcher -> the workers'
    response queues. Lives in the learner process beside the
    InferenceServer."""

    def __init__(self, server, request_queue, response_queues):
        self._server = server
        self._req = request_queue
        self._resp = response_queues
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServeFront":
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve-front")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def _respond(self, wid: int, rid: int, action) -> None:
        """Best-effort delivery: a full response queue means the worker
        already gave up on this request (it bounds its own wait and falls
        back locally), so dropping the reply is right."""
        try:
            self._resp[wid].put_nowait((rid, action))
        except (queue_mod.Full, ValueError, OSError):
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                wid, rid, obs = self._req.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            except (OSError, ValueError, EOFError):
                return  # the transport was torn down: the pool is stopping

            def _cb(result, wid=wid, rid=rid):
                if isinstance(result, BaseException):
                    self._respond(wid, rid, None)
                    return
                if getattr(self._server, "sac", False):
                    # SAC's head: sample with this worker's key (tenant =
                    # worker id, request_id = its own counter), so every
                    # worker has its own replayable exploration stream.
                    result = self._server.sample(result, tenant=str(wid), request_id=rid)
                self._respond(wid, rid, result)

            try:
                self._server.batcher.submit(np.asarray(obs, np.float32), _cb)
            except (ServeOverload, ServeClosed):
                self._respond(wid, rid, None)
