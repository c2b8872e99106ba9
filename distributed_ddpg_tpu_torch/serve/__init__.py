"""Batched policy-inference service.

The port of distributed_ddpg_tpu/serve/: an `InferenceServer` owns the
policy params (refreshed from the learner through the pool's broadcast
buffer), a dynamic `Batcher` collects client observations and dispatches
at `max_batch` OR `max_latency_ms`, whichever fires first, and clients
attach in-process (`ServeClient`; tools/serve_bench.py) or across
processes (actor workers through `ServeFront`, under config.serve_actors).

  - batcher.Batcher: deadline dispatch, bounded queue with typed
    `ServeOverload` backpressure, flush on shutdown.
  - server.InferenceServer: params and compute (the numpy parity oracle,
    the device apply, the tensor-parallel apply over a model group with
    `mesh=` and its `ServeFollower` on the group's other ranks), the
    transfer scheduler's `serve` class, the `serve_*` counters
    (metrics.ServeStats).
  - client.ServeClient / client.ServeFront: the blocking local handle and
    the served actors' mp-queue front.
  - front/: the network front (framed TCP and HTTP ingress, versioned
    snapshots with canary promote, per-tenant QoS).

Importing the package imports no torch: the device backend loads it when
a server is built with it.
"""

from distributed_ddpg_tpu_torch.serve.batcher import (
    Batcher,
    ServeClosed,
    ServeDispatchError,
    ServeOverload,
    ServeTimeout,
)
from distributed_ddpg_tpu_torch.serve.client import ServeClient, ServeFront
from distributed_ddpg_tpu_torch.serve.front import (
    FrontClient,
    FrontError,
    FrontServer,
    SnapshotStore,
)
from distributed_ddpg_tpu_torch.serve.server import (
    InferenceServer,
    ServeFollower,
    ServeGroupLost,
)

__all__ = [
    "Batcher",
    "FrontClient",
    "FrontError",
    "FrontServer",
    "InferenceServer",
    "ServeClient",
    "ServeClosed",
    "ServeDispatchError",
    "ServeFollower",
    "ServeFront",
    "ServeGroupLost",
    "ServeOverload",
    "ServeTimeout",
    "SnapshotStore",
]
