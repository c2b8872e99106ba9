"""Production serving front, the port of distributed_ddpg_tpu/serve/front/
(docs/SERVING.md 'Network front'): network
ingress + versioned policy snapshots with canary promote + per-tenant
QoS, layered over the serve subsystem's Batcher/InferenceServer.

  - wire.py       length-prefixed JSON frames, the typed error contract
  - qos.py        tenant table, token buckets, priority-ordered shedding
  - snapshots.py  immutable named versions, atomic promote, canary gate
  - ingress.py    FrontServer: TCP frame server + HTTP adapter + routing
  - client.py     FrontClient: the socket client serve_bench/tests use
"""

from distributed_ddpg_tpu_torch.serve.front.client import FrontClient, FrontError
from distributed_ddpg_tpu_torch.serve.front.ingress import FrontServer
from distributed_ddpg_tpu_torch.serve.front.qos import (
    QosGate,
    TenantPolicy,
    TokenBucket,
    parse_tenants,
)
from distributed_ddpg_tpu_torch.serve.front.snapshots import (
    CanaryGate,
    SnapshotStore,
)
from distributed_ddpg_tpu_torch.serve.front.wire import (
    ERROR_CODES,
    MAX_FRAME,
    WireError,
)

__all__ = [
    "CanaryGate",
    "ERROR_CODES",
    "FrontClient",
    "FrontError",
    "FrontServer",
    "MAX_FRAME",
    "QosGate",
    "SnapshotStore",
    "TenantPolicy",
    "TokenBucket",
    "WireError",
    "parse_tenants",
]
