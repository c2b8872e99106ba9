"""Host -> device transfer scheduling of the port's ingest pipeline.

A trimmed copy of distributed_ddpg_tpu/transfer/ (which imports no JAX):

  - scheduler.TransferScheduler: one dispatch thread and prioritized work
    classes, byte-fair between the bulk classes;
  - adaptive.AdaptiveCoalesce: the effective ingest_coalesce cap (grow
    while the staging queue backs up, shrink on a dispatch stall);
  - hostbuf.HostBufferPool: reusable staging buffers for a super-block's
    H2D copy (pinned on the card), fenced on the insert that read them.
"""

from distributed_ddpg_tpu_torch.transfer.adaptive import AdaptiveCoalesce
from distributed_ddpg_tpu_torch.transfer.hostbuf import HostBufferPool
from distributed_ddpg_tpu_torch.transfer.scheduler import (
    TransferError,
    TransferScheduler,
    TransferTicket,
)

__all__ = [
    "AdaptiveCoalesce",
    "HostBufferPool",
    "TransferError",
    "TransferScheduler",
    "TransferTicket",
]
