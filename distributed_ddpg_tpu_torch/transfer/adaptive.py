"""Adaptive ingest-coalesce controller.

A copy of distributed_ddpg_tpu/transfer/adaptive.py. `ingest_coalesce`
caps how many staged blocks fold into one super-block ship
(replay/device.py); the right value depends on the actor:learner
throughput ratio. This controller owns the EFFECTIVE cap, a power of two
in [lo, hi]:

  - GROW (x2) when, after a ship, the staging queue still holds at least
    one full super-block at the current cap: inflow outpaces the ships.
  - SHRINK (/2) when a ship's time a block exceeds `stall_ratio` x its
    EWMA: a dispatch stall, so smaller ships interleave better.

Correctness does not depend on the cap sequence: a coalesced insert lands
every row where the serial sequence would for any k (replay/device.py
`_coalesce_k`), so the controller changes when rows land, never where.
It drives single-process shipping only (its timings are the host's own).
"""

from __future__ import annotations

import threading
from typing import Dict


class AdaptiveCoalesce:
    def __init__(
        self,
        hi: int,
        block_size: int,
        lo: int = 1,
        stall_ratio: float = 3.0,
        ewma_alpha: float = 0.2,
    ):
        if lo < 1 or hi < lo:
            raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
        self._lo = 1 << (int(lo).bit_length() - 1)
        self._hi = 1 << (int(hi).bit_length() - 1)
        self._block = int(block_size)
        self._ratio = float(stall_ratio)
        self._alpha = float(ewma_alpha)
        # Start at the floor and earn headroom from observed backlog.
        self._cap = self._lo
        self._ewma_per_block = 0.0
        self.grows = 0
        self.shrinks = 0
        self._lock = threading.Lock()

    def cap(self) -> int:
        """Current effective max_coalesce (power of two in [lo, hi])."""
        return self._cap

    def observe_ship(self, blocks: int, ship_s: float, queue_rows: int) -> None:
        """Feed one completed ship: blocks coalesced, its wall time, and
        the staging queue's depth after the pop."""
        if blocks <= 0:
            return
        per_block = ship_s / blocks
        with self._lock:
            prev = self._ewma_per_block
            self._ewma_per_block = (
                per_block
                if prev == 0.0
                else (1.0 - self._alpha) * prev + self._alpha * per_block
            )
            if prev > 0.0 and per_block > self._ratio * prev and self._cap > self._lo:
                # Dispatch stall: back off before growing again.
                self._cap >>= 1
                self.shrinks += 1
            elif queue_rows >= self._cap * self._block and self._cap < self._hi:
                # Backlog still holds a full next-size super-block: grow.
                self._cap <<= 1
                self.grows += 1

    def snapshot(self) -> Dict[str, int]:
        """The cap (a gauge) and the cumulative grows and shrinks."""
        return {
            "transfer_coalesce_cap": self._cap,
            "transfer_coalesce_grows": self.grows,
            "transfer_coalesce_shrinks": self.shrinks,
        }
