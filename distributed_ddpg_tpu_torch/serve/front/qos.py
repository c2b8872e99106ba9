"""Per-tenant QoS for the network front, a copy of
distributed_ddpg_tpu/serve/front/qos.py (docs/SERVING.md 'Network front'): token-bucket rate caps plus priority-ordered overload shedding
on the batcher's bounded queue.

Two independent shed causes, counted separately (metrics.TenantStats):

  rate      the tenant's own token bucket is empty — a per-tenant cap
            that fires regardless of load, so one chatty tenant cannot
            crowd out the rest even when the queue is shallow.
  priority  the queue is deep enough that this tenant's PRIORITY CLASS
            sheds: class thresholds are staggered so the lowest class
            sheds first and priority 0 never depth-sheds at all (it only
            ever sees the batcher's own typed overload at a full
            queue). This is the "overload sheds lowest-priority tenants
            first" contract tests/test_serve_front.py pins.

Tenant table grammar (config.front_tenants):

    name:priority[:rate[:burst]];name:priority...

priority 0 is highest; rate is tokens/second (0 = uncapped); burst is
the bucket depth (default max(1, rate)). Unknown tenants get
`default_priority` and no rate cap.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional


class TenantPolicy(NamedTuple):
    name: str
    priority: int
    rate: float  # tokens/s; 0 = uncapped
    burst: float


def parse_tenants(spec: str) -> Dict[str, TenantPolicy]:
    """Parse the tenant table; raises ValueError with the offending entry
    (config validation calls this at parse time — fail fast, not at the
    first shed)."""
    table: Dict[str, TenantPolicy] = {}
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        parts = entry.split(":")
        if not 2 <= len(parts) <= 4 or not parts[0]:
            raise ValueError(
                f"front_tenants entry {entry!r}: expected "
                "name:priority[:rate[:burst]]"
            )
        name = parts[0]
        if name in table:
            raise ValueError(f"front_tenants: duplicate tenant {name!r}")
        try:
            priority = int(parts[1])
            rate = float(parts[2]) if len(parts) > 2 else 0.0
            burst = float(parts[3]) if len(parts) > 3 else max(1.0, rate)
        except ValueError:
            raise ValueError(
                f"front_tenants entry {entry!r}: non-numeric field"
            )
        if priority < 0:
            raise ValueError(
                f"front_tenants entry {entry!r}: priority must be >= 0"
            )
        if rate < 0:
            raise ValueError(
                f"front_tenants entry {entry!r}: rate must be >= 0"
            )
        if burst < 1:
            raise ValueError(
                f"front_tenants entry {entry!r}: burst must be >= 1"
            )
        table[name] = TenantPolicy(name, priority, rate, burst)
    return table


class TokenBucket:
    """Classic token bucket; `now` is injectable so tests drive it with a
    fake clock instead of sleeping."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: Optional[float] = None

    def allow(self, now: float) -> bool:
        if self._last is not None:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class QosGate:
    """Admission control in front of one version's batcher.

    `admit(tenant, depth)` returns None to admit, or the shed cause
    ('rate' | 'priority'). Depth thresholds per priority class p, with
    P = the highest priority in play and s = shed_start:

        p == 0:  1.0            (never depth-shed; the full queue's own
                                 typed overload is the only backpressure)
        p >= 1:  s + (1-s) * (P-p) / P

    Strictly decreasing in p, so as the queue fills the classes shed in
    exact priority order: the lowest class crosses its threshold first
    (at s), the next class only at a strictly deeper queue, and so on.
    """

    def __init__(
        self,
        tenants: Dict[str, TenantPolicy],
        default_priority: int = 1,
        shed_start: float = 0.5,
        clock=time.monotonic,
    ):
        self._tenants = dict(tenants)
        self._default_priority = max(0, int(default_priority))
        self._shed_start = float(shed_start)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._max_priority = max(
            [p.priority for p in self._tenants.values()]
            + [self._default_priority, 1]
        )

    def priority(self, tenant: str) -> int:
        pol = self._tenants.get(tenant)
        return pol.priority if pol is not None else self._default_priority

    def threshold(self, priority: int) -> float:
        if priority <= 0:
            return 1.0
        p = min(priority, self._max_priority)
        s = self._shed_start
        return s + (1.0 - s) * (self._max_priority - p) / self._max_priority

    def admit(self, tenant: str, depth: int, max_queue: int):
        """None = admitted; 'rate' / 'priority' = shed cause."""
        pol = self._tenants.get(tenant)
        if pol is not None and pol.rate > 0:
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = TokenBucket(pol.rate, pol.burst)
                    self._buckets[tenant] = bucket
                if not bucket.allow(self._clock()):
                    return "rate"
        if max_queue > 0 and depth / max_queue >= self.threshold(
            self.priority(tenant)
        ):
            return "priority"
        return None
