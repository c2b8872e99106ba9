"""The process-level pod supervisor (counterpart of
distributed_ddpg_tpu/supervisor/, the same classes and decisions): it
spawns the pod's N training processes, dispatches on their typed exit
codes (exits.py), and drives the kill -> shrink -> health-gated grow
cycle with no operator in the loop.

  core.py    PodSupervisor: the generation loop, the exit-code dispatch,
             exponential backoff, the crash-loop circuit breaker, and the
             stop-the-world grow resize
  prober.py  HealthProber: background /healthz polling of lost peers
             with K-consecutive-healthy + hysteresis flap damping
  events.py  the supervisor's own JSONL event stream (spawn/exit/shrink/
             grow/backoff/breaker)

Stdlib only: the supervisor must outlive a crash of the device runtime,
so it never imports torch.
"""

from distributed_ddpg_tpu_torch.supervisor.core import (
    PodSupervisor,
    SupervisorConfig,
    SupervisorGaveUp,
    classify_generation,
)
from distributed_ddpg_tpu_torch.supervisor.events import EventLog
from distributed_ddpg_tpu_torch.supervisor.prober import HealthProber

__all__ = [
    "PodSupervisor",
    "SupervisorConfig",
    "SupervisorGaveUp",
    "classify_generation",
    "EventLog",
    "HealthProber",
]
