"""The telemetry plane (counterpart of distributed_ddpg_tpu/obs/): the live
per-process ingress (`/metrics`, `/healthz`, `/trace`; obs/exporter.py),
the typed health state machine (obs/health.py), the probe of a peer's
ingress (obs/probe.py) and the pod's cross-node aggregation and
straggler attribution (obs/aggregate.py, PodAggregator, over the pod's
all-gather). No torch; aggregate.py needs numpy."""

from distributed_ddpg_tpu_torch.obs import health
from distributed_ddpg_tpu_torch.obs.aggregate import PodAggregator, detect_straggler
from distributed_ddpg_tpu_torch.obs.exporter import ObsExporter, render_prometheus
from distributed_ddpg_tpu_torch.obs.probe import ProbeResult, probe_healthz

__all__ = [
    "health",
    "ObsExporter",
    "PodAggregator",
    "detect_straggler",
    "render_prometheus",
    "ProbeResult",
    "probe_healthz",
]
