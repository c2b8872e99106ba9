"""The telemetry plane (counterpart of distributed_ddpg_tpu/obs/): the live
per-process ingress (`/metrics`, `/healthz`, `/trace`; obs/exporter.py),
the typed health state machine (obs/health.py) and the probe of a peer's
ingress (obs/probe.py). Stdlib only, no torch.

The JAX package's cross-host aggregation (obs/aggregate.py,
PodAggregator) needs the pod's all-gather and comes with the pods
(ROADMAP.md Queue 1 item 10)."""

from distributed_ddpg_tpu_torch.obs import health
from distributed_ddpg_tpu_torch.obs.exporter import ObsExporter, render_prometheus
from distributed_ddpg_tpu_torch.obs.probe import ProbeResult, probe_healthz

__all__ = [
    "health",
    "ObsExporter",
    "render_prometheus",
    "ProbeResult",
    "probe_healthz",
]
