"""One health probe of a (possibly remote) process's telemetry ingress
(counterpart of distributed_ddpg_tpu/obs/probe.py).

`probe_healthz` answers "is this process up and healthy?" in two layers:

  1. A TCP connect to the exporter's port. Refused, unreachable or timed
     out: the host (or its network path) is gone.
  2. GET /healthz (obs/exporter.py). 200: the state machine says
     `healthy`; 503: `degraded` or `draining`, reachable but not a
     candidate.

A port that accepts TCP but does not speak HTTP counts as healthy by
reachability, with `ProbeResult.state == "tcp"` marking the lower
confidence.

Stdlib only: a prober never pays for torch or a device runtime to poll a
socket.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import socket

# A probe's deadline: one wedged peer delays the next probe, never the
# caller's loop.
PROBE_TIMEOUT_S = 2.0


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    reachable: bool   # TCP connect succeeded
    healthy: bool     # rejoin-candidate verdict (the gate's input)
    state: str        # healthy|degraded|draining|down|tcp|http:<status>
    detail: str = ""  # raw body / error repr, for event-log attribution

    def __bool__(self) -> bool:
        return self.healthy


def probe_healthz(
    host: str, port: int, timeout_s: float = PROBE_TIMEOUT_S
) -> ProbeResult:
    """One probe, never raises (module docstring for the layering)."""
    try:
        sock = socket.create_connection((host, int(port)), timeout=timeout_s)
        sock.close()
    except OSError as e:
        return ProbeResult(False, False, "down", repr(e))
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
    except (OSError, http.client.HTTPException) as e:
        # Reachable but not speaking HTTP: the documented TCP-reachability
        # fallback (reduced confidence, state="tcp").
        return ProbeResult(True, True, "tcp", repr(e))
    finally:
        conn.close()
    try:
        state = str(json.loads(body).get("state", ""))
    except ValueError:
        state = ""
    if resp.status == 200:
        return ProbeResult(True, True, state or "healthy", body.strip())
    return ProbeResult(
        True, False, state or f"http:{resp.status}", body.strip()
    )
