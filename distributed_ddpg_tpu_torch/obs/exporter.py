"""Live telemetry ingress: one stdlib HTTP exporter thread a process
(counterpart of distributed_ddpg_tpu/obs/exporter.py; `--obs_port`, off by
default). Three endpoints:

  /metrics   Prometheus text exposition (version 0.0.4), rendered from
             the latest MetricsLogger record of each kind plus the
             caller's cumulative counters. Each JSONL field becomes one
             `ddpg_<field>{kind="..."}` gauge family: the JSONL schema is
             the scrape schema, no second registry to drift.
  /healthz   The typed state machine (obs/health.py): 200 and JSON while
             healthy, 503 and JSON (state, reasons) when degraded or
             draining.
  /trace     An on-demand flight-recorder export (trace.py), the network
             sibling of the SIGUSR2 poke. It writes `trace_ondemand.json`
             beside the run's trace artifacts, never over the clean exit's
             `trace.json`.

Everything here is stdlib (`http.server`) and off the hot path: the server
thread blocks in accept(), rendering happens on the scrape thread, and the
train loop's only cost is MetricsLogger's latest-record bookkeeping.

The server binds all interfaces and serves read-only diagnostics without
auth: point it at a private network, not the internet.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.obs import health as health_mod

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# stop() bounds its wait for the serve_forever thread: a scrape handler
# wedged on a dead client must delay shutdown, not hang it (the thread is
# a daemon — an expired join leaks nothing the exit won't reap).
_STOP_JOIN_TIMEOUT_S = 5.0


def _sanitize(name: str) -> str:
    """JSONL field name -> Prometheus metric name segment."""
    out = _NAME_RE.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _numeric(v: Any) -> Optional[float]:
    """Prometheus sample value for a JSONL field: bools as 0/1, numbers
    as-is, everything else (strings, None, nested) unexportable."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def render_prometheus(
    latest_by_kind: Optional[Dict[str, Dict[str, Any]]],
    counters: Optional[Dict[str, Any]] = None,
    health: Optional[health_mod.HealthState] = None,
) -> str:
    """Prometheus text format. Samples are grouped per metric family
    (the exposition format forbids interleaving a family's samples), one
    `# TYPE ... gauge` line ahead of each family."""
    families: Dict[str, List[str]] = {}

    def add(name: str, value: float, labels: str = "") -> None:
        families.setdefault(name, []).append(f"{name}{labels} {value:g}")

    if health is not None:
        state, _ = health.state()
        add("ddpg_health_code", float(health_mod.CODES[state]))
        for s in (health_mod.HEALTHY, health_mod.DEGRADED,
                  health_mod.DRAINING):
            add("ddpg_health", float(s == state), f'{{state="{s}"}}')
    for name in sorted(counters or {}):
        num = _numeric((counters or {})[name])
        if num is not None:
            add(f"ddpg_{_sanitize(name)}", num)
    for kind in sorted(latest_by_kind or {}):
        rec = (latest_by_kind or {})[kind]
        for key in sorted(rec):
            if key == "kind":
                continue
            num = _numeric(rec[key])
            if num is not None:
                add(f"ddpg_{_sanitize(key)}", num, f'{{kind="{kind}"}}')
    lines: List[str] = []
    for name in sorted(families):
        lines.append(f"# TYPE {name} gauge")
        lines.extend(families[name])
    return "\n".join(lines) + "\n"


class ObsExporter:
    """The per-process exporter thread (module docstring).

    `latest_fn` returns `{kind: latest record}` (MetricsLogger.latest);
    `counters_fn` returns extra cumulative gauges (uptime, t_unix_base,
    process index). Both are polled per scrape, never cached. port=0
    binds an ephemeral port (tests); the bound port is `self.port` after
    start().
    """

    def __init__(
        self,
        port: int,
        *,
        health: Optional[health_mod.HealthState] = None,
        latest_fn: Optional[Callable[[], Dict[str, Dict[str, Any]]]] = None,
        counters_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        trace_dir: str = "",
        host: str = "",
    ):
        self._health = health if health is not None else health_mod.get()
        self._latest_fn = latest_fn
        self._counters_fn = counters_fn
        self._trace_dir = trace_dir
        self._host = host
        self.port = int(port)
        self._t0 = time.time()
        self._scrapes = 0
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ObsExporter":
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):  # scrapes must not spam stderr
                pass

            def do_GET(self):
                try:
                    exporter._route(self)
                except (BrokenPipeError, ConnectionError):
                    pass  # scraper hung up mid-response
                except Exception as e:  # diagnostics must not crash
                    try:
                        exporter._send(self, 500, "text/plain",
                                       f"exporter error: {e!r}\n")
                    except Exception:
                        pass

        server = ThreadingHTTPServer((self._host, self.port), _Handler)
        server.daemon_threads = True
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever, name="obs-exporter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        server = self._server
        if server is not None:
            self._server = None
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=_STOP_JOIN_TIMEOUT_S)
            self._thread = None

    def url(self, path: str = "/metrics") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    # -- routing ---------------------------------------------------------

    def _counters(self) -> Dict[str, Any]:
        with self._lock:
            scrapes = self._scrapes
        out = {
            "obs_scrapes_total": scrapes,
            "obs_uptime_s": round(time.time() - self._t0, 3),
            "pid": os.getpid(),
        }
        if self._counters_fn is not None:
            try:
                out.update(self._counters_fn())
            except Exception:
                pass  # a failing counter source degrades to the basics
        return out

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        path = handler.path.split("?", 1)[0]
        if path == "/metrics":
            with self._lock:
                self._scrapes += 1
            latest = {}
            if self._latest_fn is not None:
                try:
                    latest = self._latest_fn()
                except Exception:
                    latest = {}
            body = render_prometheus(latest, self._counters(), self._health)
            self._send(handler, 200,
                       "text/plain; version=0.0.4; charset=utf-8", body)
        elif path == "/healthz":
            snap = self._health.snapshot()
            status = 200 if snap["state"] == health_mod.HEALTHY else 503
            self._send(handler, status, "application/json",
                       json.dumps(snap) + "\n")
        elif path == "/trace":
            if not trace.enabled():
                self._send(handler, 200, "application/json",
                           json.dumps({"enabled": False, "events": 0}) + "\n")
                return
            out = os.path.join(self._trace_dir or ".", "trace_ondemand.json")
            n = trace.export(out)
            self._send(handler, 200, "application/json",
                       json.dumps({"enabled": True, "events": n,
                                   "path": out}) + "\n")
        else:
            self._send(handler, 404, "text/plain",
                       "endpoints: /metrics /healthz /trace\n")

    @staticmethod
    def _send(handler: BaseHTTPRequestHandler, status: int, ctype: str,
              body: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)
