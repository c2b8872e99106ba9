"""Network ingress for the serving front: a copy of
distributed_ddpg_tpu/serve/front/ingress.py (docs/SERVING.md 'Network
front').

`FrontServer` binds two listeners onto one request path:

  - a length-prefixed-frame TCP server (serve/front/wire.py; stdlib
    socketserver, thread-per-connection — the obs/ daemon-thread
    pattern), and
  - an HTTP/JSON adapter (POST /act) carrying the SAME body objects, so
    curl and load balancers speak to the front without a custom client.

Every accepted request flows: validate -> version route (SnapshotStore
canary split) -> per-tenant QoS admit (QosGate) -> that version's
Batcher -> typed response. Each ACTIVE version (stable + candidate) gets
its own engine — a full InferenceServer with its own Batcher — created
lazily on first route and closed when the version retires, so a canary's
latency is measured against an isolated queue, not polluted by stable's.

The failure contract (wire.py ERROR_CODES) is absolute: overload,
timeout, bad frames, QoS sheds, dispatch failures, and injected chaos
all surface as typed error RESPONSES; none of them may kill the acceptor
or another connection. The only per-connection teardown is a lost frame
boundary (garbage length prefix), and even that answers one bad_frame
first.

Canary verdicts run inline: after every request routed while a candidate
is active, the CanaryGate is consulted — 'rollback' drops the candidate
instantly (front_rollbacks), 'promote' atomically makes it stable
(front_promotes). Chaos: `front:accept:{stall,slow,hang}@K` ticks per
accepted TCP connection, `front:frame:corrupt@K` per decoded frame
(typed bad_frame, connection survives), and `front:canary:regress@K~S`
adds S seconds to every candidate-routed request from its K-th onward —
sustained, because the gate trips on a p95, not an outlier.
"""

from __future__ import annotations

import json
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from distributed_ddpg_tpu_torch.faults import InjectedFault
from distributed_ddpg_tpu_torch.metrics import FrontStats, TenantStats
from distributed_ddpg_tpu_torch.serve.batcher import (
    ServeClosed,
    ServeOverload,
)
from distributed_ddpg_tpu_torch.serve.front import wire
from distributed_ddpg_tpu_torch.serve.front.qos import QosGate, parse_tenants
from distributed_ddpg_tpu_torch.serve.front.snapshots import CanaryGate, SnapshotStore

_STOP_JOIN_TIMEOUT_S = 5.0
_ENGINE_CLOSE_TIMEOUT_S = 5.0

# HTTP status per typed wire error code — the body always carries the
# same JSON error object the socket path sends, the status is advisory.
_HTTP_STATUS = {
    "bad_frame": 400,
    "shed": 429,
    "overload": 429,
    "timeout": 504,
    "dispatch": 500,
    "closed": 503,
}


class FrontServer:
    """The production serving front: TCP frames + HTTP JSON in, typed
    responses out, versioned engines behind a QoS gate."""

    def __init__(
        self,
        make_engine: Callable,
        *,
        port: int = 0,
        http_port: Optional[int] = 0,
        timeout_s: float = 2.0,
        canary_fraction: float = 0.1,
        canary_min_requests: int = 50,
        canary_threshold: float = 0.5,
        tenants="",
        default_priority: int = 1,
        shed_start: float = 0.5,
        stats: Optional[FrontStats] = None,
        tenant_stats: Optional[TenantStats] = None,
        seed: int = 0,
        fault_accept=None,
        fault_frame=None,
        canary_regressions=(),
    ):
        """`make_engine()` returns a fresh, UNSTARTED InferenceServer
        (serve/server.py) — one is built per active version and fed that
        version's flat params via refresh(). port/http_port: 0 = bind an
        ephemeral port (read .port/.http_port after start()), None for
        http_port = no HTTP adapter."""
        self._make_engine = make_engine
        self._req_port = int(port)
        self._req_http_port = http_port if http_port is None else int(http_port)
        self.timeout_s = float(timeout_s)
        self.canary_fraction = float(canary_fraction)
        self.stats = stats or FrontStats(seed=seed)
        self.tenant_stats = tenant_stats or TenantStats()
        table = parse_tenants(tenants) if isinstance(tenants, str) else tenants
        self.qos = QosGate(
            table, default_priority=default_priority, shed_start=shed_start
        )
        self.store = SnapshotStore()
        self.gate = CanaryGate(
            canary_min_requests, canary_threshold, seed=seed
        )
        self._fault_accept = fault_accept
        self._fault_frame = fault_frame
        self._canary_regs = tuple(canary_regressions)
        self._cand_ordinal = 0
        self._lock = threading.Lock()  # engines + verdict application
        self._engines: Dict[str, object] = {}
        self._tcp = None
        self._http = None
        self._threads = []
        self.port = 0
        self.http_port = 0

    # --- version lifecycle ---

    def publish(self, name: str, flat: np.ndarray) -> None:
        self.store.publish(name, flat)

    def start_canary(self, name: str, fraction: Optional[float] = None) -> None:
        self.gate.reset()
        with self._lock:
            self._cand_ordinal = 0
        self.store.start_canary(
            name, self.canary_fraction if fraction is None else fraction
        )

    def promote(self, name: Optional[str] = None) -> str:
        with self._lock:
            old_stable = self.store.stable
            promoted = self.store.promote(name)
            self.stats.record_promote()
            self.gate.reset()
            retired = (
                self._engines.pop(old_stable, None)
                if old_stable not in (None, promoted)
                else None
            )
        if retired is not None:
            retired.close(timeout=_ENGINE_CLOSE_TIMEOUT_S)
        return promoted

    def rollback(self) -> Optional[str]:
        with self._lock:
            dropped = self.store.rollback()
            if dropped is None:
                return None
            self.stats.record_rollback()
            self.gate.reset()
            retired = self._engines.pop(dropped, None)
        if retired is not None:
            retired.close(timeout=_ENGINE_CLOSE_TIMEOUT_S)
        return dropped

    def engine(self, name: str):
        """Get-or-create the live engine for a version (started, params
        installed). KeyError for unknown names."""
        with self._lock:
            eng = self._engines.get(name)
            if eng is None:
                flat = self.store.get(name)
                eng = self._make_engine()
                eng.refresh(flat)
                eng.start()
                self._engines[name] = eng
        return eng

    # --- request path (shared by TCP and HTTP) ---

    def handle_request(self, obj: dict, http: bool = False) -> dict:
        """One request object in, one response object out. Never raises
        for request-level failures — the typed-response contract."""
        try:
            req = wire.validate_request(obj)
        except wire.WireError as e:
            self.stats.record_bad_frame()
            return wire.error_response(
                obj.get("request_id") if isinstance(obj, dict) else None,
                e.code, str(e),
            )
        self.stats.record_request(http=http)
        t0 = time.monotonic()
        rid, tenant = req["request_id"], req["tenant"]
        try:
            if req["version"] is not None:
                name = req["version"]
                is_canary = name == self.store.candidate
                if name not in self.store.names():
                    return wire.error_response(
                        rid, "bad_frame", f"unknown version {name!r}"
                    )
            else:
                name, is_canary = self.store.route(tenant, rid)
        except RuntimeError as e:
            return wire.error_response(rid, "closed", str(e))
        canary_active = self.store.candidate is not None
        if is_canary:
            self.stats.record_canary_request()
            with self._lock:
                self._cand_ordinal += 1
                ordinal = self._cand_ordinal
            extra = max(
                (s for at, s in self._canary_regs if ordinal >= at),
                default=0.0,
            )
            if extra > 0:
                time.sleep(extra)  # front:canary:regress@K~S (sustained)
        eng = self.engine(name)
        cause = self.qos.admit(
            tenant, eng.batcher.depth(), eng.batcher.max_queue
        )
        if cause is not None:
            self.stats.record_shed()
            self.tenant_stats.record_shed(tenant, cause)
            return wire.error_response(
                rid, "shed",
                f"request shed by tenant QoS ({cause}); "
                f"priority={self.qos.priority(tenant)}",
            )

        done = threading.Event()
        box: list = []

        def _cb(result):
            box.append(result)
            done.set()

        error: Optional[tuple] = None
        try:
            eng.batcher.submit(
                np.asarray(req["obs"], np.float32), _cb
            )
        except ServeOverload as e:
            self.stats.record_overload()
            error = ("overload", str(e))
        except ServeClosed as e:
            error = ("closed", str(e))
        if error is None:
            remaining = self.timeout_s - (time.monotonic() - t0)
            if not done.wait(max(0.0, remaining)):
                self.stats.record_timeout()
                error = ("timeout", f"no response within {self.timeout_s}s")
            else:
                result = box[0]
                if isinstance(result, BaseException):
                    self.stats.record_error()
                    error = ("dispatch", f"{result!r}")
        latency = time.monotonic() - t0
        if canary_active:
            self.gate.record(is_canary, latency, error=error is not None)
            self._apply_verdict()
        if error is not None:
            self.tenant_stats.record_error(tenant)
            return wire.error_response(rid, *error)
        action = result
        if getattr(eng, "sac", False):
            # SAC serve head: the engine returned [mean | log_std]; the
            # per-client sampling key lives HERE, derived from
            # (tenant, request_id) — docs/SERVING.md 'SAC serve head'.
            action = eng.sample(action, tenant=tenant, request_id=rid)
        self.tenant_stats.record_served(tenant)
        self.stats.record_wire_latency(latency)
        return {
            "request_id": rid,
            "action": np.asarray(action, np.float32).reshape(-1).tolist(),
            "version": name,
        }

    def _apply_verdict(self) -> None:
        verdict = self.gate.verdict()
        if verdict == "rollback":
            self.rollback()
        elif verdict == "promote":
            with self._lock:
                has_candidate = self.store.candidate is not None
            if has_candidate:
                self.promote()

    # --- listeners ---

    def start(self) -> "FrontServer":
        front = self

        class _FrameHandler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                if front._fault_accept is not None:
                    front._fault_accept.tick()  # front:accept:*@K
                while True:
                    try:
                        obj = wire.read_frame(sock)
                    except wire.WireError as e:
                        # Lost framing: answer once, drop THIS connection.
                        front.stats.record_bad_frame()
                        try:
                            wire.send_frame(
                                sock,
                                wire.error_response(None, e.code, str(e)),
                            )
                        except OSError:
                            pass
                        return
                    except OSError:
                        return  # peer reset — nothing to answer
                    if obj is None:
                        return  # clean EOF
                    try:
                        if front._fault_frame is not None:
                            front._fault_frame.tick()  # front:frame:corrupt@K
                        resp = front.handle_request(obj)
                    except InjectedFault as e:
                        front.stats.record_bad_frame()
                        resp = wire.error_response(
                            obj.get("request_id"), "bad_frame",
                            f"corrupt frame: {e!r}",
                        )
                    except Exception as e:
                        # Belt-and-braces: the acceptor NEVER dies for a
                        # request (handle_request already types known
                        # failures).
                        resp = wire.error_response(
                            obj.get("request_id"), "dispatch", f"{e!r}"
                        )
                    try:
                        wire.send_frame(sock, resp)
                    except OSError:
                        return  # client went away mid-response

        class _TCP(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._tcp = _TCP(("127.0.0.1", self._req_port), _FrameHandler)
        self.port = self._tcp.server_address[1]
        t = threading.Thread(
            target=self._tcp.serve_forever, daemon=True, name="front-tcp"
        )
        t.start()
        self._threads.append(t)

        if self._req_http_port is not None:
            class _HttpHandler(BaseHTTPRequestHandler):
                def log_message(self, *args):  # quiet: metrics, not stderr
                    pass

                def _send(self, status: int, obj: dict) -> None:
                    body = json.dumps(obj).encode("utf-8")
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def do_POST(self):
                    try:
                        if self.path.rstrip("/") not in ("/act", ""):
                            self._send(404, {"error": "bad_frame",
                                             "message": "POST /act"})
                            return
                        try:
                            n = int(self.headers.get("Content-Length", 0))
                            if n > wire.MAX_FRAME:
                                raise wire.WireError(
                                    "bad_frame", f"body {n}B > {wire.MAX_FRAME}B"
                                )
                            obj = json.loads(self.rfile.read(n))
                            if not isinstance(obj, dict):
                                raise wire.WireError(
                                    "bad_frame", "body must be a JSON object"
                                )
                        except (wire.WireError, ValueError,
                                UnicodeDecodeError) as e:
                            front.stats.record_bad_frame()
                            self._send(400, wire.error_response(
                                None, "bad_frame", f"{e}"))
                            return
                        resp = front.handle_request(obj, http=True)
                        self._send(
                            _HTTP_STATUS.get(resp.get("error"), 200), resp
                        )
                    except OSError:
                        pass  # client disconnected mid-response

            self._http = ThreadingHTTPServer(
                ("127.0.0.1", self._req_http_port), _HttpHandler
            )
            self.http_port = self._http.server_address[1]
            t = threading.Thread(
                target=self._http.serve_forever, daemon=True,
                name="front-http",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        for srv in (self._tcp, self._http):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        for t in self._threads:
            t.join(timeout=_STOP_JOIN_TIMEOUT_S)
        self._threads = []
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for eng in engines:
            eng.close(timeout=_ENGINE_CLOSE_TIMEOUT_S)

    # --- observability ---

    def snapshot(self) -> dict:
        """front_* + tenant_* families (metrics.py) for the train JSONL
        record and serve_bench digests."""
        out = self.stats.snapshot()
        out.update(self.tenant_stats.snapshot())
        return out
