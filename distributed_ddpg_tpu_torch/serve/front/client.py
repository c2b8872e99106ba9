"""Socket client for the network front, a copy of
distributed_ddpg_tpu/serve/front/client.py (docs/SERVING.md 'Network
front'): the closed-loop load generator's transport
(tools.serve_bench --transport socket) and the test harness's.

`FrontClient.act` is the one-call surface: frame the request, block on
the response, return the action row — or raise `FrontError` carrying the
typed wire code, so a caller degrades on `shed`/`overload` exactly like
ServeClient degrades on ServeOverload."""

from __future__ import annotations

import socket
from typing import Optional, Tuple

import numpy as np

from distributed_ddpg_tpu_torch.serve.front import wire


class FrontError(RuntimeError):
    """A typed error response from the front; `code` is one of
    wire.ERROR_CODES."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code


class FrontClient:
    """One persistent framed-TCP connection; NOT thread-safe (one client
    per load thread — requests on a connection are strictly serial)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 tenant: str = "default", timeout_s: float = 5.0):
        self.tenant = tenant
        self._rid = 0
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FrontClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request(self, obj: dict) -> dict:
        """Raw frame round-trip (tests drive malformed objects through
        this). ConnectionError when the server tore the stream down."""
        wire.send_frame(self._sock, obj)
        resp = wire.read_frame(self._sock)
        if resp is None:
            raise ConnectionError("front closed the connection")
        return resp

    def act(
        self,
        obs,
        request_id: Optional[int] = None,
        version: Optional[str] = None,
    ) -> Tuple[np.ndarray, str]:
        """One observation -> (action row, serving version name). Raises
        FrontError with the typed code on any error response."""
        if request_id is None:
            self._rid += 1
            request_id = self._rid
        req = {
            "tenant": self.tenant,
            "request_id": request_id,
            "obs": np.asarray(obs, np.float32).reshape(-1).tolist(),
        }
        if version is not None:
            req["version"] = version
        resp = self.request(req)
        if "error" in resp:
            raise FrontError(resp["error"], resp.get("message", ""))
        return (
            np.asarray(resp["action"], np.float32),
            resp.get("version", ""),
        )
