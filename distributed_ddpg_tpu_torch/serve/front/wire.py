"""Wire protocol for the network serving front: a copy of
distributed_ddpg_tpu/serve/front/wire.py, byte for byte the same frames
(docs/SERVING.md 'Network front').

Frames are 4-byte big-endian length prefixes followed by a UTF-8 JSON
body — the simplest framing that survives partial reads, needs no
dependency, and keeps the HTTP adapter's body format identical to the
socket path's (one JSON object either way).

Request object:

    {"tenant": "<id>", "request_id": <int>, "obs": [<floats>],
     "version": "<name>"?}          # version pins a specific snapshot;
                                    # omitted = canary-split routing

Response object — exactly one of:

    {"request_id": <int>, "action": [<floats>], "version": "<name>"}
    {"request_id": <int>, "error": "<code>", "message": "<text>"}

Error codes (`ERROR_CODES`) are the TYPED failure contract: a client can
switch on the code, and none of them ever kills the acceptor —

    bad_frame  undecodable/oversized frame or malformed request object
    shed       rejected by per-tenant QoS (rate cap or priority shed)
    overload   the target version's bounded batcher queue is full
    timeout    the request aged past front_timeout_s before its batch
               completed
    dispatch   the batch apply failed (ServeDispatchError on the wire)
    closed     the front (or its engine) is shutting down

An undecodable LENGTH PREFIX is unrecoverable (the stream has lost
framing): the server answers one bad_frame error and closes THAT
connection — the acceptor and every other connection survive. JSON-level
garbage inside a well-framed body is recoverable: typed bad_frame
response, connection stays open.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

ERROR_CODES = (
    "bad_frame", "shed", "overload", "timeout", "dispatch", "closed",
)

# One frame bounds one observation row plus envelope; 1 MiB is orders of
# magnitude past any proprioceptive obs and small enough that a garbage
# length prefix can't make the server allocate unbounded memory.
MAX_FRAME = 1 << 20

_LEN = struct.Struct(">I")


class WireError(RuntimeError):
    """A typed wire-level failure; `code` is one of ERROR_CODES."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        if code not in ERROR_CODES:
            raise ValueError(f"unknown wire error code {code!r}")
        self.code = code


def encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise WireError("bad_frame", f"frame body {len(body)}B > {MAX_FRAME}B")
    return _LEN.pack(len(body)) + body


def recv_exactly(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes or return None on clean EOF before any byte.
    EOF MID-object raises (torn frame — the peer died mid-write)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise WireError(
                "bad_frame", f"connection closed mid-frame ({got}/{n}B)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> Optional[dict]:
    """One framed JSON object off the socket; None on clean EOF.
    Raises WireError('bad_frame', ...) on oversized length or invalid
    JSON — the CALLER decides whether that tears the connection (a bad
    length prefix does; a bad body does not)."""
    header = recv_exactly(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(
            "bad_frame",
            f"frame length {length}B > {MAX_FRAME}B (lost framing)",
        )
    body = recv_exactly(sock, length)
    if body is None:
        raise WireError("bad_frame", "connection closed before frame body")
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError("bad_frame", f"invalid JSON body: {e!r}")
    if not isinstance(obj, dict):
        raise WireError("bad_frame", "frame body must be a JSON object")
    return obj


def send_frame(sock: socket.socket, obj: dict) -> None:
    sock.sendall(encode_frame(obj))


def validate_request(obj: dict) -> dict:
    """Normalize + type-check a request object; raises
    WireError('bad_frame') with a field-specific message otherwise."""
    tenant = obj.get("tenant", "")
    if not isinstance(tenant, str) or not tenant:
        raise WireError("bad_frame", "request needs a non-empty 'tenant'")
    rid = obj.get("request_id")
    if not isinstance(rid, int) or isinstance(rid, bool):
        raise WireError("bad_frame", "request needs an int 'request_id'")
    obs = obj.get("obs")
    if not isinstance(obs, list) or not obs or not all(
        isinstance(x, (int, float)) and not isinstance(x, bool) for x in obs
    ):
        raise WireError(
            "bad_frame", "request needs 'obs': a non-empty number list"
        )
    version = obj.get("version")
    if version is not None and not isinstance(version, str):
        raise WireError("bad_frame", "'version' must be a string when given")
    return {"tenant": tenant, "request_id": rid, "obs": obs,
            "version": version}


def error_response(rid, code: str, message: str) -> dict:
    if code not in ERROR_CODES:
        raise ValueError(f"unknown wire error code {code!r}")
    return {"request_id": rid, "error": code, "message": message}
