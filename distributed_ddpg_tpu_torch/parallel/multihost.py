"""The pod layer: a training run over more than one node, and its defences
against a lost peer (counterpart of distributed_ddpg_tpu/parallel/
multihost.py, over torch.distributed).

The mapping from the JAX package:

- **A JAX process is a port node.** A JAX process is one host in
  `jax.distributed`. A port node is the ranks that torchrun starts under
  one `--node_rank` (its GROUP_RANK); the node's rank with LOCAL_RANK 0
  is the node's lead. `process_index()` is the node's index among the
  pod's nodes, `process_count()` their number (parallel/mesh.py learns
  both when the group is joined).
- **Each node's lead runs that node's actors**, as each JAX process runs
  its own (train.py). Its rows wait in its replay's staging ring.
- **The sync_ship beat gathers all the nodes' rows** into every rank's
  replicated ring (replay/device.py): the beat all-gathers the nodes'
  staged counts, ships the common minimum of full blocks, and lands node
  p's k blocks at the offsets j*(procs*bs) + p*bs + r from the ring's
  pointer, the layout of the JAX replay's _ship_global.
- **With one node the pod layer is off**, as the JAX package's is in a
  single-process run: every guarded call is a direct call, and a group of
  D ranks on one node is the data-parallel group of parallel/mesh.py
  unchanged (rank 0's rows shared with share_rows).
- **The launcher names the backend.** torchrun (or tools/supervise.py)
  sets the rendezvous (RANK, WORLD_SIZE, LOCAL_RANK, GROUP_RANK,
  GROUP_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); beside it the variable
  DDPG_DIST_BACKEND names the process group's backend: "nccl" (the
  default on the card, one rank a card) or "gloo" (the default on the CPU;
  on the card it lets several ranks share one, as a two-node pod on a
  one-card machine needs). Any other value raises. The port never
  switches to gloo by itself after NCCL fails. This is the port's
  counterpart of the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
  JAX_PROCESS_ID contract.

A gloo or NCCL collective whose peer died blocks the survivors until the
process group's timeout. This module owns three defences, all behind the
one entry point every pod collective goes through:

1. **Collective deadlines.** `call_with_deadline` bounds a pod collective
   by `pod_collective_timeout_s` (configure_pod; the transfer scheduler's
   lockstep lane wraps its beats in it too). A hung collective raises a
   typed `PodPeerLost` instead of blocking; with no deadline configured
   (one node) the wrapper is a direct call. `grant()` extends the
   deadline across known-long windows (the first chunk's kernel build).
   Once one pod collective has failed, every later pod gather raises at
   once: its peer is gone, and a second collective on the same gloo
   group while the first is still blocked in it would be undefined.
2. **Peer liveness.** `beat_allgather` carries a heartbeat word (this
   process's beat count) beside the beat's staged-row count, so every
   beat refreshes a last-known-alive vector, which a PodPeerLost's
   message quotes.
3. **Coordinated resume.** `elect_resume_step` all-gathers each node's
   valid checkpoint steps and returns the greatest one every node holds,
   so a pod relaunched after an abort (exit 76) never resumes forked;
   `elect_slice_step` adopts a sharded replay's slice set only where
   every node sees the same newest complete one.

`startup_barrier` is the one-time rendezvous with its own grace
(pod_startup_grace_s), so start-up skew is never read as a dead peer.

Which detector sees which failure: a peer that dies or hangs in a pod
collective (a beat, the env-step gather, the aggregator's gather, an
election) is seen by the deadline, or at once by the transport error of
a dead peer's closed connection. A peer that dies inside the learner's
own collective (the mesh launch's all-reduce after each K1 chunk,
parallel/learner.py, on the default group) is seen by the process
group's timeout, which initialize() derives from the pod deadline plus
the grace plus 120 s (as the JAX package stretches its runtime's
heartbeat), so that the pod layer, not torch's timeout, is first to see
a peer lost at a beat.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import Iterable, Optional

import numpy as np

# The process-group variable beside torchrun's rendezvous (module docstring).
BACKEND_ENV = "DDPG_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")


class PodPeerLost(RuntimeError):
    """A pod collective missed its deadline or failed in flight: some peer
    node is gone (dead, preempted or hung). Survivors take the coordinated
    clean abort (train.py: fail the transfer scheduler's pending tickets,
    write one emergency checkpoint, exit EXIT_POD_DEGRADED), since any
    further collective would block or fork the pod.

    `peer` is the rank the transport error named, when it named one
    (best effort; None for a silent timeout or gloo's address-only
    messages). `reason` is "timeout" or "error"."""

    def __init__(self, message: str, peer: Optional[int] = None,
                 reason: str = "timeout"):
        super().__init__(message)
        self.peer = peer
        self.reason = reason


# --- the module's pod state (configured once a run by train.py) ---
_pod_lock = threading.Lock()
_tls = threading.local()     # re-entrancy: a nested guard does not arm twice
_pod_deadline_s = 0.0        # 0 = deadlines off (one node)
_pod_stats = None            # metrics.PodStats, when train.py attaches one
_pod_grace_until = 0.0       # monotonic end of the grant's extension
_beat_seq = 0                # this process's heartbeat word
_last_heartbeats = None      # the last gathered heartbeat vector
_group = None                # the DataGroup whose pod plane the gathers use
_lost: Optional[PodPeerLost] = None   # the first failed pod collective


def use_group(group) -> None:
    """Make `group` (a parallel/mesh.DataGroup) the one the pod gathers run
    on; None (or a group of one node) makes every gather local."""
    global _group
    with _pod_lock:
        _group = group


def process_index() -> int:
    """This node's index among the pod's nodes (0 with no pod)."""
    g = _group
    return int(g.process_index) if g is not None else 0


def process_count() -> int:
    """The pod's number of nodes (1 with no pod)."""
    g = _group
    return int(g.process_count) if g is not None else 1


def configure_pod(timeout_s: float, stats=None) -> None:
    """Arm (or, with 0, disarm) the pod collective deadline and attach the
    PodStats sink. train.py calls this on a pod only, so a run on one node
    keeps the direct path. Either way the latch of a failed collective is
    cleared."""
    global _pod_deadline_s, _pod_stats, _pod_grace_until, _beat_seq
    global _last_heartbeats, _lost
    with _pod_lock:
        _pod_deadline_s = max(0.0, float(timeout_s))
        _pod_stats = stats
        _pod_grace_until = 0.0
        _lost = None
        if _pod_deadline_s == 0.0:
            _beat_seq = 0
            _last_heartbeats = None


def grant(extra_s: float) -> None:
    """Suppress the deadline until `extra_s` seconds from now: the pod
    sibling of Watchdog.grant, for known-long windows (the first chunk's
    kernel build can skew the nodes by more than the steady deadline; a
    node that is building is not a dead one)."""
    global _pod_grace_until
    with _pod_lock:
        _pod_grace_until = max(_pod_grace_until, time.monotonic() + float(extra_s))


def end_grant() -> None:
    """End any grant now. The trainer calls it once the first chunk has
    run: on a pod that chunk ends in the mesh launch's all-reduce, which
    every node has joined, so no build skew is left to absorb (the JAX
    trainer lets its grant run out instead)."""
    global _pod_grace_until
    with _pod_lock:
        _pod_grace_until = 0.0


def pod_deadline_s() -> float:
    """The armed steady deadline (0 = off)."""
    return _pod_deadline_s


def beat_result_timeout_s(default_s: float = 600.0) -> float:
    """The outer wait of a background lockstep ticket (replay/device.py
    sync_ship, train.py wait_beat and its ordered gathers). With the
    deadline armed the lane's beat in flight is already bounded by
    call_with_deadline, so the wait covers one queued beat behind one in
    flight, any grant and some slack: 2 t + grace + 30 s. Unarmed (one
    node), `default_s`."""
    t = _pod_deadline_s
    if t <= 0:
        return float(default_s)
    with _pod_lock:
        grace = max(0.0, _pod_grace_until - time.monotonic())
    return 2.0 * t + grace + 30.0


def wait_beat_ticket(ticket, label: str = "sync_ship beat"):
    """Resolve one background lockstep ticket within beat_result_timeout_s,
    turning a TimeoutError into a typed PodPeerLost: the one owner of the
    bounded wait for both waiters (replay/device.py sync_ship and train.py
    wait_beat). Returns the beat's result; re-raises the beat's own
    exception (the lane deadline's PodPeerLost) as it is."""
    timeout = beat_result_timeout_s()
    try:
        return ticket.result(timeout=timeout)
    except TimeoutError as e:
        _note_peer_lost(f"pod_peer_lost:{label}")
        raise _latch(PodPeerLost(
            f"background {label} unresolved after {timeout:.0f}s: the ordered beat "
            "lane is wedged (scheduler stalled or a peer node is gone)",
            reason="timeout")) from e


def _latch(err: PodPeerLost) -> PodPeerLost:
    """Remember the first failed pod collective (see the module docstring)."""
    global _lost
    with _pod_lock:
        if _lost is None:
            _lost = err
    return err


def call_with_deadline(fn, timeout_s: Optional[float] = None,
                       label: str = "collective"):
    """Run `fn` bounded by the pod collective deadline. timeout_s=None uses
    the configured one; <= 0 (or none configured) calls `fn` directly on
    the caller's thread: no helper, no overhead.

    A guarded call runs on a helper thread; if the deadline (plus any
    grant) passes first, `PodPeerLost(reason="timeout")` raises on the
    caller while the abandoned helper stays blocked (the caller is leaving
    the run, and a wedged gloo op has no cancel). A call that returns in
    time records its elapsed time in PodStats (the near-miss and slack
    fields)."""
    t = _pod_deadline_s if timeout_s is None else float(timeout_s)
    if t <= 0 or getattr(_tls, "guarded", False):
        # Off, or under an outer guard already (the lane's wrap around a
        # beat whose inner gathers are guarded too): one deadline, one
        # helper thread, one peer-lost count a collective.
        return fn()
    with _pod_lock:
        grace_left = _pod_grace_until - time.monotonic()
    if grace_left > 0:
        t += grace_left
    box: dict = {}
    done = threading.Event()

    def _run():
        _tls.guarded = True
        try:
            box["result"] = fn()
        except BaseException as e:   # delivered to the waiting caller
            box["exc"] = e
        finally:
            done.set()

    t0 = time.monotonic()
    helper = threading.Thread(target=_run, daemon=True, name=f"pod-deadline-{label}")
    helper.start()
    if not done.wait(t):
        stats = _pod_stats
        if stats is not None:
            stats.record_peer_lost()
        from distributed_ddpg_tpu_torch import trace

        trace.instant("pod_peer_lost", label=label, deadline_s=t)
        _note_peer_lost(f"pod_peer_lost:{label}")
        raise _latch(PodPeerLost(
            f"pod collective {label!r} missed its {t:.1f}s deadline: a peer node is "
            f"gone or hung ({_liveness_note()})", reason="timeout"))
    elapsed = time.monotonic() - t0
    if "exc" in box:
        raise box["exc"]
    stats = _pod_stats
    if stats is not None:
        stats.record_collective(elapsed, t)
    return box["result"]


def _note_peer_lost(reason: str) -> None:
    """Flip the health state (obs/health.py) to degraded the moment a peer
    is declared lost, so /healthz reads degraded through the abort's
    teardown. Never raises: the abort path gains no failure mode here."""
    try:
        from distributed_ddpg_tpu_torch.obs import health

        health.get().note(reason)
    except Exception:
        pass


def _parse_peer(message: str) -> Optional[int]:
    """Best-effort peer rank from a transport error's text. NCCL's
    watchdog prefixes its reports with the reporting rank ("[Rank 0] ..."),
    which names this process, not the peer: that prefix is skipped. gloo
    names a dead peer by its address only ("Connection closed by peer
    [10.0.0.2]:4567"), which gives no rank (None)."""
    text = re.sub(r"\[\s*rank\s*\d+\s*\]", " ", message, flags=re.IGNORECASE)
    m = re.search(r"(?:peer(?:\s+rank)?|task|process|rank)[\s:#=]*(\d+)", text,
                  re.IGNORECASE)
    return int(m.group(1)) if m else None


def _liveness_note() -> str:
    """The last-known-alive summary of a PodPeerLost's message: the
    heartbeat vector of the last beat that completed."""
    with _pod_lock:
        beats = _last_heartbeats
        seq = _beat_seq
    if beats is None:
        return "no heartbeat beat completed yet"
    return f"last heartbeats per process {list(int(b) for b in beats)} at local beat {seq}"


def last_heartbeats():
    """The last gathered heartbeat vector (or None)."""
    with _pod_lock:
        return None if _last_heartbeats is None else _last_heartbeats.copy()


def resolve_backend(device: str) -> str:
    """The process group's backend: DDPG_DIST_BACKEND when set ("nccl" or
    "gloo", anything else raises), else NCCL on the card and gloo on the
    CPU."""
    name = os.environ.get(BACKEND_ENV, "").strip().lower()
    if not name:
        return "nccl" if str(device).startswith("cuda") else "gloo"
    if name not in BACKENDS:
        raise ValueError(f"{BACKEND_ENV}={os.environ[BACKEND_ENV]!r}: the process group's "
                         f"backend must be one of {BACKENDS}")
    return name


def group_timeout_s(pod_collective_timeout_s: float, pod_startup_grace_s: float) -> float:
    """The process group's own timeout on a pod: the pod deadline plus the
    grace plus 120 s, so a peer lost at a pod collective is the pod
    layer's to see first (JAX train.py derives its runtime heartbeat the
    same way). With the deadline off, mesh.DEFAULT_TIMEOUT_S."""
    from distributed_ddpg_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    if pod_collective_timeout_s > 0:
        return float(pod_collective_timeout_s) + float(pod_startup_grace_s) + 120.0
    return DEFAULT_TIMEOUT_S


def initialize(device: str = "cuda", pod_collective_timeout_s: float = 0.0,
               pod_startup_grace_s: float = 0.0):
    """Join the process group of a torchrun (or tools/supervise.py) launch
    and return this rank's DataGroup (parallel/mesh.py), or None when the
    environment names no group (WORLD_SIZE unset or 1). The backend is
    resolve_backend's; on a pod (GROUP_WORLD_SIZE > 1) the group's timeout
    is group_timeout_s's, on one node mesh.DEFAULT_TIMEOUT_S. The group
    becomes the one the pod gathers use."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from distributed_ddpg_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, init_data_group

    backend = resolve_backend(device)
    pod = int(os.environ.get("GROUP_WORLD_SIZE", "1")) > 1
    timeout = (group_timeout_s(pod_collective_timeout_s, pod_startup_grace_s) if pod
               else DEFAULT_TIMEOUT_S)
    group = init_data_group(backend, device, timeout_s=timeout)
    use_group(group)
    return group


# Every integer pod gather (the startup barrier, the beats, the env-step
# gather, the election, the aggregator) is padded into one int64 vector of
# this many slots, as in the JAX package: one wire size for them all. The
# election's newest-8-steps window is sized to it.
_UNIFORM_SLOTS = 8


def _allgather_np(arr: np.ndarray) -> np.ndarray:
    """Every rank's `arr` (the same shape and dtype on each) gathered over
    the pod plane (a gloo group of CPU tensors), the nodes' leads' rows in
    node order: [process_count, *arr.shape]. Without a pod, arr[None]."""
    g = _group
    if g is None or g.world_size == 1 or g.process_count == 1:
        return np.asarray(arr)[None]
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(arr))
    outs = [torch.empty_like(t) for _ in range(g.world_size)]
    dist.all_gather(outs, t, group=g.pod)
    return np.stack([outs[r].numpy() for r in g.lead_ranks])


def _guarded(gather, label: str, timeout_s: Optional[float] = None):
    """`gather()` under the deadline; a transport error on a pod becomes a
    typed PodPeerLost(reason="error"). After any failed pod collective
    every later one raises at once."""
    lost = _lost
    if lost is not None:
        raise PodPeerLost(f"pod collective {label!r} not issued: an earlier pod "
                          f"collective failed ({lost})", peer=lost.peer, reason=lost.reason)
    try:
        return call_with_deadline(gather, timeout_s=timeout_s, label=label)
    except PodPeerLost:
        raise
    except Exception as e:
        if process_count() > 1:
            stats = _pod_stats
            if stats is not None:
                stats.record_peer_lost()
            from distributed_ddpg_tpu_torch import trace

            trace.instant("pod_peer_lost", label=label, error=repr(e)[:120])
            _note_peer_lost(f"pod_peer_lost:{label}")
            raise _latch(PodPeerLost(
                f"pod collective {label!r} failed mid-flight: {e!r} ({_liveness_note()})",
                peer=_parse_peer(str(e)), reason="error")) from e
        raise


def allgather_scalar(value, dtype=None, timeout_s: Optional[float] = None,
                     label: str = "allgather"):
    """All-gather one host scalar (or a small fixed-shape vector) across
    the pod's nodes; returns a numpy array [process_count, ...]. The one
    host-initiated pod collective of the beats, the env-step budget, the
    election and the aggregator, so every caller goes through one guarded
    entry point: a hung gather raises PodPeerLost at the deadline, a
    transport error on a pod is typed the same way. Small integer payloads
    ride the uniform int64[_UNIFORM_SLOTS] transport."""
    arr = np.asarray(value, dtype) if dtype is not None else np.asarray(value)
    uniform = arr.dtype.kind in "iu" and arr.ndim <= 1 and arr.size <= _UNIFORM_SLOTS

    def _gather():
        if uniform:
            payload = np.zeros((_UNIFORM_SLOTS,), np.int64)
            payload[: arr.size] = arr.reshape(-1)
            out = _allgather_np(payload)
            out = out[:, : arr.size] if arr.ndim else out[:, 0]
            return out.astype(arr.dtype, copy=False)
        return _allgather_np(arr)

    return _guarded(_gather, label, timeout_s)


def allgather_rows(rows: np.ndarray, label: str = "sync_ship_rows") -> np.ndarray:
    """Every node lead's packed f32 rows [n, W] (the same n on every rank;
    a rank that is not its node's lead sends zeros) gathered under the
    deadline: [process_count, n, W] in node order. The beat's row
    exchange (replay/device.py _ship_global)."""
    rows = np.ascontiguousarray(rows, np.float32)
    return _guarded(lambda: _allgather_np(rows), label)


def beat_allgather(count, label: str = "sync_ship_beat"):
    """All-gather one int payload a node with a heartbeat word (this
    process's beat count) beside it: the sync_ship beat's count gather.
    Every beat that completes refreshes last_heartbeats(), so when a later
    collective dies, the PodPeerLost message says how recently each peer
    was provably alive. Returns the gathered payload column
    [process_count]."""
    global _beat_seq, _last_heartbeats
    with _pod_lock:
        _beat_seq += 1
        seq = _beat_seq
    gathered = allgather_scalar(np.asarray([int(count), seq], np.int64), label=label)
    with _pod_lock:
        _last_heartbeats = gathered[:, 1].copy()
    stats = _pod_stats
    if stats is not None:
        stats.note_beat()
    return gathered[:, 0]


def startup_barrier(grace_s: float, label: str = "pod_startup_barrier") -> None:
    """The one-time pod rendezvous, with its own grace (pod_startup_grace_s)
    instead of the steady deadline: a node's start-up can lag by tens of
    seconds under load, and that skew is absorbed once here. No-op
    without a pod."""
    if process_count() <= 1:
        return
    t0 = time.monotonic()
    allgather_scalar(np.int32(process_index()), timeout_s=float(grace_s), label=label)
    print(f"[pod] startup barrier: {process_count()} processes synchronized in "
          f"{time.monotonic() - t0:.1f}s", file=sys.stderr, flush=True)


def clock_handshake(label: str = "clock_handshake") -> Optional[dict]:
    """The start-up wall-clock handshake: each node all-gathers its wall
    clock (int64 ms, the uniform transport) at one synchronized point, so
    every node learns every other's offset from node 0; trace.set_meta
    records them, the correction that puts the nodes' traces on one clock.
    Returns {"wall_ms": [per node], "offset_ms": [per node, from node 0]},
    None without a pod."""
    if process_count() <= 1:
        return None
    gathered = allgather_scalar(np.int64(int(time.time() * 1000.0)), label=label)
    wall_ms = [int(v) for v in np.asarray(gathered).reshape(-1)]
    return {"wall_ms": wall_ms, "offset_ms": [v - wall_ms[0] for v in wall_ms]}


def _common_step(gathered) -> int:
    """The greatest checkpoint step present on every node, from the
    [process_count, k] gathered step matrix (-1 = padding); -1 when none
    is common. Every node computes it from the same matrix."""
    rows = np.asarray(gathered, np.int64)
    common = None
    for row in rows:
        steps = {int(v) for v in row if int(v) >= 0}
        common = steps if common is None else (common & steps)
    return max(common) if common else -1


def elect_resume_step(local_steps: Iterable[int], limit: int = 8) -> int:
    """The coordinated resume election: all-gather each node's newest
    `limit` valid checkpoint steps and return the greatest step every node
    holds; restoring a newer one on some nodes only would fork the pod. -1
    = no common step (every node starts fresh, also agreed). Every node
    calls it at the same point (train.py's resume)."""
    steps = sorted({int(s) for s in local_steps})[-max(1, int(limit)):]
    vec = np.full((max(1, int(limit)),), -1, np.int64)
    if steps:
        vec[: len(steps)] = np.asarray(steps, np.int64)
    gathered = allgather_scalar(vec, label="resume_step_election")
    return _common_step(gathered)


def elect_slice_step(local_step: Optional[int]) -> int:
    """The slice adoption's election (JAX elect_slice_step): all-gather
    each node's newest complete slice step (checkpoint.
    latest_complete_slice_step) and adopt it only when every node sees
    the same one; any disagreement (a lagging shared filesystem, per-host
    disks) is -1 on every node, since a pod where some nodes load rows
    and others do not has forked its data. Without a pod, the local
    answer. Every node calls it at the same point (train.py's resume)."""
    local = -1 if local_step is None else int(local_step)
    if process_count() <= 1:
        return local
    gathered = allgather_scalar(np.int64(local), label="slice_step_election")
    vals = {int(v) for v in np.asarray(gathered).reshape(-1)}
    return local if vals == {local} and local >= 0 else -1


def typed_peer_loss(fn, label: str = "collective"):
    """`fn()` on the caller's thread; on a pod, a RuntimeError or OSError it
    raises (torch.distributed's transport errors: gloo's when a peer died
    inside a learner collective on the default group) becomes
    PodPeerLost(reason="error"), so the
    trainer takes the coordinated abort and not a crash. No deadline, no
    helper thread: the learner's collectives stay on the thread that
    issued them. Without a pod, a direct call."""
    if process_count() <= 1:
        return fn()
    try:
        return fn()
    except PodPeerLost:
        raise
    except (RuntimeError, OSError) as e:
        stats = _pod_stats
        if stats is not None:
            stats.record_peer_lost()
        _note_peer_lost(f"pod_peer_lost:{label}")
        raise _latch(PodPeerLost(
            f"pod collective {label!r} failed mid-flight: {e!r} ({_liveness_note()})",
            peer=_parse_peer(str(e)), reason="error")) from e


def process_info() -> dict:
    """This rank's place in the pod: its node's index and the nodes'
    number, its node's ranks (one card each under NCCL) and the group's."""
    g = _group
    if g is None:
        return {"process_index": 0, "process_count": 1, "local_device_count": 1,
                "global_device_count": 1}
    node = g.lead_ranks[g.process_index]
    nxt = g.lead_ranks[g.process_index + 1] if g.process_index + 1 < g.process_count \
        else g.world_size
    return {"process_index": int(g.process_index), "process_count": int(g.process_count),
            "local_device_count": int(nxt - node), "global_device_count": int(g.world_size)}
