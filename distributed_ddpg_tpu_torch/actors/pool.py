"""ActorPool: N rollout worker processes feeding one learner.

A copy of distributed_ddpg_tpu/actors/pool.py: the shm and queue
transports, the seqlock param broadcast with its staleness, the heartbeat
monitor with respawn, the zero-rows detector, the quarantine breaker, the
fault plan's worker and pool sites, and the served actors' transport.

- Param broadcast: one flat f32 shared-memory array + a version counter.
  Workers poll the version each env step and copy on change. Each row
  carries the version of the params that acted (the shm ring's last
  column, the queue message's last field); `broadcast(flat, learner_step)`
  maps each version to its learner step, and `staleness()` gives, over
  the workers, the learner steps between the latest broadcast and the
  params behind each worker's latest drained rows (staleness_mean,
  staleness_max).
- Transport (config.transport, resolved as the JAX pool resolves it):
  'shm' gives each worker a C++ SPSC ring in an anonymous shared-memory
  block (native.ShmRing, config.shm_ring_rows rows of [obs, action,
  reward, discount, next_obs, version]) and raises when the ring cannot
  be built; 'auto' takes shm whenever it can be built, else the queue
  (said once on stderr); 'queue' sends each batch, with the episodes it
  finished, over the worker's OWN bounded mp.Queue. On shm that queue
  carries only the finished episodes. `transport` names the one in use;
  `drain_batches` pops either for the device-replay ingest. A ring
  belongs to its slot: a respawned worker attaches to it.
- Failure detection: workers stamp heartbeats; `monitor()` respawns a
  worker that died (`dead`), went silent past the heartbeat timeout
  (`silent`), or, with config.actor_no_progress_s > 0, kept heartbeating
  while delivering no rows for that long (`no_rows`), after a
  per-slot exponential backoff (config.respawn_backoff_s, doubled each
  recent failure up to respawn_backoff_max_s). A slot that fails
  config.quarantine_respawns times within quarantine_window_s is
  QUARANTINED: no more respawns, training goes on with the other workers.
  After config.quarantine_probe_s the slot is probed with one respawn:
  rows delivered and a whole quarantine_window_s survived un-quarantine
  it, a failure re-quarantines it. `quarantine_source` quarantines a slot
  directly (the guardrails' bad-row path, train.py).
- Fault injection (config.faults, faults.py): each worker gets its slice
  of the plan at spawn (`for_worker(id, incarnation)`: one-shot faults arm
  only a slot's first incarnation, `crashloop` every one);
  `pool:broadcast` and `pool:monitor` are ticked once a broadcast and a
  supervision pass. Respawns, quarantines and probes are flight-recorder
  instants (`actor_respawn`, `actor_quarantined`, ...), a broadcast is a
  `param_broadcast` span.
- What a dead worker can leave behind: a process killed outright dies
  holding whatever cross-process lock it held. So every spawn gets a
  fresh queue (an abandoned one may hold a half-written message and its
  write lock; the rows in it are lost, as the in-flight episode is), and
  the version counter, stop flag and heartbeats are lock-free shared
  values (the seqlock needs no mutex: one writer, and readers re-check).
- Served acting (config.serve_actors): workers ask the learner process's
  InferenceServer for mu(s) over ONE bounded shared request queue
  (serve_queue) and a response queue a worker, which a respawned worker
  reuses (its drain-and-fresh-ids start makes that safe). serve_channels()
  hands them to the learner's ServeFront, param_source() the broadcast
  buffer to the server, and serve_counters() reads the workers' local-act
  fallbacks (serve_client_fallbacks).

Uses the 'spawn' start method: workers start from a fresh interpreter and
never inherit the parent's CUDA state.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from distributed_ddpg_tpu_torch import native, trace
from distributed_ddpg_tpu_torch.actors.policy import (
    actor_head_dim,
    decode_version,
    layout_size,
    param_layout,
)
from distributed_ddpg_tpu_torch.actors.worker import run_worker
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec

# Reap bound for a worker we just terminate()d.
_TERMINATE_JOIN_S = 2.0
# Transition batches a worker may have in flight before it blocks.
_QUEUE_BATCHES = 4


def resolve_transport(transport: str) -> str:
    """'shm' or 'queue' for config.transport: 'shm' raises (with the
    compiler's output) when the ring cannot be built, 'auto' is shm
    whenever it can be, and says so on stderr when it cannot (a run makes
    one pool, so once)."""
    if transport == "shm":
        try:
            native.load()
        except RuntimeError as e:
            raise ValueError(f"transport='shm' but the shm ring cannot be built ({e}); "
                             "use transport='queue'") from e
        return "shm"
    if transport == "auto":
        if native.available():
            return "shm"
        print("[actors] transport='auto' resolved to the queue: the shm ring cannot "
              "be built", file=sys.stderr, flush=True)
    return "queue"


class ActorPool:
    def __init__(self, config: DDPGConfig, spec: EnvSpec, num_actors: Optional[int] = None,
                 env_steps_offset: int = 0):
        self.config = config
        # Env steps a resumed run had taken before its checkpoint: they
        # count against the uniform-warmup budget, so a resumed run puts
        # no random actions into its replay again.
        self.env_steps_offset = int(env_steps_offset)
        self.spec = spec
        self.num_actors = num_actors or config.num_actors
        self.heartbeat_timeout = config.heartbeat_timeout_s
        if config.actor_throttle_s >= self.heartbeat_timeout:
            raise ValueError(
                f"actor_throttle_s={config.actor_throttle_s} >= the pool's "
                f"heartbeat timeout ({self.heartbeat_timeout}s): the throttle "
                "sleep sits between heartbeat stamps, so the monitor would "
                "respawn every worker forever"
            )
        self._ctx = mp.get_context("spawn")
        self.layout = param_layout(spec.obs_dim, actor_head_dim(spec.act_dim, config.sac),
                                   tuple(config.actor_hidden))
        self._shared = self._ctx.Array("f", layout_size(self.layout), lock=False)
        self._version = self._ctx.Value("l", 0, lock=False)
        self._queues: List = [None] * self.num_actors
        self._episodes: List[tuple] = []
        self._heartbeat = self._ctx.Array("d", self.num_actors, lock=False)
        self._stop = self._ctx.Value("b", 0, lock=False)
        self._procs: List[Optional[mp.Process]] = [None] * self.num_actors
        self._respawns = 0
        self._steps_received = 0
        # The breaker's state, one entry a slot (see the module docstring).
        self._fail_times: List[List[float]] = [[] for _ in range(self.num_actors)]
        self._backoff_until = [0.0] * self.num_actors
        self._pending_respawn = [False] * self.num_actors
        self._quarantined = [False] * self.num_actors
        self._quarantined_at = [0.0] * self.num_actors
        self._probing = [False] * self.num_actors
        self._probe_t = [0.0] * self.num_actors
        self._unquarantines = 0
        self._plan = config.fault_plan()
        self._broadcast_fault = self._plan.site("pool", "broadcast")
        # pool:monitor:slow@k delays the k-th supervision pass: training
        # must tolerate late failure detection too.
        self._monitor_fault = self._plan.site("pool", "monitor")
        self._incarnation = [0] * self.num_actors
        # The zero-rows detector's clock: 0.0 = no rows this incarnation,
        # armed at the first heartbeat seen (boot time is not production
        # time).
        self._last_rows_t = [0.0] * self.num_actors
        # When rows last came from each slot (drains only): the probe's
        # sustained-progress clock.
        self._rows_seen_t = [0.0] * self.num_actors
        # Staleness: each even version -> the learner step broadcast with
        # it (the newest 64), and each worker's staleness at its last drain.
        self._version_steps: Dict[int, int] = {}
        self._last_broadcast_step = 0
        self._staleness = np.zeros(self.num_actors, np.int64)
        self.serving = bool(config.serve_actors)
        self._serve_req = None
        self._serve_resp: List = []
        self._serve_fallbacks = None
        if self.serving:
            self._serve_req = self._ctx.Queue(maxsize=config.serve_queue)
            self._serve_resp = [self._ctx.Queue(maxsize=8) for _ in range(self.num_actors)]
            self._serve_fallbacks = self._ctx.Array("l", self.num_actors, lock=False)
        self.transport = resolve_transport(config.transport)
        self.row_width = 2 * spec.obs_dim + spec.act_dim + 3
        self._ring_bufs: List = []
        self._rings: List = []
        if self.transport == "shm":
            nbytes = native.ShmRing.nbytes(config.shm_ring_rows, self.row_width)
            for _ in range(self.num_actors):
                buf = self._ctx.Array("B", nbytes, lock=False)
                self._ring_bufs.append(buf)
                self._rings.append(native.ShmRing(buf, config.shm_ring_rows,
                                                  self.row_width, init=True))

    # --- lifecycle ---

    def warmup_budget_per_worker(self) -> int:
        """The uniform-warmup budget left at spawn time
        (config.resolved_warmup_uniform less the env steps of a resumed
        checkpoint and those already drained, so a respawned or resumed
        worker does not put random actions into a trained run's replay),
        split evenly (ceil) across the pool."""
        remaining = max(0, self.config.resolved_warmup_uniform() - self.env_steps_offset
                        - self._steps_received)
        return (remaining + self.num_actors - 1) // self.num_actors

    def _spawn(self, worker_id: int) -> None:
        fault_specs = self._plan.for_worker(worker_id,
                                            incarnation=self._incarnation[worker_id])
        self._incarnation[worker_id] += 1
        self._queues[worker_id] = self._ctx.Queue(maxsize=_QUEUE_BATCHES)
        p = self._ctx.Process(
            target=run_worker,
            kwargs=dict(
                worker_id=worker_id,
                env_id=self.config.env_id,
                seed=self.config.seed + 1000 * (worker_id + 1) + self._respawns,
                layout=self.layout,
                action_scale=self.spec.action_scale,
                action_offset=self.spec.action_offset,
                action_low=self.spec.action_low,
                action_high=self.spec.action_high,
                shared_params=self._shared,
                param_version=self._version,
                transition_queue=self._queues[worker_id],
                heartbeat=self._heartbeat,
                stop_flag=self._stop,
                ou_theta=self.config.ou_theta,
                ou_sigma=self.config.ou_sigma,
                ou_dt=self.config.ou_dt,
                n_step=self.config.n_step,
                gamma=self.config.gamma,
                parent_pid=os.getpid(),
                gaussian_policy=self.config.sac,
                log_std_min=self.config.sac_log_std_min,
                log_std_max=self.config.sac_log_std_max,
                warmup_uniform=self.warmup_budget_per_worker(),
                ring_buf=self._ring_bufs[worker_id] if self._rings else None,
                ring_rows=self.config.shm_ring_rows,
                serve_request_queue=self._serve_req,
                serve_response_queue=self._serve_resp[worker_id] if self.serving else None,
                serve_fallbacks=self._serve_fallbacks,
                serve_timeout_s=self.config.serve_timeout_s,
                serve_fallback_s=self.config.serve_fallback_s,
                fault_specs=fault_specs,
                throttle_s=self.config.actor_throttle_s,
                # Each worker keeps its own flight recorder and writes
                # trace_actor<k>.json on its exit; Perfetto merges by pid.
                trace_dir=self.config.trace_dir,
            ),
            daemon=True,
            name=f"actor-{worker_id}",
        )
        p.start()
        # 0.0 = still booting (interpreter, env imports -- gymnasium and
        # mujoco for their envs -- and the env's build): the silent-timeout
        # respawn arms only once the worker's loop stamps its first
        # heartbeat, so a slow boot is never respawned as silent.
        self._heartbeat[worker_id] = 0.0
        self._last_rows_t[worker_id] = 0.0
        self._rows_seen_t[worker_id] = 0.0
        self._procs[worker_id] = p

    def start(self, flat_params: np.ndarray) -> "ActorPool":
        self.broadcast(flat_params)
        for i in range(self.num_actors):
            self._spawn(i)
        return self

    def stop(self) -> None:
        """Stop the workers, draining the queues first so a worker blocked
        on a full queue can exit, then terminate any that do not."""
        self._stop.value = 1
        deadline = time.time() + 5.0
        for p in self._procs:
            if p is None:
                continue
            while p.is_alive() and time.time() < deadline:
                self.drain_batches()
                p.join(timeout=0.05)
        for p in self._procs:
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=_TERMINATE_JOIN_S)

    # --- serving (serve/) ---

    def serve_channels(self):
        """(request_queue, response_queues) for the learner process's
        ServeFront; None and [] unless config.serve_actors built them."""
        return self._serve_req, self._serve_resp

    def param_source(self):
        """(shared flat-param array, seqlock version): the broadcast buffer
        the workers poll, from which the InferenceServer refreshes too."""
        return self._shared, self._version

    def serve_counters(self) -> Dict[str, int]:
        """The workers' local-act fallbacks for the serve_* fields."""
        if self._serve_fallbacks is None:
            return {}
        return {"serve_client_fallbacks": int(sum(self._serve_fallbacks))}

    # --- param broadcast (learner -> workers) ---

    def broadcast(self, flat_params: np.ndarray, learner_step: int = 0) -> None:
        """Seqlock write: version goes ODD while the flat array is being
        written, EVEN when it is consistent. Workers copy only at even
        versions and re-check after the copy, so a torn parameter vector
        is never acted on. `flat_params` is in policy.flatten_params
        layout (the learner's actor_params_to_host); `learner_step` stamps
        the learner step these params come from (staleness())."""
        self._broadcast_fault.tick()
        with trace.span("param_broadcast", learner_step=int(learner_step)):
            view = np.frombuffer(self._shared, dtype=np.float32)
            self._version.value += 1   # odd: write in progress
            view[:] = flat_params
            self._version.value += 1   # even: consistent
        self._last_broadcast_step = int(learner_step)
        self._version_steps[self._version.value] = self._last_broadcast_step
        while len(self._version_steps) > 64:
            self._version_steps.pop(next(iter(self._version_steps)))

    def _note_version(self, worker_id: int, version: int) -> None:
        """Rows arrived from this worker, made with the params of
        `version`: its staleness, the zero-rows detector's clock and the
        probe's sustained-progress clock."""
        acted_at = self._version_steps.get(version, 0)
        self._staleness[worker_id] = self._last_broadcast_step - acted_at
        self._last_rows_t[worker_id] = time.time()
        self._rows_seen_t[worker_id] = self._last_rows_t[worker_id]

    def staleness(self) -> Dict[str, float]:
        """Learner-step staleness of the params behind each worker's most
        recently drained rows: 0 = acting on the latest broadcast."""
        s = self._staleness[: self.num_actors]
        return {
            "staleness_mean": float(s.mean()) if len(s) else 0.0,
            "staleness_max": int(s.max()) if len(s) else 0,
        }

    # --- experience (workers -> replay) ---

    def _rows_to_batch(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        o, a = self.spec.obs_dim, self.spec.act_dim
        return {
            "obs": rows[:, :o],
            "action": rows[:, o:o + a],
            "reward": rows[:, o + a],
            "discount": rows[:, o + a + 1],
            "next_obs": rows[:, o + a + 2:2 * o + a + 2],
        }

    def _pop_ring_batches(self, max_rows: Optional[int]) -> List[tuple]:
        out = []
        remaining = (self.config.shm_ring_rows * self.num_actors if max_rows is None
                     else int(max_rows))
        for wid, ring in enumerate(self._rings):
            if remaining <= 0:
                break
            # Ask for no more than the ring holds: pop allocates the request.
            avail = len(ring)
            if not avail:
                continue
            rows = ring.pop(min(remaining, avail))
            if rows.shape[0]:
                # Rows are in production order: the last carries the
                # freshest version.
                self._note_version(wid, decode_version(rows[-1, -1]))
                out.append((wid, self._rows_to_batch(rows)))
                self._steps_received += rows.shape[0]
                remaining -= rows.shape[0]
        return out

    def drain_batches(self, max_rows: Optional[int] = None,
                      with_sources: bool = False) -> List:
        """Pop pending transition batches (field dicts) without blocking,
        at most `max_rows` transitions (the ingest rate limiter's budget;
        on the queue the last batch may overshoot it); the episodes that
        came with them go to episode_stats(). With `with_sources`, (worker
        id, batch) pairs, so the guardrails can trace a non-finite replay
        row to the slot that produced it."""
        if self.transport == "shm":
            out = self._pop_ring_batches(max_rows)
        else:
            out = []
        moved = 0
        for q in self._queues:
            while q is not None:
                if self.transport == "queue" and max_rows is not None and moved >= max_rows:
                    break
                try:
                    wid, batch, episodes, version = q.get_nowait()
                except queue_mod.Empty:
                    break
                if batch is not None:
                    out.append((wid, batch))
                    self._note_version(wid, version)
                    moved += len(batch["reward"])
                self._episodes.extend((wid, r, n) for r, n in episodes)
        self._steps_received += moved
        return out if with_sources else [batch for _, batch in out]

    def episode_stats(self) -> List[tuple]:
        """(worker_id, return, length) of the episodes drained so far."""
        out, self._episodes = self._episodes, []
        return out

    # --- failure detection and the breaker ---

    def monitor(self) -> Dict[str, int]:
        """Supervise the workers; call periodically. A worker that died or
        went silent is respawned after its slot's backoff; a slot that
        failed quarantine_respawns times within quarantine_window_s is
        quarantined instead, and probed after quarantine_probe_s."""
        self._monitor_fault.tick()
        cfg = self.config
        now = time.time()
        respawned = 0
        for i, p in enumerate(self._procs):
            if self._quarantined[i]:
                # The probe: after the cooldown, one respawn. The slot leaves
                # quarantine provisionally, under the usual checks; a failure
                # during the probe sends it straight back.
                if (cfg.quarantine_probe_s > 0
                        and now - self._quarantined_at[i] >= cfg.quarantine_probe_s):
                    self._quarantined[i] = False
                    self._probing[i] = True
                    self._probe_t[i] = now
                    self._fail_times[i] = []
                    self._respawns += 1
                    respawned += 1
                    trace.instant("actor_probe", worker=i)
                    print(f"[pool] probing quarantined worker {i} after "
                          f"{cfg.quarantine_probe_s:.0f}s cooldown (single respawn attempt)",
                          file=sys.stderr, flush=True)
                    self._spawn(i)
                continue
            if self._probing[i] and not self._pending_respawn[i]:
                # The probe succeeds on sustained progress: rows since its
                # spawn and a whole quarantine_window_s survived.
                if (self._rows_seen_t[i] > self._probe_t[i]
                        and now - self._probe_t[i] >= cfg.quarantine_window_s):
                    self._probing[i] = False
                    self._unquarantines += 1
                    trace.instant("actor_unquarantined", worker=i)
                    print(f"[pool] worker {i} UN-QUARANTINED: sustained progress for "
                          f"{cfg.quarantine_window_s:.0f}s after probe — fleet back to "
                          f"{self.num_actors - self.quarantined_count} workers",
                          file=sys.stderr, flush=True)
            if not self._pending_respawn[i]:
                why = self._detect_failure(i, p, now)
                if why is None:
                    continue
                if p is not None and p.is_alive():
                    p.terminate()
                    p.join(timeout=_TERMINATE_JOIN_S)
                self._procs[i] = None
                if self._probing[i]:
                    self._probing[i] = False
                    self._quarantined[i] = True
                    self._quarantined_at[i] = now
                    trace.instant("actor_probe_failed", worker=i, why=why)
                    print(f"[pool] probe of worker {i} failed ({why}); re-quarantined",
                          file=sys.stderr, flush=True)
                    continue
                window = [t for t in self._fail_times[i] if now - t <= cfg.quarantine_window_s]
                window.append(now)
                self._fail_times[i] = window
                if cfg.quarantine_respawns > 0 and len(window) >= cfg.quarantine_respawns:
                    self._quarantined[i] = True
                    self._quarantined_at[i] = now
                    trace.instant("actor_quarantined", worker=i, why=why,
                                  failures=len(window))
                    print(f"[pool] QUARANTINED worker {i}: {len(window)} failures (last: "
                          f"{why}) within {cfg.quarantine_window_s:.0f}s — respawns "
                          "suspended, training continues degraded on "
                          f"{self.num_actors - self.quarantined_count} workers"
                          + (f"; probe in {cfg.quarantine_probe_s:.0f}s"
                             if cfg.quarantine_probe_s > 0 else ""),
                          file=sys.stderr, flush=True)
                    continue
                backoff = min(cfg.respawn_backoff_s * (2.0 ** (len(window) - 1)),
                              cfg.respawn_backoff_max_s)
                self._backoff_until[i] = now + backoff
                self._pending_respawn[i] = True
                trace.instant("actor_respawn", worker=i, why=why,
                              backoff_s=round(backoff, 3))
                print(f"[pool] worker {i} failed ({why}); respawn in {backoff:.2f}s",
                      file=sys.stderr, flush=True)
            if self._pending_respawn[i] and now >= self._backoff_until[i]:
                self._pending_respawn[i] = False
                self._respawns += 1
                respawned += 1
                self._spawn(i)
        return {"respawned": respawned, "total_respawns": self._respawns,
                "quarantined": self.quarantined_count}

    def _detect_failure(self, i: int, p, now: float) -> Optional[str]:
        """One slot's health check: 'dead', 'silent', 'no_rows' or None. A
        heartbeat of 0 means the worker is still booting: only a death
        counts then."""
        if p is None or not p.is_alive():
            return "dead"
        hb = self._heartbeat[i]
        if hb <= 0.0:
            return None
        if now - hb > self.heartbeat_timeout:
            return "silent"
        no_progress_s = self.config.actor_no_progress_s
        if no_progress_s > 0.0:
            if self._last_rows_t[i] == 0.0:
                # The first heartbeat with no rows yet: the clock starts
                # here, not at the spawn.
                self._last_rows_t[i] = now
            elif now - self._last_rows_t[i] > no_progress_s:
                return "no_rows"
        return None

    def quarantine_source(self, worker_id: int, why: str = "numeric") -> bool:
        """Quarantine one slot directly, the guardrails' bad-row path
        (train.py): a worker that keeps feeding non-finite rows poisons the
        replay though its process looks healthy, so it takes the breaker's
        quarantine (training goes on degraded; the probe may bring it
        back). Returns False when the slot is out of range or already
        quarantined."""
        i = int(worker_id)
        if not 0 <= i < self.num_actors or self._quarantined[i]:
            return False
        p = self._procs[i]
        if p is not None and p.is_alive():
            p.terminate()
            p.join(timeout=_TERMINATE_JOIN_S)
        self._procs[i] = None
        self._probing[i] = False
        self._pending_respawn[i] = False
        self._fail_times[i] = []
        self._quarantined[i] = True
        self._quarantined_at[i] = time.time()
        trace.instant("actor_quarantined", worker=i, why=why)
        print(f"[pool] QUARANTINED worker {i} ({why}): repeatedly produced non-finite "
              "experience rows — respawns suspended, training continues degraded on "
              f"{self.num_actors - self.quarantined_count} workers"
              + (f"; probe in {self.config.quarantine_probe_s:.0f}s"
                 if self.config.quarantine_probe_s > 0 else ""),
              file=sys.stderr, flush=True)
        return True

    @property
    def quarantined_count(self) -> int:
        return sum(self._quarantined)

    def recovery_counters(self) -> Dict[str, int]:
        """The cumulative fault-history counters of the records."""
        return {
            "actor_respawns": self._respawns,
            "actor_quarantined": self.quarantined_count,
            "actor_unquarantined": self._unquarantines,
        }

    @property
    def steps_received(self) -> int:
        return self._steps_received
