"""ActorPool: N rollout worker processes feeding one learner.

A trimmed copy of distributed_ddpg_tpu/actors/pool.py: queue transport,
seqlock param broadcast, heartbeat monitor with respawn. The shm ring,
served acting, fault injection, tracing and the quarantine breaker are not
in the port yet.

- Param broadcast: one flat f32 shared-memory array + a version counter.
  Workers poll the version each env step and copy on change.
- Transitions: each worker pushes batched n-step transitions, with the
  episodes it finished, over its OWN bounded mp.Queue; `drain_batches`
  pops them for the device-replay ingest.
- Failure detection: workers stamp heartbeats; `monitor()` respawns a
  worker that died or went silent past the heartbeat timeout.
- What a dead worker can leave behind: a process killed outright dies
  holding whatever cross-process lock it held. So every spawn gets a
  fresh queue (an abandoned one may hold a half-written message and its
  write lock; the rows in it are lost, as the in-flight episode is), and
  the version counter, stop flag and heartbeats are lock-free shared
  values (the seqlock needs no mutex: one writer, and readers re-check).

Uses the 'spawn' start method: workers start from a fresh interpreter and
never inherit the parent's CUDA state.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
from typing import Dict, List, Optional

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import actor_head_dim, layout_size, param_layout
from distributed_ddpg_tpu_torch.actors.worker import run_worker
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec

# Reap bound for a worker we just terminate()d.
_TERMINATE_JOIN_S = 2.0
# Transition batches a worker may have in flight before it blocks.
_QUEUE_BATCHES = 4


class ActorPool:
    def __init__(self, config: DDPGConfig, spec: EnvSpec, num_actors: Optional[int] = None):
        self.config = config
        self.spec = spec
        self.num_actors = num_actors or config.num_actors
        self.heartbeat_timeout = config.heartbeat_timeout_s
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

    # --- lifecycle ---

    def warmup_budget_per_worker(self) -> int:
        """The uniform-warmup budget left at spawn time
        (config.resolved_warmup_uniform less the env steps already drained,
        so a respawned worker does not put random actions into a trained
        run's replay), split evenly (ceil) across the pool."""
        remaining = max(0, self.config.resolved_warmup_uniform() - self._steps_received)
        return (remaining + self.num_actors - 1) // self.num_actors

    def _spawn(self, worker_id: int) -> None:
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
            ),
            daemon=True,
            name=f"actor-{worker_id}",
        )
        p.start()
        # 0.0 = still booting: the silent-timeout respawn arms only once
        # the worker's loop stamps its first heartbeat.
        self._heartbeat[worker_id] = 0.0
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

    # --- param broadcast (learner -> workers) ---

    def broadcast(self, flat_params: np.ndarray) -> None:
        """Seqlock write: version goes ODD while the flat array is being
        written, EVEN when it is consistent. Workers copy only at even
        versions and re-check after the copy, so a torn parameter vector
        is never acted on. `flat_params` is in policy.flatten_params
        layout (the learner's actor_params_to_host)."""
        view = np.frombuffer(self._shared, dtype=np.float32)
        self._version.value += 1   # odd: write in progress
        view[:] = flat_params
        self._version.value += 1   # even: consistent

    # --- experience (workers -> replay) ---

    def drain_batches(self) -> List[Dict[str, np.ndarray]]:
        """Pop every pending transition batch (field dicts) without
        blocking; the episodes that rode along go to episode_stats()."""
        out = []
        for q in self._queues:
            while q is not None:
                try:
                    wid, batch, episodes = q.get_nowait()
                except queue_mod.Empty:
                    break
                out.append(batch)
                self._steps_received += len(batch["reward"])
                self._episodes.extend((wid, r, n) for r, n in episodes)
        return out

    def episode_stats(self) -> List[tuple]:
        """(worker_id, return, length) of the episodes drained so far."""
        out, self._episodes = self._episodes, []
        return out

    # --- failure detection ---

    def monitor(self) -> Dict[str, int]:
        """Respawn workers that died or went silent. Call periodically."""
        now = time.time()
        respawned = 0
        for i, p in enumerate(self._procs):
            hb = self._heartbeat[i]
            dead = p is None or not p.is_alive()
            silent = hb > 0.0 and now - hb > self.heartbeat_timeout
            if not (dead or silent):
                continue
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=_TERMINATE_JOIN_S)
            self._respawns += 1
            respawned += 1
            self._spawn(i)
        return {"respawned": respawned, "total_respawns": self._respawns}

    @property
    def steps_received(self) -> int:
        return self._steps_received
