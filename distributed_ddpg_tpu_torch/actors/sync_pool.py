"""The --strict_sync lockstep actor pool: inline actors on the driver's thread.

Counterpart of distributed_ddpg_tpu/actors/sync_pool.py. The production
ActorPool runs its workers as processes: the order rows arrive in, when a
refresh lands and how drains interleave all follow the OS's scheduling,
so two runs of one config differ bit for bit, and an async race cannot be
replayed. SyncActorPool runs the same worker semantics (NumpyPolicy with
OU noise or SAC's sampling, the uniform warmup, the n-step accumulator,
the truncation flush: actors/worker.py run_worker step for step) inline
on the driver's thread, the envs stepped in a fixed round-robin order.
Every drain steps the envs exactly as many times as the caller's ingest
budget allows, so the whole ingest-to-learn schedule is a function of the
config: two runs give bit-identical records (train.py, strict_sync), and
a run that differs from an async one points at the async machinery.

It has the ActorPool surface the port's driver calls (start, stop,
broadcast with the flat params, staleness, drain_batches, drain_into,
steps_received, episode_stats, monitor, recovery_counters,
quarantine_source, transport). The config requires both ratio gates with
strict_sync, which pins learner and ingest to the configured ratio: at
1.0 each, the reference's synchronous 1:1 schedule.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, actor_head_dim, param_layout
from distributed_ddpg_tpu_torch.actors.worker import _flush_truncated
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
from distributed_ddpg_tpu_torch.ops.noise import OUNoise
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator


class _InlineActor:
    """One env's worker state, the per-process state of actors/worker.py
    run_worker, held inline."""

    def __init__(self, config: DDPGConfig, spec: EnvSpec, seed: int):
        self.spec = spec
        self.env = make(config.env_id, seed=seed)
        self.noise = OUNoise(
            (spec.act_dim,),
            theta=config.ou_theta,
            sigma=0.0 if config.sac else config.ou_sigma,
            dt=config.ou_dt,
            seed=seed,
        )
        self.nstep = NStepAccumulator(config.n_step, config.gamma)
        self.warmup_rng = np.random.default_rng(seed + 7919)
        self.obs, _ = self.env.reset(seed=seed)
        self.ep_return = 0.0
        self.ep_len = 0

    def step(self, policy: NumpyPolicy, uniform: bool) -> tuple:
        """One env step; returns (n-step rows, the finished episode or None)."""
        spec = self.spec
        if uniform:
            action = self.warmup_rng.uniform(spec.action_low, spec.action_high).astype(np.float32)
        else:
            action = policy(self.obs)[0] + self.noise() * np.asarray(spec.action_scale,
                                                                      np.float32)
        action = np.clip(action, spec.action_low, spec.action_high).astype(np.float32)
        next_obs, reward, terminated, truncated, _ = self.env.step(action)
        rows = list(self.nstep.push(self.obs[None], action[None], [reward], [terminated],
                                    next_obs[None]))
        self.ep_return += reward
        self.ep_len += 1
        self.obs = next_obs
        episode = None
        if terminated or truncated:
            if truncated and not terminated:
                rows.extend(_flush_truncated(self.nstep, next_obs))
            episode = (self.ep_return, self.ep_len)
            self.obs, _ = self.env.reset()
            self.noise.reset()
            self.nstep.reset()
            self.ep_return, self.ep_len = 0.0, 0
        return rows, episode


class SyncActorPool:
    """ActorPool's drop-in with deterministic inline stepping."""

    transport = "inline"

    def __init__(self, config: DDPGConfig, spec: EnvSpec, num_actors: Optional[int] = None,
                 env_steps_offset: int = 0):
        self.config = config
        self.spec = spec
        self.num_actors = num_actors or config.num_actors
        self.layout = param_layout(spec.obs_dim, actor_head_dim(spec.act_dim, config.sac),
                                   tuple(config.actor_hidden))
        self._policy = NumpyPolicy(
            self.layout, spec.action_scale, spec.action_offset, gaussian=config.sac,
            stochastic=config.sac, seed=config.seed + 1,
            log_std_min=config.sac_log_std_min, log_std_max=config.sac_log_std_max,
        )
        self._actors: List[_InlineActor] = []
        self._episodes: List[tuple] = []
        self._steps_received = 0
        self._env_steps_taken = 0
        self._next = 0   # the round-robin cursor
        # Env steps of the checkpoint a run resumed from: they count
        # against the uniform warmup, as ActorPool's do.
        self.env_steps_offset = int(env_steps_offset)

    # --- lifecycle ---

    def start(self, flat_params: np.ndarray) -> "SyncActorPool":
        self._policy.load_flat(flat_params)
        # ActorPool's seed spacing: a distinct stream an actor.
        self._actors = [_InlineActor(self.config, self.spec, self.config.seed + 101 * i)
                        for i in range(self.num_actors)]
        return self

    def stop(self) -> None:
        for a in self._actors:
            close = getattr(a.env, "close", None)
            if close is not None:
                close()
        self._actors = []

    def broadcast(self, flat_params: np.ndarray, learner_step: int = 0) -> None:
        """The learner's actor params in policy.flatten_params layout."""
        self._policy.load_flat(flat_params)

    def staleness(self) -> Dict[str, float]:
        # Lockstep: every row is produced under the latest broadcast.
        return {"staleness_mean": 0.0, "staleness_max": 0}

    # --- experience ---

    def _produce(self, n_steps: int) -> List[Dict[str, np.ndarray]]:
        """Step the envs round-robin exactly n_steps times; returns their
        n-step rows as one batch (none while the accumulators fill)."""
        warmup_total = self.config.resolved_warmup_uniform()
        fields: Dict[str, list] = {"obs": [], "action": [], "reward": [], "discount": [],
                                   "next_obs": []}
        for _ in range(n_steps):
            idx = self._next
            actor = self._actors[idx]
            self._next = (idx + 1) % self.num_actors
            uniform = self.env_steps_offset + self._env_steps_taken < warmup_total
            rows, episode = actor.step(self._policy, uniform)
            self._env_steps_taken += 1
            if episode is not None:
                # ActorPool's tuple: (actor_id, episode_return, episode_length).
                self._episodes.append((idx,) + episode)
            for o, a, r, disc, nobs in rows:
                fields["obs"].append(o)
                fields["action"].append(a)
                fields["reward"].append(np.float32(r))
                fields["discount"].append(np.float32(disc))
                fields["next_obs"].append(nobs)
        if not fields["obs"]:
            return []
        batch = {
            "obs": np.stack(fields["obs"]),
            "action": np.stack(fields["action"]),
            "reward": np.asarray(fields["reward"], np.float32),
            "discount": np.asarray(fields["discount"], np.float32),
            "next_obs": np.stack(fields["next_obs"]),
        }
        self._steps_received += len(batch["reward"])
        return [batch]

    def drain_batches(self, max_rows: Optional[int] = None,
                      with_sources: bool = False) -> List:
        """Step the envs `max_rows` times (the driver's ingest budget; the
        config arms it under strict_sync) and return their rows; nothing
        without a budget. With `with_sources`, (-1, batch) pairs: inline
        actors interleave into one batch, so no row has a source to trace
        (the guardrails skip -1)."""
        if max_rows is None or max_rows <= 0:
            return []
        batches = self._produce(int(max_rows))
        return [(-1, b) for b in batches] if with_sources else batches

    def drain_into(self, replay, max_rows: Optional[int] = None) -> int:
        """drain_batches into a host replay's add_batch; returns the rows."""
        moved = 0
        for batch in self.drain_batches(max_rows):
            replay.add_batch(batch["obs"], batch["action"], batch["reward"],
                             batch["discount"], batch["next_obs"])
            moved += len(batch["reward"])
        return moved

    # --- bookkeeping ---

    @property
    def steps_received(self) -> int:
        # ROWS delivered, as ActorPool counts them: the ingest budget and
        # total_env_steps count received rows. The env clock
        # (_env_steps_taken) runs a little ahead (the n-step accumulators'
        # held-back rows) and gates only the uniform warmup.
        return self._steps_received

    def episode_stats(self) -> List[tuple]:
        out, self._episodes = self._episodes, []
        return out

    def monitor(self) -> Dict[str, int]:
        return {"respawned": 0, "total_respawns": 0, "quarantined": 0}

    def recovery_counters(self) -> Dict[str, int]:
        # Inline actors cannot fail apart from the driver; the counters keep
        # the records' schema.
        return {"actor_respawns": 0, "actor_quarantined": 0, "actor_unquarantined": 0}

    def quarantine_source(self, worker_id: int, why: str = "numeric") -> bool:
        # Nothing to quarantine: the actors share the driver's process.
        return False
