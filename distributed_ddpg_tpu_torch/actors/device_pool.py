"""Device actors: E vectorized envs rolled out on the card, straight into the replay.

Counterpart of distributed_ddpg_tpu/actors/device_pool.py
(config.actor_backend='device'). The host pool (actors/pool.py) steps CPU
envs in worker processes and ships their rows through the ingest
pipeline; this pool takes the host off the experience path:

- a rollout is K steps of ops/exploration.vector_env_step over E envs of
  envs/vector_envs.py (the policy, the per-env OU noise or SAC's sample,
  the physics with auto-reset, the packed rows), enqueued on the
  learner's stream; its [K*E, D] rows, step-major (the order K serial
  E-row inserts would give), go into the device replay as one scatter
  (replay/device.py insert_device_rows): no staging, no transfer item, no
  host copy;
- the params are READ AT EACH DISPATCH from the learner (`bind`): the
  port's learner replaces its state tensors every chunk
  (parallel/learner.py, `self.state = new_state`), and torch has no
  donation error to catch a stale reference, so a pool that kept the old
  tree would roll out the old policy without a word where JAX raises. The
  rollout is enqueued on the same stream after the chunk, so it reads the
  chunk's updated params;
- the uniform warmup reads the pool's own step counter (net of the
  resumed run's `warmup_offset`), a host mirror of the device count (E a
  step), so gating needs no device read;
- a dispatch that fails restarts from the carry and generator state it
  began with (the carry tensors are never written in place, so the old
  carry is intact even where the new one was installed before the insert
  failed), at most 3 times (devactor_restarts); past that a
  DeviceActorError carries the cause. `fault` (the plan's
  `devactor:rollout` site, --faults='devactor:rollout:crash@K') is ticked
  once a dispatch, before it, so an injected crash leaves it retryable;
  a dispatch is a `devactor_rollout` span, a restart a `devactor_restart`
  instant (trace.py).

The carry (ActorCarry) is the env state, the observations, the OU state,
the running episode returns and the cumulative step, episode and return
counters, all on the device; the random numbers come from one
torch.Generator on the device (ops/exploration.py documents the order of
the draws), whose state the checkpoint sidecar carries too
(carry_state_dict / load_carry_state; a snapshot of another E or env
falls back to fresh episodes, as in JAX). `rollout` is the pure body the
fused beat composes (parallel/megastep.py). Everything runs on one rank
(ROADMAP item 10, its data-plane half).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.config import DDPGConfig, resolve_device_actor_chunk
from distributed_ddpg_tpu_torch.envs.vector_envs import make_vector_env
from distributed_ddpg_tpu_torch.metrics import DevActorStats
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws, draw_step, vector_env_step

__all__ = ["ActorCarry", "DeviceActorError", "DeviceActorPool", "resolve_device_actor_chunk"]


class DeviceActorError(RuntimeError):
    """The rollout failed past its bounded-restart budget; the original
    exception rides along as __cause__."""


class ActorCarry(NamedTuple):
    """What the rollout owns between dispatches. `host_steps` is the host
    mirror of `steps` (E a step, known without a read): the warmup gate's
    input."""

    env_state: object         # the env state, a NamedTuple of [E] tensors
    obs: torch.Tensor         # f32 [E, obs_dim] the policy's observations
    ou: torch.Tensor          # f32 [E, act_dim] OU noise state
    ep_ret: torch.Tensor      # f32 [E] running episode returns
    steps: torch.Tensor       # int64 0-d cumulative env steps
    episodes: torch.Tensor    # int64 0-d cumulative finished episodes
    ret_sum: torch.Tensor     # f32 0-d cumulative return of finished episodes
    host_steps: int


class DeviceActorPool:
    """E vectorized envs + the policy + OU noise, K steps a dispatch, feeding
    the device replay on the card (see the module)."""

    def __init__(self, config: DDPGConfig, device=None, fault=None, warmup_offset: int = 0):
        self.config = config
        self.device = torch.device(device if device is not None else config.device)
        self.num_envs = E = int(config.device_actor_envs)
        self.chunk_size = K = resolve_device_actor_chunk(config)
        self.rows_per_chunk = K * E
        self.env = make_vector_env(config.env_id, E, self.device)
        self.obs_dim, self.act_dim = self.env.obs_dim, self.env.act_dim
        scale = ((self.env.action_high - self.env.action_low) / 2.0).astype(np.float32)
        offset = ((self.env.action_high + self.env.action_low) / 2.0).astype(np.float32)
        self.action_scale, self.action_offset = scale, offset
        # On the device once: a host->device copy a step would wait for the card.
        on = dict(dtype=torch.float32, device=self.device)
        self._scale, self._offset = torch.tensor(scale, **on), torch.tensor(offset, **on)
        self._low = torch.tensor(self.env.action_low, **on)
        self._high = torch.tensor(self.env.action_high, **on)
        # The REMAINING uniform-warmup budget: a resumed run's env steps
        # count against it, so it never acts at random again.
        self._warmup_uniform = max(0, config.resolved_warmup_uniform() - int(warmup_offset))
        self._fault = fault
        self._stats = DevActorStats(seed=config.seed)
        self._params_fn: Optional[Callable] = None
        self._restarts = 0
        self._max_restarts = 3
        self._steps = 0
        self._eps_seen = 0
        self._ret_seen = 0.0
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed + 0xDA)
        self._carry = self.fresh_carry()

    def fresh_carry(self) -> ActorCarry:
        """E fresh episodes (their reset values the generator's first draw)."""
        env_state = self.env.init(self.env.draw_reset(self._gen))
        zero = dict(device=self.device)
        return ActorCarry(
            env_state=env_state, obs=self.env.observe(env_state),
            ou=torch.zeros((self.num_envs, self.act_dim), dtype=torch.float32, **zero),
            ep_ret=torch.zeros(self.num_envs, dtype=torch.float32, **zero),
            steps=torch.zeros((), dtype=torch.int64, **zero),
            episodes=torch.zeros((), dtype=torch.int64, **zero),
            ret_sum=torch.zeros((), dtype=torch.float32, **zero),
            host_steps=0)

    # --- the params ---

    def bind(self, params_fn: Callable) -> None:
        """Read the actor params from `params_fn()` at every dispatch (the
        trainer passes `lambda: learner.state.actor_params`)."""
        self._params_fn = params_fn

    def set_params(self, actor_params) -> None:
        """Roll out this fixed params tree (tests; the trainer binds)."""
        self._params_fn = lambda: actor_params

    # --- the rollout ---

    @property
    def carry(self) -> ActorCarry:
        return self._carry

    def rollout(self, params, carry: ActorCarry, draws: Optional[List[StepDraws]] = None):
        """K steps from `carry` with `params`: returns (new carry, rows
        [K*E, D] step-major). `draws` (K StepDraws) replaces the
        generator's numbers. Enqueues device work only: no host read."""
        E, warm = self.num_envs, self._warmup_uniform
        env_state, obs, ou, ep_ret = carry.env_state, carry.obs, carry.ou, carry.ep_ret
        episodes, ret_sum = carry.episodes, carry.ret_sum
        rows = []
        for k in range(self.chunk_size):
            d = draws[k] if draws is not None else draw_step(
                self.env, self.act_dim, self._gen, self._low, self._high, warm > 0)
            ou, _, out, r = vector_env_step(
                self.config, self.env, params, env_state, obs, ou, self._scale, self._offset,
                self._low, self._high, d, warmup_active=carry.host_steps + k * E < warm)
            with torch.no_grad():
                ep_ret = ep_ret + out.reward
                episodes = episodes + out.done.sum()
                ret_sum = ret_sum + torch.where(out.done, ep_ret, 0.0).sum()
                ep_ret = torch.where(out.done, 0.0, ep_ret)
            env_state, obs = out.state, out.obs
            rows.append(r)
        n = self.rows_per_chunk
        new = ActorCarry(env_state=env_state, obs=obs, ou=ou, ep_ret=ep_ret,
                         steps=carry.steps + n, episodes=episodes, ret_sum=ret_sum,
                         host_steps=carry.host_steps + n)
        return new, torch.cat(rows)

    def advance(self, draws: Optional[List[StepDraws]] = None) -> torch.Tensor:
        """One rollout from the pool's carry with the bound params, the new
        carry installed; returns its rows (the fused beat inserts them)."""
        self._check_bound()
        self._carry, rows = self.rollout(self._params_fn(), self._carry, draws)
        return rows

    def _check_bound(self) -> None:
        if self._params_fn is None:
            raise DeviceActorError("bind() (or set_params()) must give the pool the "
                                   "learner's actor params before the first rollout")

    def run_chunk(self, replay, draws: Optional[List[StepDraws]] = None) -> int:
        """One rollout dispatch into `replay` (insert_device_rows). Returns
        the rows it landed. A failure restarts from the dispatch's carry
        and draws, at most 3 times (see the module)."""
        self._check_bound()
        while True:
            carry, gen_state = self._carry, self._gen.get_state()
            try:
                if self._fault is not None:
                    self._fault.tick()
                t0 = time.perf_counter()
                with trace.span("devactor_rollout", rows=self.rows_per_chunk,
                                envs=self.num_envs):
                    rows = self.advance(draws)
                    replay.insert_device_rows(rows)
                dt = time.perf_counter() - t0
            except Exception as e:   # not BaseException: Ctrl-C aborts
                if not self._recoverable(e):
                    raise DeviceActorError("device-actor rollout failed past the restart "
                                           "budget") from e
                # Back to the dispatch's start (advance may have installed
                # the new carry before the insert failed): the same carry
                # and the same draws give the same rows.
                self._carry = carry
                self._gen.set_state(gen_state)
                continue
            self.absorb_fused_chunk(dt)
            return self.rows_per_chunk

    def _recoverable(self, exc: Exception) -> bool:
        if self._restarts >= self._max_restarts:
            return False
        self._restarts += 1
        trace.instant("devactor_restart", n=self._restarts)
        print(f"[devactor] rollout dispatch failed ({exc!r}); restarting "
              f"({self._restarts}/{self._max_restarts})", file=sys.stderr, flush=True)
        return True

    def absorb_fused_chunk(self, dur_s: float, beats: int = 1) -> None:
        """Account `beats` rollouts dispatched in `dur_s` (run_chunk's one,
        or the rollouts a fused beat or superstep ran; their carries are
        already installed by advance)."""
        self._stats.record_chunk(self.rows_per_chunk * beats, dur_s)
        self._steps += self.rows_per_chunk * beats

    # --- the checkpoint sidecar ---

    def _leaves(self, carry: ActorCarry) -> list:
        return [*carry.env_state, carry.obs, carry.ou, carry.ep_ret, carry.steps,
                carry.episodes, carry.ret_sum]

    def carry_state_dict(self) -> dict:
        """The carry as flat host arrays keyed by position (leaf_0..), the
        generator's state last: the devactor_carry.npz sidecar. One read,
        at checkpoint cadence."""
        leaves = [t.cpu().numpy() for t in self._leaves(self._carry)]
        leaves.append(self._gen.get_state().numpy())
        return {f"leaf_{i}": a for i, a in enumerate(leaves)}

    def load_carry_state(self, state: dict) -> bool:
        """Restore a carry_state_dict snapshot (each leaf's shape and dtype
        checked). False, with a note, where it does not match this pool's
        carry (another env, E or family): episodes then start fresh."""
        refs = [t.cpu().numpy() for t in self._leaves(self._carry)]
        refs.append(self._gen.get_state().numpy())
        for i, ref in enumerate(refs):
            arr = state.get(f"leaf_{i}")
            if arr is None or arr.shape != ref.shape or arr.dtype != ref.dtype:
                print(f"[devactor] checkpointed rollout state does not match this config's "
                      f"carry (leaf {i}: {None if arr is None else (arr.shape, str(arr.dtype))}"
                      f" vs {(ref.shape, str(ref.dtype))}); starting fresh episodes",
                      file=sys.stderr, flush=True)
                return False
        if len(state) > len(refs):
            print("[devactor] checkpointed rollout state has extra leaves; starting fresh "
                  "episodes", file=sys.stderr, flush=True)
            return False
        t = [torch.as_tensor(state[f"leaf_{i}"], device=self.device)
             for i in range(len(refs) - 1)]
        n_env = len(self._carry.env_state)
        env_state = type(self._carry.env_state)(*t[:n_env])
        obs, ou, ep_ret, steps, episodes, ret_sum = t[n_env:]
        self._carry = ActorCarry(env_state=env_state, obs=obs, ou=ou, ep_ret=ep_ret,
                                 steps=steps, episodes=episodes, ret_sum=ret_sum,
                                 host_steps=int(state[f"leaf_{n_env + 3}"]))
        self._gen.set_state(torch.as_tensor(state[f"leaf_{len(refs) - 1}"]))
        self._eps_seen = int(state[f"leaf_{n_env + 4}"])
        self._ret_seen = float(state[f"leaf_{n_env + 5}"])
        # steps_done stays 0: the restored production is the resumed run's
        # env-step offset already. The carry's own count keeps its value,
        # which keeps the warmup gate closed.
        trace.instant("devactor_carry_restored", steps=self._carry.host_steps,
                      episodes=self._eps_seen)
        print(f"[devactor] rollout state restored: {self._carry.host_steps} env steps, "
              f"{self._eps_seen} episodes", file=sys.stderr, flush=True)
        return True

    # --- host views ---

    @property
    def steps_done(self) -> int:
        """Env steps this pool produced (dispatches x K x E; host count)."""
        return self._steps

    @property
    def restarts(self) -> int:
        return self._restarts

    def snapshot(self) -> dict:
        """The devactor_* fields: DevActorStats' interval fields, then the
        episode counters read from the carry (two scalars, at log cadence)."""
        out = self._stats.snapshot()
        eps = int(self._carry.episodes)
        ret = float(self._carry.ret_sum)
        d_eps, d_ret = eps - self._eps_seen, ret - self._ret_seen
        self._eps_seen, self._ret_seen = eps, ret
        out["devactor_env_steps"] = self._steps
        out["devactor_episodes"] = eps
        if d_eps > 0:
            out["devactor_episode_return"] = round(d_ret / d_eps, 6)
        out["devactor_restarts"] = self._restarts
        return out
