"""The single-process agent: act, observe, train_step behind one object.

Counterpart of distributed_ddpg_tpu/agent.py. DDPGAgent ties the networks,
the host replay (replay/__init__.make_replay: uniform or, with
prioritized=True, the sum-tree PER), the OU noise and the n-step
accumulator to the port's eager learner step (learner.make_learner_step;
with fused_update=True each step's two Adam + Polyak updates run the fused
update kernel, ops/fused_update.py, on the card). It is the JAX package's
ladder rung 1: the distributed trainer (train.py) composes the same
pieces across processes.

- `act(obs, explore)`: the uniform warmup (config.resolved_warmup_uniform,
  from its own numpy generator), then SAC's sample of its policy
  (learner.make_sample_fn, from a torch.Generator seeded seed + 2) or the
  deterministic policy plus OU noise, clipped to the action box.
- `observe(obs, action, reward, done, next_obs)`: n-step rows into the
  replay (done before next_obs, as in the JAX agent).
- `train_step()`: one learner step on one sampled batch once the replay
  holds max(replay_min_size, batch_size) rows; the C51 auto support sized
  from the replay at the first step and widened on the 50-step cadence
  (ops/support_auto.py); PER's priorities written from the step's td and
  beta annealed over the run's learner steps (`_expected_learn_steps`).
  TD3's smoothing noise and SAC's normals are drawn on the state's device
  from the step's own key (ops/fused_chunk.td3_noise_eps, sac_noise_eps):
  the JAX agent draws them from jax.random, so the two agents agree on
  them only when a test passes the same draw in.
- `evaluate(env, episodes, seed)`: the deterministic policy's mean return.

The state lives on config.device ("cuda" by default, which raises
without a card; "cpu" runs the plain versions, as the tests do). OU
noise, the warmup's uniform actions and the replay's draws are numpy from
the JAX agent's seeds, so they match its draws exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    StepOutput,
    init_train_state,
    make_act_fn,
    make_learner_step,
    make_sample_fn,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk, support_auto
from distributed_ddpg_tpu_torch.ops.noise import OUNoise
from distributed_ddpg_tpu_torch.parallel.learner import resolve_device
from distributed_ddpg_tpu_torch.replay import make_replay
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator
from distributed_ddpg_tpu_torch.types import Batch


class DDPGAgent:
    def __init__(self, config: DDPGConfig, spec: EnvSpec):
        self.config = config
        self.spec = spec
        self.device = resolve_device(config)
        self.state = init_train_state(config, spec.obs_dim, spec.act_dim, config.seed,
                                      self.device)
        self._step_fn = make_learner_step(config, spec.action_scale, spec.action_offset)
        self._act_fn = make_act_fn(config, spec.action_scale, spec.action_offset)
        # SAC explores by sampling its own policy; the OU noise stays unused.
        self._sample_fn = (make_sample_fn(config, spec.action_scale, spec.action_offset)
                           if config.sac else None)
        self._act_gen = (torch.Generator(device=self.device).manual_seed(config.seed + 2)
                         if config.sac else None)
        self._noise_gen = (torch.Generator(device=self.device)
                           if config.takes_noise or config.sac else None)
        # The uniform warmup (SAC's start_steps; config.warmup_uniform_steps).
        self._warmup_uniform = config.resolved_warmup_uniform()
        self._warmup_rng = np.random.default_rng(config.seed + 3)
        self._env_steps = 0
        self.replay = make_replay(config, spec.obs_dim, spec.act_dim)
        self.noise = OUNoise((spec.act_dim,), theta=config.ou_theta, sigma=config.ou_sigma,
                             dt=config.ou_dt, seed=config.seed + 1)
        self.nstep = NStepAccumulator(config.n_step, config.gamma)
        self._learn_steps = 0
        # The auto C51 support, resolved at the first train_step; the flag
        # outlives it (self.config then carries concrete bounds).
        self._support_auto_active = config.distributional and config.v_support_auto
        self._support_controller = support_auto.SupportController()

    def _set_value_bounds(self, v_min: float, v_max: float) -> None:
        self.config = self.config.replace(v_min=float(v_min), v_max=float(v_max))
        self._step_fn = make_learner_step(self.config, self.spec.action_scale,
                                          self.spec.action_offset)

    # --- acting ---

    def _obs(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32)[None], device=self.device)

    def act(self, obs: np.ndarray, explore: bool = True) -> np.ndarray:
        if explore and self._env_steps < self._warmup_uniform:
            return self._warmup_rng.uniform(self.spec.action_low,
                                            self.spec.action_high).astype(np.float32)
        if explore and self.config.sac:
            action = self._sample_fn(self.state.actor_params, self._obs(obs),
                                     self._act_gen)[0].cpu().numpy()
            return np.clip(action, self.spec.action_low, self.spec.action_high)
        action = self._act_fn(self.state.actor_params, self._obs(obs))[0].cpu().numpy()
        if explore:
            action = action + self.noise() * self.spec.action_scale
        return np.clip(action, self.spec.action_low, self.spec.action_high)

    def reset_episode(self) -> None:
        self.noise.reset()
        self.nstep.reset()

    # --- experience ---

    def observe(self, obs, action, reward, done, next_obs) -> None:
        self._env_steps += 1
        for o, a, r, disc, nobs in self.nstep.push(obs[None], action[None], [reward], [done],
                                                   next_obs[None]):
            self.replay.add(o, a, r, disc, nobs)

    # --- learning ---

    def can_train(self) -> bool:
        return len(self.replay) >= max(self.config.replay_min_size, self.config.batch_size)

    def _step_noise(self, step: int):
        """The step's TD3 smoothing noise or SAC normals ([B, act] each),
        keyed by the state's step; None for DDPG and D4PG."""
        if self._noise_gen is None:
            return None
        draw = fused_chunk.sac_noise_eps if self.config.sac else fused_chunk.td3_noise_eps
        eps = draw(self.config, self._noise_gen, step, 1, self.config.batch_size,
                   self.spec.act_dim)
        return (eps[0][0], eps[1][0]) if self.config.sac else eps[0]

    def train_step(self) -> Optional[Dict[str, float]]:
        if not self.can_train():
            return None
        if self.config.distributional and self.config.v_support_auto:
            # The auto C51 support: the replay just crossed the warmup
            # threshold; size the bounds from its rewards and rebuild the
            # step. After this the config carries concrete bounds.
            self._set_value_bounds(*support_auto.replay_data_bounds(
                self.replay, self.config.gamma, self.config.n_step))
        sample = self.replay.sample(self.config.batch_size)
        indices = sample.pop("indices")
        batch = Batch(*(torch.as_tensor(np.asarray(sample[f], np.float32), device=self.device)
                        for f in Batch._fields))
        step = int(self.state.step)
        out: StepOutput = self._step_fn(self.state, batch, self._step_noise(step),
                                        step_index=step)
        self.state = out.state
        self._learn_steps += 1
        metrics = dict(zip(METRIC_KEYS, torch.stack(
            [out.metrics[k] for k in METRIC_KEYS]).cpu().tolist()))
        support_metrics = {}
        if self._support_auto_active and self._learn_steps % 50 == 0:
            # Corroborated against the replay's current rewards: a
            # diverging mean_q must not drag the support up.
            grown = self._support_controller.check(
                self.config.v_min, self.config.v_max, metrics["mean_q"], self._learn_steps,
                data_bounds_fn=lambda: support_auto.replay_data_bounds(
                    self.replay, self.config.gamma, self.config.n_step))
            if grown is not None:
                self._set_value_bounds(*grown)
        if self._support_auto_active:
            support_metrics = dict(support_refusals=self._support_controller.refusals)
        if self.config.prioritized:
            # PER's one device-to-host copy: the step's td.
            self.replay.update_priorities(indices, out.td_errors.cpu().numpy())
            frac = min(1.0, self._learn_steps / self._expected_learn_steps())
            self.replay.set_beta(self.config.per_beta
                                 + frac * (self.config.per_beta_final - self.config.per_beta))
        return {**metrics, **support_metrics}

    def _expected_learn_steps(self) -> int:
        """The learner steps this run takes: PER's beta horizon (learner
        steps lag env steps by the warmup and by train_every)."""
        cfg = self.config
        return max(1, (cfg.total_env_steps - cfg.replay_min_size) // cfg.train_every)

    # --- evaluation ---

    def evaluate(self, env, episodes: int = 5, seed: int = 10_000) -> float:
        returns = []
        for ep in range(episodes):
            obs, _ = env.reset(seed=seed + ep)
            done, total = False, 0.0
            while not done:
                action = self.act(obs, explore=False)
                obs, r, terminated, truncated, _ = env.step(action)
                total += r
                done = terminated or truncated
            returns.append(total)
        return float(np.mean(returns))
