"""The on-device monolith: env physics, exploration, replay and learner on the card.

Counterpart of distributed_ddpg_tpu/ondevice.py (`--backend=jax_ondevice`).
For the envs of envs/vector_envs.py there is nothing to feed: E vectorized
envs (E = num_actors), the OU noise, the replay ring and the learner all
live on the device, and a chunk of K iterations runs K*E env steps and up
to K learner steps with no host<->device copy inside it. Each iteration:

1. one exploration step over the E envs (ops/exploration.vector_env_step:
   OU noise or SAC's sample, the clip, the uniform warmup while the ring
   holds fewer than warmup_uniform_steps rows, the auto-reset step, the
   packed rows with discount gamma * (1 - terminated));
2. the E rows scattered into the ring (a replay/device.DeviceReplay,
   insert_device_rows: one scatter at (ptr + arange(E)) mod capacity);
3. one learner step (learner.make_learner_step; with fused_update=True
   its Adam + Polyak is the fused update kernel, K2, on the card) on
   global_batch rows drawn uniformly from the ring, once it holds
   max(replay_min_size, batch_size) rows.

The ring's fill grows by E an iteration, so its `ptr` and `size` are host
integers: the warmup gate and the learning gate read no device value. The
ring checkpoints through the replay's own state_dict.
The random numbers come from one torch.Generator on the device: each
iteration's env draws (ops/exploration.py's order), then the learning
step's [B] index draw; TD3's smoothing noise and SAC's normals are keyed by
the step, as the learner's chunk draws them (ops/fused_chunk.td3_noise_eps,
sac_noise_eps). `run_chunk(draws=, indices=)` takes a reference's numbers.
JAX traces the K iterations into one XLA program (lax.scan); the port
enqueues them on one stream. A chunk's metrics are the means over the
iterations that learned; `finalize_stats` reads a chunk's (or a
superstep's stacked [B, ...]) stats in one copy and re-weights a
superstep's rows by their learned counts.

Refused as in JAX: PER, n_step != 1, train_every != 1, and a uniform
warmup of the whole capacity or more (the gate reads the ring's fill,
which saturates there). One rank (ROADMAP.md Queue 1 item 10, its data-plane half).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.vector_envs import make_vector_env
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    make_learner_step,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws, draw_step, vector_env_step
from distributed_ddpg_tpu_torch.parallel.learner import _to_device, resolve_device
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from distributed_ddpg_tpu_torch.types import TrainState, unpack_batch


class ChunkStats(NamedTuple):
    """A chunk's stats on the device (stacked [B, ...] for a superstep);
    `learn_steps` is a host count (a list of B for a superstep)."""

    metrics: torch.Tensor     # f32 [6] means over the iterations that learned ([B, 6])
    learn_steps: object       # int: learner steps taken (list of B ints)
    dones: torch.Tensor       # bool [K, E] episode boundaries ([B, K, E])
    ep_returns: torch.Tensor  # f32 [K, E] the episode's return where done, else 0


class OnDeviceDDPG:
    def __init__(self, config: DDPGConfig, chunk_size: int = 64, device=None):
        if config.prioritized:
            raise ValueError(
                "jax_ondevice backend supports uniform replay only (PER "
                "priorities are host state; use --backend=jax_tpu)"
            )
        if config.n_step != 1:
            raise ValueError(
                "jax_ondevice backend stores 1-step transitions (n-step "
                "windows are a host-accumulator feature; use --backend=jax_tpu)"
            )
        if config.train_every != 1:
            raise ValueError(
                "jax_ondevice backend runs one learner step per vector env "
                "step (train_every is a host-loop knob; use --backend=jax_tpu)"
            )
        if config.resolved_warmup_uniform() >= config.replay_capacity:
            raise ValueError(
                "warmup_uniform_steps must be < replay_capacity on "
                "jax_ondevice: the warmup gate reads the ring-fill counter, "
                "which saturates at capacity — a larger budget would act "
                "uniformly forever"
            )
        self.config = config
        self.device = torch.device(device) if device is not None else resolve_device(config)
        self.num_envs = E = int(config.num_actors)
        self.chunk_size = int(chunk_size)
        self.superstep_beats = int(config.superstep_beats)
        self.env = make_vector_env(config.env_id, E, self.device)
        self.obs_dim, self.act_dim = self.env.obs_dim, self.env.act_dim
        scale = ((self.env.action_high - self.env.action_low) / 2.0).astype(np.float32)
        offset = ((self.env.action_high + self.env.action_low) / 2.0).astype(np.float32)
        self.action_scale, self.action_offset = scale, offset
        on = dict(dtype=torch.float32, device=self.device)
        self._scale, self._offset = torch.tensor(scale, **on), torch.tensor(offset, **on)
        self._low = torch.tensor(self.env.action_low, **on)
        self._high = torch.tensor(self.env.action_high, **on)
        self.global_batch = int(config.batch_size)
        self.capacity = int(config.replay_capacity)
        self._min_fill = max(config.replay_min_size, config.batch_size)
        self._warmup_uniform = config.resolved_warmup_uniform()
        self._step_fn = make_learner_step(config, scale, offset)
        self._noise_gen = (torch.Generator(device=self.device)
                           if config.takes_noise or config.sac else None)
        self.state: TrainState = init_train_state(config, self.obs_dim, self.act_dim,
                                                  config.seed, self.device)
        self._step = int(self.state.step)
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self.env_state = self.env.init(self.env.draw_reset(self._gen))
        self.obs = self.env.observe(self.env_state)
        self.ou = torch.zeros((E, self.act_dim), **on)
        self.ep_ret = torch.zeros(E, **on)
        self.replay = DeviceReplay(self.capacity, self.obs_dim, self.act_dim,
                                   device=self.device)
        self._env_steps = 0
        self._learn_steps = 0

    # --- driving ---

    def _noise(self):
        if self._noise_gen is None:
            return None
        draw = fused_chunk.sac_noise_eps if self.config.sac else fused_chunk.td3_noise_eps
        eps = draw(self.config, self._noise_gen, self._step, 1, self.global_batch,
                   self.act_dim)
        return (eps[0][0], eps[1][0]) if self.config.sac else eps[0]

    def run_chunk(self, draws: Optional[List[StepDraws]] = None,
                  indices: Optional[List[torch.Tensor]] = None) -> ChunkStats:
        """K iterations: K*E env steps and up to K learner steps. `draws`
        (K StepDraws) and `indices` (one [B] index tensor for each
        iteration that learns, in order) replace the generator's numbers."""
        cfg, E = self.config, self.num_envs
        metrics, dones, rets = [], [], []
        learned = 0
        replay = self.replay
        for k in range(self.chunk_size):
            d = draws[k] if draws is not None else draw_step(
                self.env, self.act_dim, self._gen, self._low, self._high,
                self._warmup_uniform > 0)
            self.ou, _, out, rows = vector_env_step(
                cfg, self.env, self.state.actor_params, self.env_state, self.obs, self.ou,
                self._scale, self._offset, self._low, self._high, d,
                warmup_active=len(replay) < self._warmup_uniform)
            replay.insert_device_rows(rows)
            with torch.no_grad():
                ep_ret = self.ep_ret + out.reward
                rets.append(torch.where(out.done, ep_ret, 0.0))
                self.ep_ret = torch.where(out.done, 0.0, ep_ret)
            dones.append(out.done)
            self.env_state, self.obs = out.state, out.obs
            if len(replay) >= self._min_fill:
                if indices is not None:
                    idx = indices[learned].to(self.device)
                else:
                    idx = torch.randint(0, len(replay), (self.global_batch,),
                                        generator=self._gen, device=self.device)
                batch = unpack_batch(replay.storage[idx], self.obs_dim, self.act_dim)
                step = self._step_fn(self.state, batch, self._noise(), step_index=self._step)
                self.state = step.state
                self._step += 1
                learned += 1
                metrics.append(torch.stack([step.metrics[k] for k in METRIC_KEYS]))
        self._env_steps += self.chunk_size * E
        self._learn_steps += learned
        mean = (torch.stack(metrics).sum(0) / learned if learned
                else torch.zeros(len(METRIC_KEYS), device=self.device))
        return ChunkStats(metrics=mean, learn_steps=learned, dones=torch.stack(dones),
                          ep_returns=torch.stack(rets))

    def run_superstep(self) -> ChunkStats:
        """B chunks in a row (superstep_beats), their stats stacked [B, ...]
        on the device for finalize_stats' one read."""
        chunks = [self.run_chunk() for _ in range(self.superstep_beats)]
        return ChunkStats(metrics=torch.stack([c.metrics for c in chunks]),
                          learn_steps=[c.learn_steps for c in chunks],
                          dones=torch.stack([c.dones for c in chunks]),
                          ep_returns=torch.stack([c.ep_returns for c in chunks]))

    def finalize_stats(self, stats: ChunkStats) -> dict:
        """A chunk's (or a superstep's stacked) stats to host floats in one
        copy: the metrics (a superstep's rows re-weighted by the learner
        steps each took: each row is already a chunk's mean, and an
        unweighted mean would lean toward the warmup's chunks), the
        episodes that ended and their mean return."""
        n_metrics = stats.metrics.numel()
        flat = torch.cat([stats.metrics.reshape(-1).double(),
                          stats.dones.reshape(-1).double(),
                          stats.ep_returns.reshape(-1).double()]).cpu().numpy()
        ms = flat[:n_metrics].reshape(stats.metrics.shape)
        n_done = stats.dones.numel()
        dones = flat[n_metrics:n_metrics + n_done] > 0.5
        rets = flat[n_metrics + n_done:]
        if isinstance(stats.learn_steps, (list, tuple)):
            ls = np.asarray(stats.learn_steps, np.float64)
            w = ls / max(float(ls.sum()), 1.0)
            out = {k: float((ms[:, i] * w).sum()) for i, k in enumerate(METRIC_KEYS)}
        else:
            out = {k: float(ms[i]) for i, k in enumerate(METRIC_KEYS)}
        out["episodes"] = int(dones.sum())
        if dones.any():
            out["episode_return"] = float(rets[dones].mean())
        return out

    @property
    def env_steps(self) -> int:
        return self._env_steps

    @property
    def learn_steps(self) -> int:
        return self._learn_steps

    # --- host views (checkpoint, eval) ---

    def actor_params_to_host(self) -> np.ndarray:
        """The actor params flat in actors/policy.flatten_params' layout."""
        return torch.cat([t.reshape(-1) for layer in self.state.actor_params
                          for t in (layer["w"], layer["b"])]).cpu().numpy()

    def load_train_state(self, state: TrainState) -> None:
        self.state = type(state)(*(None if f is None else _to_device(f, self.device)
                                   for f in state))
        self._step = int(self.state.step)
