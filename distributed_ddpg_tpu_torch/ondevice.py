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
which saturates there).

On D data-parallel ranks (`group`; a rank is a process), and on a (data,
model) grid of D x M, the monolith is JAX's on a mesh (JAX :112-160):
the global batch is batch_size * D under scale_batch_with_data (JAX's
divisibility check and message); the envs shard over the data group
when E % D == 0, else every rank steps all E (actors/device_pool.py's
rule: every rank draws all E envs' numbers and keeps its block, so the
rows are a one-rank monolith's); each iteration's rows, done flags and
finished returns are gathered over the data group into the global [E]
block, so every rank's ring is the same replicated ring and the chunk's
dones and returns are global; each rank draws the same global [B * D]
indices and trains on its columns through the eager step with the
gradient all-reduce (K2 under fused_update), on a grid on its shards of
the state (parallel/partition.py), the rollout acting with the logical
actor gathered over the model group after each learner step.
`logical_state()` and `state_template()` serve the checkpoint.
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
from distributed_ddpg_tpu_torch.ops.exploration import (
    StepDraws,
    draw_step,
    slice_draws,
    vector_env_step,
)
from distributed_ddpg_tpu_torch.parallel.learner import _to_device, resolve_device
from distributed_ddpg_tpu_torch.parallel.mesh import gather_env_blocks, make_grid, resolve_data_axis
from distributed_ddpg_tpu_torch.parallel.partition import (
    make_tp,
    shard_tree,
    state_pspec,
    unshard_tree,
)
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
    def __init__(self, config: DDPGConfig, chunk_size: int = 64, device=None, group=None):
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
        if group is not None:
            self.device = group.device
        self.num_envs = E = int(config.num_actors)
        self.chunk_size = int(chunk_size)
        self.superstep_beats = int(config.superstep_beats)
        # The ranks: the data axis, the grid (a collective the first time)
        # and this rank's data and model indices.
        M = self.model_axis = int(config.model_axis)
        D = self.data_size = resolve_data_axis(config, group.world_size if group else 1)
        self.group = group = make_grid(group, M)
        self.data_group = group.data if group is not None and D > 1 else None
        self.model_group = group.model if group is not None and M > 1 else None
        rank = group.rank // M if group is not None else 0
        model_rank = group.rank % M if group is not None else 0
        # JAX :121-131: batch_size rows a data-axis rank under
        # scale_batch_with_data, and its divisibility check and message.
        self.global_batch = (config.batch_size * D if config.scale_batch_with_data
                             else config.batch_size)
        if self.global_batch % D:
            raise ValueError(f"batch_size={config.batch_size} not divisible by data axis "
                             f"size {D}")
        self.b_local = self.global_batch // D
        self._cols = slice(rank * self.b_local, (rank + 1) * self.b_local)
        # The envs shard over the data group when they divide over it (JAX
        # :140-142), else every rank steps all E.
        self.env_sharded = D > 1 and E % D == 0
        self.local_envs = E // D if self.env_sharded else E
        lo = rank * self.local_envs if self.env_sharded else 0
        self.env_slice = slice(lo, lo + self.local_envs)
        self.env = make_vector_env(config.env_id, self.local_envs, self.device)
        self.obs_dim, self.act_dim = self.env.obs_dim, self.env.act_dim
        scale = ((self.env.action_high - self.env.action_low) / 2.0).astype(np.float32)
        offset = ((self.env.action_high + self.env.action_low) / 2.0).astype(np.float32)
        self.action_scale, self.action_offset = scale, offset
        on = dict(dtype=torch.float32, device=self.device)
        self._scale, self._offset = torch.tensor(scale, **on), torch.tensor(offset, **on)
        self._low = torch.tensor(self.env.action_low, **on)
        self._high = torch.tensor(self.env.action_high, **on)
        self.capacity = int(config.replay_capacity)
        self._min_fill = max(config.replay_min_size, config.batch_size)
        self._warmup_uniform = config.resolved_warmup_uniform()
        self._noise_gen = (torch.Generator(device=self.device)
                           if config.takes_noise or config.sac else None)
        logical = init_train_state(config, self.obs_dim, self.act_dim, config.seed,
                                   self.device)
        # The placement (parallel/partition.py) and this rank's shards.
        self._specs = state_pspec(logical, M)
        self._model_rank = model_rank
        tp = make_tp(self._specs, self.model_group)
        self._template = type(logical)(*(None if f is None else _to_device(f, "meta")
                                         for f in logical))
        self._step_fn = make_learner_step(config.replace(batch_size=self.b_local), scale,
                                          offset, self.data_group, tp)
        self.state: TrainState = shard_tree(logical, self._specs, model_rank, M)
        self._sync_actor()
        self._step = int(self.state.step)
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self.env_state = self.env.init(
            self.env.draw_reset(self._gen, E)[self.env_slice].contiguous())
        self.obs = self.env.observe(self.env_state)
        self.ou = torch.zeros((self.local_envs, self.act_dim), **on)
        self.ep_ret = torch.zeros(self.local_envs, **on)
        self.replay = DeviceReplay(self.capacity, self.obs_dim, self.act_dim,
                                   device=self.device)
        self._env_steps = 0
        self._learn_steps = 0

    # --- driving ---

    def _sync_actor(self) -> None:
        """The logical actor the rollout acts with: the state's, or on a
        grid the model group's gather of its shards (a collective)."""
        self.actor_params = (self.state.actor_params if self.model_group is None else
                             unshard_tree(self.state.actor_params, self._specs.actor_params,
                                          self.model_group))

    def _noise(self):
        """The step's TD3 noise or SAC normals: the global [B * D] draw,
        this rank's rows of it."""
        if self._noise_gen is None:
            return None
        draw = fused_chunk.sac_noise_eps if self.config.sac else fused_chunk.td3_noise_eps
        eps = draw(self.config, self._noise_gen, self._step, 1, self.global_batch,
                   self.act_dim)
        c = self._cols
        return (eps[0][0][c], eps[1][0][c]) if self.config.sac else eps[0][c]

    def run_chunk(self, draws: Optional[List[StepDraws]] = None,
                  indices: Optional[List[torch.Tensor]] = None) -> ChunkStats:
        """K iterations: K*E env steps and up to K learner steps. `draws`
        (K StepDraws of all E envs) and `indices` (one global [B * D] index
        tensor for each iteration that learns, in order) replace the
        generator's numbers. On more than one rank each iteration's rows
        are gathered over the data group (a collective)."""
        cfg, E = self.config, self.num_envs
        metrics, dones, rets = [], [], []
        learned = 0
        replay = self.replay
        for k in range(self.chunk_size):
            d = slice_draws(draws[k], self.env_slice) if draws is not None else draw_step(
                self.env, self.act_dim, self._gen, self._low, self._high,
                self._warmup_uniform > 0, num_envs=E, envs=self.env_slice)
            self.ou, _, out, rows = vector_env_step(
                cfg, self.env, self.actor_params, self.env_state, self.obs, self.ou,
                self._scale, self._offset, self._low, self._high, d,
                warmup_active=len(replay) < self._warmup_uniform)
            with torch.no_grad():
                ep_ret = self.ep_ret + out.reward
                done_ret = torch.where(out.done, ep_ret, 0.0)
                self.ep_ret = torch.where(out.done, 0.0, ep_ret)
                if self.env_sharded:
                    # Every rank's envs, with their done flags and finished
                    # returns, in the global env order.
                    block = gather_env_blocks(torch.cat(
                        [rows, out.done[:, None].to(rows.dtype), done_ret[:, None]],
                        dim=-1)[None], self.data_group)
                    rows = block[:, :-2].contiguous()
                    done, done_ret = block[:, -2] > 0.5, block[:, -1].contiguous()
                else:
                    done = out.done
            replay.insert_device_rows(rows)
            rets.append(done_ret)
            dones.append(done)
            self.env_state, self.obs = out.state, out.obs
            if len(replay) >= self._min_fill:
                if indices is not None:
                    idx = indices[learned].to(self.device)
                else:
                    idx = torch.randint(0, len(replay), (self.global_batch,),
                                        generator=self._gen, device=self.device)
                batch = unpack_batch(replay.storage[idx[self._cols]], self.obs_dim,
                                     self.act_dim)
                step = self._step_fn(self.state, batch, self._noise(), step_index=self._step)
                self.state = step.state
                self._sync_actor()
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
        """The (logical) actor params flat in actors/policy.flatten_params'
        layout."""
        return torch.cat([t.reshape(-1) for layer in self.actor_params
                          for t in (layer["w"], layer["b"])]).cpu().numpy()

    def logical_state(self) -> TrainState:
        """The logical state: on a grid the shards gathered over the model
        group (a collective: every rank calls it), else the state."""
        if self.model_group is None:
            return self.state
        return unshard_tree(self.state, self._specs, self.model_group)

    def state_template(self) -> TrainState:
        """checkpoint.restore's template (with device=): the logical state's
        shapes, as meta tensors on a grid."""
        return self.state if self.model_group is None else self._template

    def load_train_state(self, state: TrainState) -> None:
        """Take a logical state (this rank keeps its shards)."""
        state = type(state)(*(None if f is None else _to_device(f, self.device)
                              for f in state))
        self.state = shard_tree(state, self._specs, self._model_rank, self.model_axis)
        self._sync_actor()
        self._step = int(self.state.step)


# ---------------------------------------------------------------------------
# program-contract analyzer hook (analysis/programs.py)
# ---------------------------------------------------------------------------


def program_specs():
    """The on-device monolith (envs, ring and learner in one loop) on the
    2-rank probe group: one chunk of 2 iterations over 4 envs, and a
    superstep of B = 2 chunks, with the ring's minimum fill at one
    iteration's rows so that the learner steps from the second iteration
    on. Its state, env carry and ring are watched for moved storage."""
    from distributed_ddpg_tpu_torch.analysis.programs import (
        BuiltProgram,
        ProgramSpec,
        named_leaves,
        probe_config,
        probe_group,
        replay_leaves,
    )

    def build(superstep: bool):
        def _build(device: str) -> BuiltProgram:
            config = probe_config(device, num_actors=4, warmup_uniform_steps=8,
                                  batch_size=4, replay_min_size=4,
                                  superstep_beats=2 if superstep else 1)
            od = OnDeviceDDPG(config, chunk_size=2, group=probe_group(device))

            def leaves():
                carry = {"env_state": od.env_state, "obs": od.obs, "ou": od.ou,
                         "ep_ret": od.ep_ret}
                return {**named_leaves(od.state, "state"), **replay_leaves(od.replay),
                        **named_leaves(carry, "carry")}
            return BuiltProgram(od.run_superstep if superstep else od.run_chunk, leaves)
        return _build

    return [
        ProgramSpec("ondevice.chunk", "ondevice.py", build(False)),
        ProgramSpec("ondevice.superstep", "ondevice.py", build(True)),
    ]
