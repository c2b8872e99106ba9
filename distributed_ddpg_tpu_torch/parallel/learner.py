"""The learner: K DDPG, TD3, D4PG or SAC steps per dispatch, sampled on the device.

Counterpart of distributed_ddpg_tpu/parallel/learner.py, single device for
now (the name is kept; the data-parallel mesh and its launch of the chunk
kernel are later work). A chunk takes one of two routes, chosen once from
the config before the first dispatch (`fused_chunk`, as the JAX learner's
:357-405), and exposed as `fused_chunk_active`:

- the kernel route: one launch of the hand-written CUDA chunk kernel
  (ops/fused_chunk.py) on the card, or its plain PyTorch version on the
  CPU, for configs inside the kernel's envelope (ops/fused_chunk.
  supported) whose state fits its budget (ops/fused_chunk.fits_vmem, the
  JAX kernel's VMEM gate), under 'auto' or 'on';
- the scan route (`make_scan_chunk_fn`, the JAX learner's scan_steps):
  K of the port's eager steps (learner.make_learner_step), for configs
  outside the envelope or under 'off'. With fused_update each step's
  Adam and Polyak run in the fused update kernel (ops/fused_update.py).

Both take the same inputs and return the same outputs, and neither falls
back to the other at run time: on the card a kernel runs or the dispatch
raises. For TD3 with target smoothing each chunk also draws its noise
[K, B, act] on the device, beside the index draw (ops/fused_chunk.
td3_noise_eps), keyed by the global step the chunk starts at; for SAC its
two standard-normal streams (eps_next, eps_cur), each [K, B, act]
(ops/fused_chunk.sac_noise_eps), the same way; the scan route gives step k
its k-th slice. A SAC chunk advances the actor and critic counts and the
step by K, and the temperature's count by K when it is learned. Under
D4PG, set_value_bounds moves the C51 support between chunks.

With prioritized replay (run_sample_chunk_per) the chunk's rows are drawn
in proportion to their priorities (replay/device.py draw_per_indices), the
IS weights are written into the gathered rows' weight column, which both
routes read, and the chunk's (|td| + eps)^alpha go back into the priority
vector, all on the device, as the JAX learner's PER programs do.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    StepOutput,
    init_train_state,
    make_learner_step,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk
from distributed_ddpg_tpu_torch.replay.device import draw_per_indices, scatter_last_wins
from distributed_ddpg_tpu_torch.types import TrainState, pack_batch_np, unpack_batch


def resolve_device(config: DDPGConfig) -> torch.device:
    """config.device as a torch.device; raises when the card is asked for
    and none is present (never carries on quietly on the CPU)."""
    if config.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False: the port "
            "runs its learner on the card; pass device='cpu' to run the plain "
            "PyTorch versions instead"
        )
    return torch.device(config.device)


def resolve_learner_chunk(config: DDPGConfig) -> int:
    """Learner steps per dispatch: config.learner_chunk when set, else 800
    on the card and 8 on the CPU (the JAX package's rule, with the card in
    the place of a kernel-native TPU)."""
    if config.learner_chunk > 0:
        return config.learner_chunk
    return 800 if config.device == "cuda" else 8


def make_scan_chunk_fn(config: DDPGConfig, obs_dim: int, act_dim: int,
                       action_scale, action_offset=0.0, chunk_size: int = 8):
    """Returns run(state, packed[K, B, D], eps, step0) -> (new_state,
    td[K, B], metrics), the scan route: K eager steps over the chunk's rows,
    with the kernel route's inputs and outputs (the chunk-mean metrics in
    METRIC_KEYS order). Step k takes eps[k] (TD3) or (eps_next[k],
    eps_cur[k]) (SAC). `step0` is state.step as a host int (the learner's
    own count), from which step k takes its index for TD3's delay, so
    nothing inside the chunk reads the card back. run.set_value_bounds(v_min, v_max)
    rebuilds the step on the new C51 support, as the JAX package rebuilds
    its programs."""
    K, B = int(chunk_size), int(config.batch_size)
    D = 2 * int(obs_dim) + int(act_dim) + 3
    current = [config, make_learner_step(config, action_scale, action_offset)]

    def set_value_bounds(v_min: float, v_max: float) -> None:
        if not config.distributional:
            raise ValueError("set_value_bounds needs a distributional (D4PG) chunk")
        current[0] = current[0].replace(v_min=float(v_min), v_max=float(v_max))
        current[1] = make_learner_step(current[0], action_scale, action_offset)

    def run(state: TrainState, packed, eps, step0: int):
        cfg, step = current
        if cfg.distributional and cfg.v_support_auto:
            raise ValueError(
                "the C51 support is still 'auto': set_value_bounds must resolve "
                "v_min/v_max before the first chunk")
        if packed.shape != (K, B, D):
            raise ValueError(f"packed batch must be {(K, B, D)}, got {tuple(packed.shape)}")
        cfg.check_noise(eps)
        tds, metrics = [], []
        for k in range(K):
            e = eps if eps is None else (
                (eps[0][k], eps[1][k]) if cfg.sac else eps[k])
            out = step(state, unpack_batch(packed[k], obs_dim, act_dim), e,
                       step_index=step0 + k)
            state = out.state
            tds.append(out.td_errors)
            metrics.extend(out.metrics[name] for name in METRIC_KEYS)
        means = torch.stack(metrics).view(K, len(METRIC_KEYS)).mean(dim=0)
        return state, torch.stack(tds), dict(zip(METRIC_KEYS, means.unbind()))

    run.set_value_bounds = set_value_bounds
    return run


class ShardedLearner:
    def __init__(self, config: DDPGConfig, obs_dim: int, act_dim: int,
                 action_scale, action_offset=0.0, chunk_size: int = 1,
                 state: Optional[TrainState] = None):
        self.config = config
        self.device = resolve_device(config)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.chunk_size = int(chunk_size)
        self.state: TrainState = (
            state if state is not None
            else init_train_state(config, obs_dim, act_dim, config.seed, self.device)
        )
        # The route, once, before the first dispatch (JAX :357-405): the
        # chunk kernel where the config is in its envelope, else the scan.
        self.fused_chunk_active = (
            config.fused_chunk != "off" and fused_chunk.supported(config)
            and fused_chunk.fits_vmem(config, obs_dim, act_dim))
        if config.fused_chunk == "on" and not self.fused_chunk_active:
            # The JAX learner's message (parallel/learner.py:398-406).
            raise ValueError(
                "fused_chunk='on' but the config/mesh is outside the kernel "
                "envelope: needs mode='auto', a single-device or data-only "
                "mesh (model_axis == 1, and fused_mesh != 'off' for "
                "multi-device), plus action_insert_layer=1, critic_l2=0, "
                "fused_update=False, >=2 critic hidden layers, and nets "
                "small enough for VMEM (ops/fused_chunk.fits_vmem)"
            )
        if self.fused_chunk_active:
            self._chunk = fused_chunk.make_fused_chunk_fn(
                config, obs_dim, act_dim, action_scale, action_offset,
                chunk_size=self.chunk_size, device=self.device,
            )
        else:
            self._chunk = make_scan_chunk_fn(
                config, obs_dim, act_dim, action_scale, action_offset,
                chunk_size=self.chunk_size,
            )
        # Index draws on the device, from their own seeded generator; TD3's
        # smoothing noise or SAC's normals from another (td3_noise_eps and
        # sac_noise_eps reseed it per chunk).
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self._noise_gen = (
            torch.Generator(device=self.device)
            if config.takes_noise or config.sac else None
        )
        self._step = int(self.state.step)   # host copy of the global step
        self._done: Optional[torch.cuda.Event] = None

    def _run(self, packed: torch.Tensor) -> StepOutput:
        eps = None
        if self._noise_gen is not None:
            draw = fused_chunk.sac_noise_eps if self.config.sac else fused_chunk.td3_noise_eps
            eps = draw(self.config, self._noise_gen, self._step, self.chunk_size,
                       self.config.batch_size, self.act_dim)
        if self.fused_chunk_active:
            new_state, td, metrics = self._chunk(self.state, packed, eps)
        else:
            new_state, td, metrics = self._chunk(self.state, packed, eps, self._step)
        self.state = new_state
        self._step += self.chunk_size
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()
        return StepOutput(state=new_state, td_errors=td, metrics=metrics)

    def set_value_bounds(self, v_min: float, v_max: float) -> None:
        """Move the C51 support to [v_min, v_max] from the next chunk on.
        The JAX package rebuilds its chunk programs here (it bakes the
        support in at trace time); the port's kernel takes the support row
        and its spacing as launch inputs, so they are rewritten in place
        and nothing is replanned, and the scan route rebuilds its step on
        the new support. State, step and the index generator are
        untouched: training continues where it was. The auto-support
        controller (ops/support_auto.py, train.py) calls this once after
        warmup and on each expansion."""
        self.config = self.config.replace(v_min=float(v_min), v_max=float(v_max))
        self._chunk.set_value_bounds(v_min, v_max)

    def chunk_done(self) -> bool:
        """True once the last dispatched chunk has finished on the device
        (a poll; never blocks). Dispatch is asynchronous: a caller that
        polls this between chunks keeps one chunk in flight and can do host
        work (ingest) while it runs, instead of queueing chunks far ahead
        of the device and then blocking on all of them at its next read."""
        return self._done is None or self._done.query()

    def run_sample_chunk(self, device_replay, idx: Optional[torch.Tensor] = None) -> StepOutput:
        """K learner steps on minibatches drawn uniformly from the device
        replay: K*B indices drawn on the device, the rows gathered with
        one index, (TD3) the chunk's smoothing noise or (SAC) its normals
        drawn on the device, then one kernel launch (or the scan route's K
        steps). `idx` ([K, B] ints) replaces the index draw."""
        storage, size = device_replay.device_state()
        if idx is None:
            idx = torch.randint(
                0, max(int(size), 1), (self.chunk_size, self.config.batch_size),
                generator=self._gen, device=self.device,
            )
        return self._run(storage[idx.to(self.device)])

    def run_sample_chunk_per(self, device_replay, beta: float,
                             idx: Optional[torch.Tensor] = None,
                             weights: Optional[torch.Tensor] = None) -> StepOutput:
        """K learner steps on minibatches drawn from a DevicePrioritizedReplay
        in proportion to its priorities (the JAX learner's
        run_sample_chunk_per): one [K, B] uniform from the learner's index
        generator into draw_per_indices at this `beta`, the rows gathered (a
        copy) with the IS weights written into its weight column, the chunk
        on the learner's route, then the priorities of the drawn rows set
        to (|td| + eps)^alpha (an index drawn twice takes its last value in
        flat K x B order, scatter_last_wins) and max_priority raised to the
        largest of them. Priorities and max_priority are updated in place,
        on the device and in stream order, with no host read: an insert
        issued after this call returns stamps the new max. `idx` and
        `weights` ([K, B], given together) replace the draw."""
        storage, size, priorities, max_priority = device_replay.per_state()
        if (idx is None) != (weights is None):
            raise ValueError("idx and weights replace the PER draw together")
        if idx is None:
            idx, weights = draw_per_indices(
                priorities, size, (self.chunk_size, self.config.batch_size), beta,
                generator=self._gen)
        idx = idx.to(self.device)
        packed = storage[idx]
        packed[..., -1] = weights.to(self.device, torch.float32)
        out = self._run(packed)
        new_p = (out.td_errors.abs() + device_replay.eps) ** device_replay.alpha
        scatter_last_wins(priorities, idx.reshape(-1), new_p.reshape(-1))
        torch.maximum(max_priority, new_p.max(), out=max_priority)
        return out

    def run_chunk(self, np_batches: Dict[str, np.ndarray]) -> StepOutput:
        """K learner steps on host-fed [K, B, ...] stacked minibatches."""
        packed = torch.from_numpy(pack_batch_np(np_batches)).to(self.device)
        return self._run(packed)

    def actor_params_to_host(self) -> np.ndarray:
        """The actor params as one flat f32 vector in the layout of
        actors/policy.flatten_params (per layer w then b, C order; SAC's
        head 2 * act wide), for the broadcast to CPU rollout workers. One
        device->host copy."""
        flat = torch.cat([
            t.reshape(-1) for layer in self.state.actor_params
            for t in (layer["w"], layer["b"])
        ])
        return flat.cpu().numpy()

    def metrics_to_host(self, out: StepOutput) -> Dict[str, float]:
        vals = torch.stack([out.metrics[k] for k in METRIC_KEYS]).cpu().tolist()
        return dict(zip(METRIC_KEYS, vals))
