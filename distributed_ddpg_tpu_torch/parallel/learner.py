"""The learner: K DDPG, TD3 or D4PG steps per dispatch, sampled on the device.

Counterpart of distributed_ddpg_tpu/parallel/learner.py, single device for
now (the name is kept; the data-parallel mesh and its launch of the chunk
kernel are later work). Every chunk is one launch of the hand-written CUDA
kernel (ops/fused_chunk.py) on the card, or its plain PyTorch version on
the CPU. There is no fallback from the kernel to the eager step: on the
card the kernel runs or the dispatch raises. For TD3 with target
smoothing each chunk also draws its noise [K, B, act] on the device, beside
the index draw (ops/fused_chunk.td3_noise_eps), keyed by the global step
the chunk starts at. Under D4PG, set_value_bounds moves the C51 support
between chunks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, StepOutput, init_train_state
from distributed_ddpg_tpu_torch.ops import fused_chunk
from distributed_ddpg_tpu_torch.types import TrainState, pack_batch_np


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
        self._fused = fused_chunk.make_fused_chunk_fn(
            config, obs_dim, act_dim, action_scale, action_offset,
            chunk_size=self.chunk_size, device=self.device,
        )
        # Index draws on the device, from their own seeded generator; TD3's
        # smoothing noise from another (td3_noise_eps reseeds it per chunk).
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self._noise_gen = (
            torch.Generator(device=self.device) if config.takes_noise else None
        )
        self._step = int(self.state.step)   # host copy of the global step
        self._done: Optional[torch.cuda.Event] = None

    def _run(self, packed: torch.Tensor) -> StepOutput:
        eps = None
        if self._noise_gen is not None:
            eps = fused_chunk.td3_noise_eps(
                self.config, self._noise_gen, self._step, self.chunk_size,
                self.config.batch_size, self.act_dim,
            )
        new_state, td, metrics = self._fused(self.state, packed, eps)
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
        and nothing is replanned. State, step and the index generator are
        untouched: training continues where it was. The auto-support
        controller (ops/support_auto.py, train.py) calls this once after
        warmup and on each expansion."""
        self.config = self.config.replace(v_min=float(v_min), v_max=float(v_max))
        self._fused.set_value_bounds(v_min, v_max)

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
        one index, (TD3) the chunk's smoothing noise drawn on the device,
        one kernel launch. `idx` ([K, B] ints) replaces the index draw."""
        storage, size = device_replay.device_state()
        if idx is None:
            idx = torch.randint(
                0, max(int(size), 1), (self.chunk_size, self.config.batch_size),
                generator=self._gen, device=self.device,
            )
        return self._run(storage[idx.to(self.device)])

    def run_chunk(self, np_batches: Dict[str, np.ndarray]) -> StepOutput:
        """K learner steps on host-fed [K, B, ...] stacked minibatches."""
        packed = torch.from_numpy(pack_batch_np(np_batches)).to(self.device)
        return self._run(packed)

    def actor_params_to_host(self) -> np.ndarray:
        """The actor params as one flat f32 vector in the layout of
        actors/policy.flatten_params (per layer w then b, C order), for the
        broadcast to CPU rollout workers. One device->host copy."""
        flat = torch.cat([
            t.reshape(-1) for layer in self.state.actor_params
            for t in (layer["w"], layer["b"])
        ])
        return flat.cpu().numpy()

    def metrics_to_host(self, out: StepOutput) -> Dict[str, float]:
        vals = torch.stack([out.metrics[k] for k in METRIC_KEYS]).cpu().tolist()
        return dict(zip(METRIC_KEYS, vals))
