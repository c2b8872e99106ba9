"""The learner: K DDPG, TD3, D4PG or SAC steps per dispatch, sampled on the device.

Counterpart of distributed_ddpg_tpu/parallel/learner.py, on one device or
on a data-parallel group of D ranks (parallel/mesh.py, one process and one
card a rank). A chunk takes one of two routes, chosen once from the config
and the group's size before the first dispatch (`fused_chunk` and
`fused_mesh`, as the JAX learner's :357-414), and exposed as
`fused_chunk_active` (and `fused_mesh_active` on D > 1 ranks):

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

Host-fed chunks (the host replay's path, train.py with host_replay and
parallel/prefetch.py) come in through put_chunk and run_chunk_async (the
JAX learner's pair; run_chunk is the two in one): put_chunk packs the
sampled [K, B, ...] fields into a pinned buffer of a pool and copies it
to the card on the learner's copy stream, a side stream, recording an
event; run_chunk_async makes the chunk's stream wait on that event before
the chunk reads the rows, and the pool does not hand the buffer out again
before the event has completed. So the copy of chunk n + 1 overlaps chunk
n, and neither a half-copied chunk nor a reused buffer can be read. The
rows carry their own weights (PER's IS weights from the host sum tree).

With guardrails (config.guardrails; guardrails.py) a chunk takes the scan
route, as the JAX learner's guarded programs do (:366-371, :582-720), and
'auto' degrades to it: before the steps the gathered rows are screened
(batch_row_health: per-step bad flags, the bad-row count added to the
GuardState, the first 32 bad replay indices), then each of the K steps
runs through the guarded step with its own step index (TD3's delay) or
normals (SAC), and under PER a bad step's rows take the priority
(0 + eps)^alpha from its zeroed td. The GuardState and the health word
stay on the device: a guarded chunk reads nothing back. The host reads the
word (poll_health) and the bad indices (bad_indices) after the chunk has
ended. reset_guard, reseed and set_lr_scale serve the trainer's
rollback-repair (train.py). Guardrails run on one rank only.

The fused beat (parallel/megastep.py, superstep.py) composes the scan
route's sampling chunk (`scan_sample_fn`: uniform or PER, guarded or not,
whatever route the learner's own chunks take) with the device actors'
rollout; a superstep hands its stacked per-beat health ([B, 5], and the
bad indices [B, 32]) back through `note_fused_health`, and poll_health
then reports the last row and the first beat whose anomaly count moved
(`first_bad_beat`).

On D > 1 ranks the global batch is batch_size * D (scale_batch_with_data,
else batch_size), b_local = global / D rows a rank, and a chunk runs one
of two ways (the JAX learner's rules as they are):

- the mesh launch (`fused_mesh_active`: the kernel's envelope holds and
  fused_mesh != 'off'; the JAX learner's _make_fused_mesh_fn, :769-870):
  each rank draws its own [K, b_local] indices from a generator with its
  rank folded into the seed (and its TD3 noise or SAC normals with the
  rank folded in, device_fold), runs the chunk kernel on them, and at the
  chunk's end one all_reduce averages every float leaf of the state
  (params, targets, Adam moments, SAC's log_alpha and alpha_opt moments)
  and the metrics: K-step local SGD. Counts and step pass through;
- the scan route with a gradient all-reduce every step (fused_mesh='off',
  configs outside the envelope, and every PER chunk on a mesh: the JAX
  learner builds its PER kernel program for one device only, :408-414):
  every rank draws the same global [K, B * D] indices (and noise) from
  the same generator, as the JAX learner's replicated key does, and runs
  its own columns [rank * b_local, (rank + 1) * b_local) through the
  eager step with the group.

Either way td comes back as the global [K, B * D], rank d's rows in its
columns (a zero buffer each rank writes its part into, summed). With PER
every rank then writes the same priorities from the same global draw and
td, so the replicas' priority vectors stay bit-identical (the draw's
prefix sum has a fixed order on the card, replay/device.py).

With the sharded replay (config.replay_sharding='sharded', the placement
of replay/device.py: logical row p on rank p % D at slot p // D) the
chunk leaves the kernel's envelope, so 'auto' takes the scan route (the
JAX learner's :372-375), with K2 under fused_update. The global
[K, B * D] draw is the same on every rank, as above; each rank gathers
the rows it owns and writes -0.0 elsewhere, and one sum all-reduce over
the group rebuilds the minibatch (every row has one owner, and
x + (-0.0) == x), bit for bit the replicated one, of which each rank
takes its columns. PER draws with draw_sharded_per_indices (each rank's
prefix sum over its own slots, the shard totals all-gathered) and writes
the chunk's priorities back owner-only (owner_scatter_last_wins, the
last-wins rule inside the owner); max_priority is the same on every
rank.

On a (data, model) grid (config.model_axis M > 1, parallel/mesh.make_grid:
rank r at data index r // M, model index r % M) the learner is tensor-
parallel, as the JAX learner is on a (data, model) mesh: the state's
params, targets and Adam moments are split by the partition rule tables
(parallel/partition.state_pspec; `specs`), each rank holding its shards
(shard_tree), and every chunk takes the scan route (K1 needs the nets
whole: the JAX learner keeps it off the mesh, :386-396), with K2 under
fused_update on the rank's shards. The data axis is D = world / M:
b_local splits the batch over it, the columns a rank trains on, the
sharded replay's owner and the mesh launch's folds are its data index
(so every rank of a model group draws and trains on the same rows and
noise), and the gradient mean, the td gather and the sharded replay's
exchanges run over its data group. A checkpoint holds the logical state:
logical_state() gathers the shards over the model group (a collective),
load_state() takes a logical state and keeps this rank's shards, and
state_template() is the logical state's shape (meta tensors) for
checkpoint.restore.
actor_params_to_host() returns the logical actor, gathered at the end of
every chunk (so only rank 0 need call it). mode='explicit' (the JAX
learner's shard_map mode) is data-parallel only: the port's data-
parallel step is already explicit collectives, so it runs as 'auto'.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch import guardrails as guard_lib
from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.devices import require_device
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    StepOutput,
    init_train_state,
    make_learner_step,
    state_signature,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk
from distributed_ddpg_tpu_torch.parallel.mesh import (
    DataGroup,
    all_reduce_mean_,
    all_reduce_sum_,
    make_grid,
    resolve_data_axis,
)
from distributed_ddpg_tpu_torch.parallel.partition import (
    make_tp,
    shard_tree,
    sharded_dim,
    state_pspec,
    unshard_tree,
)
from distributed_ddpg_tpu_torch.replay.device import (
    draw_per_indices,
    make_sharded_per_draw,
    owner_scatter_last_wins,
    scatter_last_wins,
)
from distributed_ddpg_tpu_torch.transfer.hostbuf import HostBufferPool
from distributed_ddpg_tpu_torch.types import (
    OptState,
    TrainState,
    pack_batch_np,
    packed_width,
    unpack_batch,
)


class HostChunk(NamedTuple):
    """A host-fed chunk on its way to the learner (put_chunk): the packed
    [K, B * D, W] rows on the learner's device, and the event that marks
    the end of their copy (None on the CPU)."""

    packed: torch.Tensor
    ready: Optional[torch.cuda.Event]


def resolve_device(config: DDPGConfig) -> torch.device:
    """config.device as a torch.device; raises when the card is asked for
    and none is present (never carries on quietly on the CPU)."""
    return require_device(config.device)


def resolve_learner_chunk(config: DDPGConfig) -> int:
    """Learner steps per dispatch: config.learner_chunk when set, else 800
    on the card and 8 on the CPU (the JAX package's rule, with the card in
    the place of a kernel-native TPU)."""
    if config.learner_chunk > 0:
        return config.learner_chunk
    return 800 if config.device == "cuda" else 8


def make_scan_chunk_fn(config: DDPGConfig, obs_dim: int, act_dim: int,
                       action_scale, action_offset=0.0, chunk_size: int = 8,
                       group: Optional[DataGroup] = None, guard: bool = False,
                       inject: Optional[Dict[str, tuple]] = None, tp=None):
    """Returns run(state, packed[K, B, D], eps, step0) -> (new_state,
    td[K, B], metrics), the scan route: K eager steps over the chunk's rows,
    with the kernel route's inputs and outputs (the chunk-mean metrics in
    METRIC_KEYS order). Step k takes eps[k] (TD3) or (eps_next[k],
    eps_cur[k]) (SAC). `step0` is state.step as a host int (the learner's
    own count), from which step k takes its index for TD3's delay, so
    nothing inside the chunk reads the card back. run.set_value_bounds(v_min, v_max)
    rebuilds the step on the new C51 support, as the JAX package rebuilds
    its programs, and run.set_lr_scale(scale) on both learning rates times
    `scale` (the guardrails' LR cooldown); each keeps the other's setting.
    With `group` every step averages its gradients over the group's ranks
    (learner.make_learner_step), B being the rank's rows; with `tp`
    (parallel/partition.TP) the steps run on the rank's shards. With `guard`,
    run.guarded(state, g, packed, eps, step0, pre_bad) -> (new_state,
    new_g, td, metrics) runs the K steps through the health probe
    (guardrails.make_guarded_step, with the `inject` ordinals), step k
    with its screen flag pre_bad[k]."""
    K, B = int(chunk_size), int(config.batch_size)
    D = 2 * int(obs_dim) + int(act_dim) + 3
    settings = {"bounds": None, "lr_scale": 1.0}
    current = []

    def build() -> None:
        cfg = config
        if settings["bounds"] is not None:
            cfg = cfg.replace(v_min=settings["bounds"][0], v_max=settings["bounds"][1])
        if settings["lr_scale"] != 1.0:
            cfg = cfg.replace(actor_lr=config.actor_lr * settings["lr_scale"],
                              critic_lr=config.critic_lr * settings["lr_scale"])
        step = make_learner_step(cfg, action_scale, action_offset, group, tp)
        gstep = (guard_lib.make_guarded_step(step, cfg.guardrail_zmax,
                                             cfg.guardrail_warmup_steps, inject)
                 if guard else None)
        current[:] = [cfg, step, gstep]

    def set_value_bounds(v_min: float, v_max: float) -> None:
        if not config.distributional:
            raise ValueError("set_value_bounds needs a distributional (D4PG) chunk")
        settings["bounds"] = (float(v_min), float(v_max))
        build()

    def set_lr_scale(scale: float) -> None:
        settings["lr_scale"] = float(scale)
        build()

    def checked(packed, eps):
        cfg = current[0]
        if cfg.distributional and cfg.v_support_auto:
            raise ValueError(
                "the C51 support is still 'auto': set_value_bounds must resolve "
                "v_min/v_max before the first chunk")
        if packed.shape != (K, B, D):
            raise ValueError(f"packed batch must be {(K, B, D)}, got {tuple(packed.shape)}")
        cfg.check_noise(eps)
        return cfg

    def noise_at(cfg, eps, k):
        return eps if eps is None else ((eps[0][k], eps[1][k]) if cfg.sac else eps[k])

    def chunk_means(metrics):
        means = torch.stack(metrics).view(K, len(METRIC_KEYS)).mean(dim=0)
        return dict(zip(METRIC_KEYS, means.unbind()))

    def run(state: TrainState, packed, eps, step0: int):
        cfg, step, _ = current
        checked(packed, eps)
        tds, metrics = [], []
        for k in range(K):
            out = step(state, unpack_batch(packed[k], obs_dim, act_dim), noise_at(cfg, eps, k),
                       step_index=step0 + k)
            state = out.state
            tds.append(out.td_errors)
            metrics.extend(out.metrics[name] for name in METRIC_KEYS)
        return state, torch.stack(tds), chunk_means(metrics)

    def guarded(state: TrainState, g, packed, eps, step0: int, pre_bad):
        cfg, _, gstep = current
        checked(packed, eps)
        tds, metrics = [], []
        for k in range(K):
            state, g, td, ms = gstep(state, g, unpack_batch(packed[k], obs_dim, act_dim),
                                     pre_bad[k], noise_at(cfg, eps, k), step_index=step0 + k)
            tds.append(td)
            metrics.extend(ms[name] for name in METRIC_KEYS)
        return state, g, torch.stack(tds), chunk_means(metrics)

    build()
    run.set_value_bounds = set_value_bounds
    run.set_lr_scale = set_lr_scale
    if guard:
        run.guarded = guarded
    return run


class ShardedLearner:
    def __init__(self, config: DDPGConfig, obs_dim: int, act_dim: int,
                 action_scale, action_offset=0.0, chunk_size: int = 1,
                 state: Optional[TrainState] = None, group: Optional[DataGroup] = None,
                 mode: str = "auto"):
        # The JAX learner's mode checks and messages (:92-93, :108-109).
        if mode not in ("auto", "explicit"):
            raise ValueError(f"mode must be 'auto' or 'explicit', got {mode!r}")
        if mode == "explicit" and config.model_axis != 1:
            raise ValueError("explicit (shard_map) mode is data-parallel only")
        self.mode = mode
        self.config = config
        self.model_axis = M = int(config.model_axis)
        self.data_size = resolve_data_axis(config, group.world_size if group else 1)
        # The grid (a collective the first time): the data and model groups.
        self.group = group = make_grid(group, M)
        # The ranks with this rank's model index (the group itself when
        # M = 1): the gradient mean's, the td gather's, the sharded replay's.
        self.data_group = group.data if group is not None and M > 1 else group
        # This rank's data index: its columns, its replay shard, its folds.
        self.rank = group.rank // M if group else 0
        self.model_rank = group.rank % M if group else 0
        self.device = resolve_device(config)
        if group is not None:
            if group.device.type != self.device.type:
                raise ValueError(f"the group's device {group.device} is not on "
                                 f"config.device={config.device!r}")
            self.device = group.device
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.chunk_size = int(chunk_size)
        # Rows a learner step draws (JAX :129-138): batch_size a rank, or
        # batch_size in all, split over the ranks.
        D = self.data_size
        self.global_batch = (config.batch_size * D if config.scale_batch_with_data
                             else config.batch_size)
        if self.global_batch % D:
            raise ValueError(
                f"batch_size={config.batch_size} not divisible by data axis size {D}")
        self.b_local = self.global_batch // D
        logical = (state if state is not None
                   else init_train_state(config, obs_dim, act_dim, config.seed, self.device))
        # The placement (partition rules) and this rank's shards of it.
        self.specs = state_pspec(logical, M)
        self.tp = make_tp(self.specs, group.model if M > 1 else None)
        # The logical state's paths, shapes and dtypes without its storage
        # (meta tensors): load_state's check, checkpoint.restore's template.
        self._template = type(logical)(*(
            None if field is None else _to_device(field, "meta") for field in logical))
        self.state: TrainState = shard_tree(logical, self.specs, self.model_rank, M)
        # The route, once, before the first dispatch (JAX :357-414): the
        # chunk kernel where the config is in its envelope, on one device
        # or as the mesh launch on D > 1 ranks unless fused_mesh='off';
        # else the scan. PER takes the kernel on one device only.
        # Guardrails need the probe in every step: the chunk kernel has no
        # slot for it, so they take the scan route (JAX :366-371).
        self.guard_enabled = bool(config.guardrails)
        # The sharded replay's rows are gathered across the ranks, which the
        # chunk kernel cannot do: the scan route (JAX :372-375).
        self.replay_sharded = config.replay_sharding == "sharded"
        self._gather_ranks = D if self.replay_sharded else 1
        self._per_draw = (make_sharded_per_draw(self.data_group) if self._gather_ranks > 1
                          else draw_per_indices)
        if self.guard_enabled and D > 1:
            raise ValueError(
                f"guardrails=True on {D} ranks is not in this slice of the PyTorch "
                "port (the row screen shared across ranks: ROADMAP.md Queue 1 "
                "item 10, its data-plane half); run the guarded learner on one rank")
        envelope_ok = (
            config.fused_chunk != "off" and not self.guard_enabled
            and not self.replay_sharded and M == 1
            and fused_chunk.supported(config)
            and fused_chunk.fits_vmem(config, obs_dim, act_dim))
        self.fused_mesh_active = envelope_ok and D > 1 and config.fused_mesh != "off"
        self.fused_chunk_active = envelope_ok and (D == 1 or self.fused_mesh_active)
        self.fused_per_active = self.fused_chunk_active and not self.fused_mesh_active
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
        local = config.replace(batch_size=self.b_local) if D > 1 else config
        self._chunk = self._scan = None
        if self.fused_chunk_active:
            self._chunk = fused_chunk.make_fused_chunk_fn(
                local, obs_dim, act_dim, action_scale, action_offset,
                chunk_size=self.chunk_size, device=self.device,
            )
        if not self.fused_per_active:
            self._scan = make_scan_chunk_fn(
                local, obs_dim, act_dim, action_scale, action_offset,
                chunk_size=self.chunk_size, group=self.data_group if D > 1 else None,
                guard=self.guard_enabled, tp=self.tp,
                inject=(config.fault_plan().numeric_steps()
                        if self.guard_enabled and config.faults else None),
            )
        # Index draws on the device, from their own seeded generator (the
        # same on every rank: the scan route's global draw and PER's); the
        # mesh launch's own draws from one with the rank folded into its
        # seed; TD3's smoothing noise or SAC's normals from another
        # (td3_noise_eps and sac_noise_eps reseed it per chunk).
        self._gen = torch.Generator(device=self.device).manual_seed(config.seed)
        self._rank_gen = (
            torch.Generator(device=self.device).manual_seed(fused_chunk.fold_seed(config.seed, self.rank))
            if self.fused_mesh_active else None)
        self._noise_gen = (
            torch.Generator(device=self.device)
            if config.takes_noise or config.sac else None
        )
        self._step = int(self.state.step)   # host copy of the global step
        self._done: Optional[torch.cuda.Event] = None
        # Host-fed chunks (put_chunk): pinned staging buffers and the side
        # stream their copies run on, on the card only.
        on_card = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        self._chunk_pool = HostBufferPool(packed_width(obs_dim, act_dim), depth=2,
                                          pin=True) if on_card else None
        # The LR cooldown's scale (set_lr_scale), applied where the step is
        # built, so it composes with set_value_bounds.
        self._lr_scale = 1.0
        if self.guard_enabled:
            # The probe's state and the last chunk's (health word, bad
            # indices), all on the device until the host polls them.
            self._guard = guard_lib.init_guard_state(device=self.device)
            self._health_cur = None
            self._health_prev_anom = 0   # nonfinite + spikes at the last poll
        self._local_config = local
        self._action = (action_scale, action_offset)
        self._actor_logical = None
        self._sync_actor()

    def load_state(self, state: TrainState) -> None:
        """Take a restored state (checkpoint.restore) as the learner's own:
        every leaf put on the learner's device, its paths, shapes and
        dtypes those of the current state (else a ValueError). The host
        copy of the step is set from it: each chunk's TD3 smoothing noise
        and SAC normals are reseeded from (seed, step) and the scan route's
        TD3 delay counts from it, so a stale copy would give a resumed
        chunk the wrong noise without an error. The index generators are
        not part of a checkpoint, as the JAX learner's key is not: a
        resumed run draws other rows than an uninterrupted one would."""
        if state_signature(state) != state_signature(self._template):
            raise ValueError("the state does not match this learner's (paths, shapes "
                             "or dtypes): was it saved under another config?")
        state = type(state)(*(
            None if field is None else _to_device(field, self.device) for field in state))
        self.state = shard_tree(state, self.specs, self.model_rank, self.model_axis)
        self._step = int(self.state.step)
        self._done = None
        self._sync_actor()

    def state_template(self) -> TrainState:
        """The logical state's paths, shapes and dtypes (checkpoint.restore's
        template, with device=self.device): on one model rank the state,
        else meta tensors, so a rank holds no logical copy of the state."""
        return self.state if self.model_axis == 1 else self._template

    def logical_state(self) -> TrainState:
        """The logical state: the shards gathered over the model group (a
        collective: every rank calls it); on one model rank, the state."""
        if self.model_axis == 1:
            return self.state
        return unshard_tree(self.state, self.specs, self.group.model)

    def state_sharded(self):
        """For each tensor of parallel/learner.state_tensors(self.state),
        whether it is a shard (replicas_equal's `sharded`)."""
        return [sharded_dim(s) is not None for s in state_tensors(self.specs)]

    def _sync_actor(self) -> None:
        """The logical actor, gathered over the model group (on every rank,
        in lockstep: at construction, load_state and every chunk's end)."""
        if self.model_axis > 1:
            self._actor_logical = unshard_tree(self.state.actor_params,
                                               self.specs.actor_params, self.group.model)

    def route(self, per: bool = False) -> str:
        """'kernel' (one device), 'mesh' (the mesh launch) or 'scan': the
        route a uniform chunk, or with `per` a PER chunk, takes."""
        if per and self.fused_per_active or not per and self.fused_chunk_active:
            return "mesh" if self.fused_mesh_active and not per else "kernel"
        return "scan"

    def _cols(self, x):
        """This rank's columns of a global [K, B * D, ...] draw (a pair of
        them under SAC); on one device the draw itself."""
        if x is None or self.data_size == 1:
            return x
        if isinstance(x, (tuple, list)):
            return tuple(self._cols(e) for e in x)
        lo = self.rank * self.b_local
        return x[:, lo:lo + self.b_local]

    def _gather(self, device_replay, storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The global rows at logical indices `idx` ([K, B * D]): a plain
        gather from a replicated ring; from a sharded one, this rank's
        owned rows with -0.0 elsewhere, summed over the group (the JAX
        learner's gather_rows), the same rows on every rank."""
        n = self._gather_ranks
        if n == 1:
            return storage[idx]
        if device_replay.n_shards != n:
            raise ValueError(f"the replay is sharded over {device_replay.n_shards} rank(s), "
                             f"the learner over {n}")
        owned = idx % n == self.rank
        rows = storage[torch.where(owned, idx // n, torch.zeros_like(idx))]
        rows.masked_fill_(~owned[..., None], -0.0)
        all_reduce_sum_([rows], self.data_group)
        return rows

    def _noise(self, batch: int, device_fold: Optional[int] = None):
        """The chunk's TD3 noise or SAC normals for `batch` rows, keyed by
        the step it starts at (and on the mesh launch by the rank)."""
        if self._noise_gen is None:
            return None
        draw = fused_chunk.sac_noise_eps if self.config.sac else fused_chunk.td3_noise_eps
        args = (self.config, self._noise_gen, self._step, self.chunk_size, batch, self.act_dim)
        return draw(*args) if device_fold is None else draw(*args, device_fold=device_fold)

    def _gathered(self, td: torch.Tensor, sums=None) -> torch.Tensor:
        """The global [K, B * D] td from this rank's [K, b_local]: a zero
        buffer with the rank's columns written, summed over the group."""
        if self.data_size == 1:
            return td
        full = torch.zeros((self.chunk_size, self.global_batch), dtype=td.dtype,
                           device=td.device)
        self._cols(full).copy_(td)
        if sums is None:
            all_reduce_mean_([], self.data_group, sums=[full])
        else:
            sums.append(full)
        return full

    def _screen(self, packed: torch.Tensor, idx: Optional[torch.Tensor]):
        """The guarded chunk's row screen (guardrails.batch_row_health) of
        the rows as gathered, or None when guardrails are off; `idx` (the
        draw, None when the host fed the rows) names them."""
        return guard_lib.batch_row_health(packed, idx) if self.guard_enabled else None

    def _run(self, packed: torch.Tensor, eps, kernel: bool, screen=None) -> StepOutput:
        if kernel:
            new_state, td, metrics = self._chunk(self.state, packed, eps)
        elif self.guard_enabled:
            # The screen's count into the GuardState, then the guarded
            # steps (JAX :633-650).
            pre_bad, bad_count, bad_idx = screen
            g = self._guard._replace(bad_rows=self._guard.bad_rows + bad_count)
            new_state, self._guard, td, metrics = self._scan.guarded(
                self.state, g, packed, eps, self._step, pre_bad)
            self._health_cur = (guard_lib.health_vector(self._guard), bad_idx)
        else:
            new_state, td, metrics = self._scan(self.state, packed, eps, self._step)
        if self.fused_mesh_active and kernel:
            # K-step local SGD: one all_reduce averages every float leaf and
            # the metrics and gathers the td (JAX :815-850).
            sums = []
            td = self._gathered(td, sums)
            all_reduce_mean_(float_leaves(new_state) + list(metrics.values()), self.group,
                             sums=sums)
        else:
            td = self._gathered(td)
        self.state = new_state
        self._step += self.chunk_size
        self._sync_actor()
        self.mark_dispatched()
        return StepOutput(state=new_state, td_errors=td, metrics=metrics)

    def mark_dispatched(self) -> None:
        """Record the end of the work queued so far on the learner's stream,
        the event chunk_done() polls (a chunk's, or a fused beat's after
        its rollout and scatter)."""
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()

    def set_value_bounds(self, v_min: float, v_max: float) -> None:
        """Move the C51 support to [v_min, v_max] from the next chunk on.
        The JAX package rebuilds its chunk programs here (it bakes the
        support in at trace time); the port's kernel takes the support row
        and its spacing as launch inputs, so they are rewritten in place
        and nothing is replanned, and the scan route rebuilds its step on
        the new support. State, step and the index generator are
        untouched: training continues where it was. The auto-support
        controller (ops/support_auto.py, train.py) calls this once after
        warmup and on each expansion, on every rank with the same bounds."""
        self.config = self.config.replace(v_min=float(v_min), v_max=float(v_max))
        for run in (self._chunk, self._scan):
            if run is not None:
                run.set_value_bounds(v_min, v_max)

    # --- numerical-health guardrails (guardrails.py) ---

    def poll_health(self) -> Optional[Dict[str, int]]:
        """The probe's cumulative counters after the last guarded chunk
        (HEALTH_KEYS), the one read of the health word a chunk; None before
        the first guarded chunk, after reset_guard, or with guardrails off.
        Call it once chunk_done() is true: the read waits for the chunk.
        After a superstep (note_fused_health with a [B, 5] stack) the same
        one read: the last row's counters, plus `first_bad_beat`, the first
        beat whose anomalies (nonfinite + spikes) moved past the previous
        poll's, -1 when none did (JAX :1103-1150)."""
        if not self.guard_enabled or self._health_cur is None:
            return None
        vec = self._health_cur[0]
        with trace.span("health_d2h"):
            vec = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec, np.int64)
        keys = guard_lib.HEALTH_KEYS
        if vec.ndim == 1:
            h = dict(zip(keys, (int(v) for v in vec)))
        else:
            anom = vec[:, keys.index("nonfinite")] + vec[:, keys.index("spikes")]
            fresh = np.flatnonzero(anom > self._health_prev_anom)
            h = dict(zip(keys, (int(v) for v in vec[-1])))
            h["first_bad_beat"] = int(fresh[0]) if fresh.size else -1
        self._health_prev_anom = h["nonfinite"] + h["spikes"]
        return h

    def bad_indices(self) -> np.ndarray:
        """Replay indices of the non-finite rows the last guarded chunk
        drew (the first guardrails.GUARD_BAD_IDX, the -1 padding dropped;
        a superstep's [B, 32] captures flattened). Read only when the
        health word shows new bad rows."""
        if not self.guard_enabled or self._health_cur is None:
            return np.empty(0, np.int64)
        arr = self._health_cur[1].cpu().numpy().astype(np.int64).reshape(-1)
        return arr[arr >= 0]

    # --- the fused beat's composition hooks (parallel/megastep.py) ---

    def scan_sample_fn(self, per: bool):
        """The scan route's sampling chunk as a callable (JAX
        pure_scan_sample_fn): uniform `fn(replay, idx=None)`, PER
        `fn(replay, beta, idx=None, weights=None)` (the draw replaced as in
        run_sample_chunk(_per)),
        guarded or not as the learner is, each run_sample_chunk(_per) on
        the scan route whatever route the learner's own chunks take (the
        scan's step is built here if the kernel route had no use for it).
        The fused beat composes it with the rollout and the scatter."""
        if self.data_size > 1 or self.model_axis > 1:
            raise ValueError("the fused beat runs on one rank (ROADMAP.md Queue 1 item 10, "
                             "its data-plane half)")
        if self._scan is None:
            self._scan = make_scan_chunk_fn(
                self._local_config, self.obs_dim, self.act_dim, *self._action,
                chunk_size=self.chunk_size, guard=self.guard_enabled)
            if self.config.distributional and not self.config.v_support_auto:
                self._scan.set_value_bounds(self.config.v_min, self.config.v_max)
        if per:
            return lambda replay, beta, idx=None, weights=None: self.run_sample_chunk_per(
                replay, beta, idx=idx, weights=weights, kernel=False)
        return lambda replay, idx=None: self.run_sample_chunk(replay, idx=idx, kernel=False)

    def note_fused_health(self, guard, health, bad_idx) -> None:
        """Install the probe state and the health word(s) a fused dispatch
        left, so poll_health and bad_indices read them as a guarded
        chunk's: a beat's [5] word and [32] captures, or a superstep's
        stacked [B, 5] and [B, 32] (the health may already be on the host:
        the superstep reads its stack once)."""
        self._guard = guard
        self._health_cur = (health, bad_idx)

    def reset_guard(self) -> None:
        """Re-arm the probe after a rollback: the EWMA statistics reset (the
        restored params have the loss scale of before the divergence), the
        cumulative counters and the monotonic step clock survive (the
        host's deltas and the numeric fault ordinals key on them)."""
        if not self.guard_enabled:
            return
        h = self.poll_health() or {}
        self._guard = guard_lib.init_guard_state(
            **{k: h.get(k, int(getattr(self._guard, k))) for k in guard_lib.HEALTH_KEYS},
            device=self.device)
        self._health_cur = None

    def reseed(self, salt: int) -> None:
        """Fold `salt` into the index generator's seed (fused_chunk.fold_seed,
        deterministic). Rollback-repair calls this so the restored run
        draws other rows than the run that diverged: restoring the state
        alone would replay the same draws into the same divergence."""
        self._gen.manual_seed(fused_chunk.fold_seed(self._gen.initial_seed(), int(salt)))

    @property
    def lr_scale(self) -> float:
        return self._lr_scale

    def set_lr_scale(self, scale: float) -> None:
        """Scale both learning rates (the guardrails' rollback cooldown) from
        the next chunk on: the scan route rebuilds its step with
        actor_lr * scale and critic_lr * scale, keeping the C51 support
        set_value_bounds gave it (K2 reads the rates from that step's
        config). State, generators and the guard are untouched. The LR
        cooldown belongs to the guarded route, the scan route: on the
        kernel route this raises."""
        scale = float(scale)
        if scale == self._lr_scale:
            return
        if self.route(per=self.config.prioritized) != "scan":
            raise ValueError("set_lr_scale is the guardrails' LR cooldown; it runs on "
                             "the scan route, and this learner takes the kernel route")
        self._lr_scale = scale
        self._scan.set_lr_scale(scale)

    def chunk_done(self) -> bool:
        """True once the last dispatched chunk has finished on the device
        (a poll; never blocks). Dispatch is asynchronous: a caller that
        polls this between chunks keeps one chunk in flight and can do host
        work (ingest) while it runs, instead of queueing chunks far ahead
        of the device and then blocking on all of them at its next read."""
        return self._done is None or self._done.query()

    def run_sample_chunk(self, device_replay, idx: Optional[torch.Tensor] = None,
                         eps=None, kernel: Optional[bool] = None) -> StepOutput:
        """K learner steps on minibatches drawn uniformly from the device
        replay: K*B indices drawn on the device, the rows gathered with
        one index, (TD3) the chunk's smoothing noise or (SAC) its normals
        drawn on the device, then one kernel launch (or the scan route's K
        steps). `idx` ([K, B] ints) and `eps` (the noise) replace the
        draws: on the mesh launch this rank's own [K, b_local], on the
        scan route the global [K, B * D] every rank draws. `kernel=False`
        takes the scan route whatever the learner's own route (the fused
        beat's leg, scan_sample_fn).

        The draw reads the replay's host `size` and the gather is issued
        under its dispatch_lock, so an insert (on whatever thread ships)
        lands wholly before or wholly after it in the stream, with ptr and
        size moving together with the rows."""
        with device_replay.dispatch_lock:
            storage, size = device_replay.device_state()
            if self.fused_mesh_active:
                if idx is None:
                    idx = torch.randint(0, max(int(size), 1), (self.chunk_size, self.b_local),
                                        generator=self._rank_gen, device=self.device)
                packed = storage[idx.to(self.device)]
            else:
                if idx is None:
                    idx = torch.randint(
                        0, max(int(size), 1), (self.chunk_size, self.global_batch),
                        generator=self._gen, device=self.device,
                    )
                if self._gather_ranks > 1:
                    packed = self._cols(self._gather(device_replay, storage,
                                                     idx.to(self.device))).contiguous()
                else:
                    packed = storage[self._cols(idx).to(self.device)]
        # The gathered rows are the chunk's own copy: the chunk itself
        # needs no lock.
        if self.fused_mesh_active:
            if eps is None:
                eps = self._noise(self.b_local, device_fold=self.rank)
            return self._run(packed, eps, kernel=True)
        if eps is None:
            eps = self._noise(self.global_batch)
        return self._run(packed, self._cols(eps),
                         kernel=self.fused_chunk_active if kernel is None else kernel,
                         screen=self._screen(packed, idx))

    def run_sample_chunk_per(self, device_replay, beta: float,
                             idx: Optional[torch.Tensor] = None,
                             weights: Optional[torch.Tensor] = None,
                             eps=None, kernel: Optional[bool] = None) -> StepOutput:
        """K learner steps on minibatches drawn from a DevicePrioritizedReplay
        in proportion to its priorities (the JAX learner's
        run_sample_chunk_per): one [K, B * D] uniform from the learner's
        index generator into draw_per_indices at this `beta` (the same
        draw on every rank), this rank's columns gathered (a copy) with the
        IS weights written into its weight column, the chunk on the
        learner's PER route, the td gathered, then the priorities of the
        drawn rows set to (|td| + eps)^alpha (an index drawn twice takes
        its last value in flat K x B order, scatter_last_wins) and
        max_priority raised to the largest of them, the same on every
        rank. Priorities and max_priority are updated in place, on the
        device and in stream order, with no host read: an insert issued
        after this call returns stamps the new max. `idx` and `weights`
        ([K, B * D], given together) replace the draw, `eps` the noise,
        and `kernel=False` takes the scan route (scan_sample_fn).
        The whole sequence is issued under the replay's dispatch_lock, as
        the JAX learner dispatches it: no insert or stamp falls between
        the draw and the priority write, so a stamp never loses to the
        write of a row it replaced."""
        if (idx is None) != (weights is None):
            raise ValueError("idx and weights replace the PER draw together")
        with device_replay.dispatch_lock:
            storage, size, priorities, max_priority = device_replay.per_state()
            sharded = self._gather_ranks > 1
            if idx is None:
                idx, weights = self._per_draw(priorities, size,
                                              (self.chunk_size, self.global_batch), beta,
                                              generator=self._gen)
            if eps is None:
                eps = self._noise(self.global_batch)
            idx = idx.to(self.device)
            packed = (self._cols(self._gather(device_replay, storage, idx)).contiguous()
                      if sharded else storage[self._cols(idx)])
            # The screen reads the rows as gathered, before the weight column
            # takes the IS weights (JAX :690-699); a bad step's zeroed td
            # stamps its rows at (0 + eps)^alpha below.
            screen = self._screen(packed, idx)
            packed[..., -1] = self._cols(weights).to(self.device, torch.float32)
            out = self._run(packed, self._cols(eps),
                            kernel=self.fused_per_active if kernel is None else kernel,
                            screen=screen)
            new_p = (out.td_errors.abs() + device_replay.eps) ** device_replay.alpha
            if sharded:
                owner_scatter_last_wins(priorities, idx.reshape(-1), new_p.reshape(-1),
                                        self._gather_ranks, self.rank)
            else:
                scatter_last_wins(priorities, idx.reshape(-1), new_p.reshape(-1))
            torch.maximum(max_priority, new_p.max(), out=max_priority)
            return out

    def run_chunk(self, np_batches: Dict[str, np.ndarray]) -> StepOutput:
        """K learner steps on host-fed [K, B * D, ...] stacked minibatches
        (on D > 1 ranks this rank's columns, on the scan route): the JAX
        learner's run_chunk_async(put_chunk(np_batches))."""
        return self.run_chunk_async(self.put_chunk(np_batches))

    def put_chunk(self, np_batches: Dict[str, np.ndarray]) -> "HostChunk":
        """Pack a [K, B, field] dict into the one wire array and start its
        copy to the learner's device (the JAX learner's put_chunk). On the
        card the rows go into a pinned buffer of a pool (transfer/hostbuf.py)
        and are copied with non_blocking=True on the learner's copy stream,
        a side stream, so the copy overlaps a running chunk; the copy's
        event goes into the pool as the buffer's fence (the buffer is not
        handed out again before the copy has read it) and rides along in
        the HostChunk (run_chunk_async makes the chunk's stream wait on it
        before the chunk reads the rows). Callable from any thread (the
        prefetcher's, the transfer scheduler's). On the CPU the packed
        array itself. A `chunk_h2d` span (trace.py)."""
        with trace.span("chunk_h2d"):
            return self._put_chunk(np_batches)

    def _put_chunk(self, np_batches: Dict[str, np.ndarray]) -> "HostChunk":
        packed = pack_batch_np(np_batches)
        if self._copy_stream is None:
            return HostChunk(torch.from_numpy(packed), None)
        k, b, w = packed.shape
        buf = self._chunk_pool.acquire(k * b)
        buf[:] = packed.reshape(k * b, w)
        with torch.cuda.stream(self._copy_stream):
            # Allocated on the copy stream: the chunk's stream records its
            # use (run_chunk_async), so the allocator does not hand the
            # block out again before the chunk has read it.
            rows = torch.from_numpy(buf).to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self._chunk_pool.commit(buf, ready)
        return HostChunk(rows.view(k, b, w), ready)

    def run_chunk_async(self, device_chunk: "HostChunk") -> StepOutput:
        """run_chunk on a chunk put_chunk has placed (from the prefetch
        pipeline); returns without waiting for the chunk, as every dispatch
        does (chunk_done polls its end). The learner's stream waits on the
        copy's event, so the chunk never reads a half-copied chunk. Both
        routes take it: the kernel route on one rank, the scan route (with
        or without K2, guarded or not) everywhere."""
        packed, ready = device_chunk
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            packed.record_stream(stream)
        kernel = self.fused_chunk_active and self.data_size == 1
        packed = self._cols(packed).contiguous()
        return self._run(packed, self._cols(self._noise(self.global_batch)), kernel=kernel,
                         screen=self._screen(packed, None))

    def actor_params_to_host(self) -> np.ndarray:
        """The actor params as one flat f32 vector in the layout of
        actors/policy.flatten_params (per layer w then b, C order; SAC's
        head 2 * act wide), for the broadcast to CPU rollout workers. One
        device->host copy, which waits for the running chunk: a
        `params_d2h` span (trace.py). On a grid with model_axis > 1 the
        logical actor gathered at the last chunk's end (_sync_actor)."""
        actor = self.state.actor_params if self.model_axis == 1 else self._actor_logical
        with trace.span("params_d2h"):
            flat = torch.cat([
                t.reshape(-1) for layer in actor
                for t in (layer["w"], layer["b"])
            ])
            return flat.cpu().numpy()

    def metrics_to_host(self, out: StepOutput) -> Dict[str, float]:
        """The chunk's metrics on the host: one read, which waits for the
        chunk (a `metrics_d2h` span)."""
        with trace.span("metrics_d2h"):
            vals = torch.stack([out.metrics[k] for k in METRIC_KEYS]).cpu().tolist()
        return dict(zip(METRIC_KEYS, vals))


def _to_device(node, device):
    """A TrainState field (params, an OptState, a tensor) on `device`."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, OptState):
        return OptState(*(_to_device(x, device) for x in node))
    return tuple({k: v.to(device) for k, v in layer.items()} for layer in node)


def float_leaves(state: TrainState):
    """Every float leaf of a state: params, targets, both Adam moments, and
    SAC's log_alpha and its Adam moments (counts and step excluded)."""
    out = [t for tree in (state.actor_params, state.critic_params, state.target_actor_params,
                          state.target_critic_params, state.actor_opt.mu, state.actor_opt.nu,
                          state.critic_opt.mu, state.critic_opt.nu)
           for layer in tree for t in (layer["w"], layer["b"])]
    if state.log_alpha is not None:
        out.append(state.log_alpha)
    if state.alpha_opt is not None:
        out += [state.alpha_opt.mu, state.alpha_opt.nu]
    return out


def state_tensors(state: TrainState):
    """Every tensor of a state: its float leaves, then the counts and step."""
    counts = [state.actor_opt.count, state.critic_opt.count, state.step]
    if state.alpha_opt is not None:
        counts.append(state.alpha_opt.count)
    return float_leaves(state) + counts
