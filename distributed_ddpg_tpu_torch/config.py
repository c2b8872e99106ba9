"""The run configuration of the port: one frozen dataclass, CLI-overridable.

Counterpart of distributed_ddpg_tpu/config.py, trimmed to the fields this
slice reads. Every kept field has the JAX package's name and default, so a
command line written for `python -m distributed_ddpg_tpu.train` means the
same thing here; a flag the port does not know is an argparse error. The
learner runs each chunk on one of two routes, chosen once from the config
(`fused_chunk`, parallel/learner.py): the hand-written chunk kernel for
configs inside its envelope (ops/fused_chunk.supported) whose state fits its
budget (ops/fused_chunk.fits_vmem, the JAX kernel's VMEM gate), or the scan
route, K eager steps, for the rest (critic_l2 > 0, action_insert_layer != 1,
one critic hidden layer, more than 256 atoms, a state over 6 MiB,
fused_update=True, whose steps run the fused Adam + Polyak kernel, and
guardrails=True, whose steps carry the health probe). Options the port
does not implement yet keep their field and default, and a non-default value raises a
ValueError naming the option (ROADMAP.md lists the order they arrive in)
— never a silent no-op.

`backend` is the JAX package's switch: "jax_tpu" (the default) is the
port's trainer on the card, "native" the numpy CPU learner
(native_backend.py, train.train_native), asked for by name and never a
fallback, and "jax_ondevice" the on-device monolith (ondevice.py,
train.train_ondevice: E vectorized envs, the replay ring and the learner
in one loop on the card, E = num_actors).

`actor_backend='device'` runs the rollouts on the card
(actors/device_pool.py: device_actor_envs vectorized envs, K =
device_actor_chunk steps a dispatch, the rows scattered straight into the
device replay); `fused_beat` and `superstep_beats` fuse the loop's
learn, rollout and scatter into one beat (parallel/megastep.py) and B
beats into one dispatch (parallel/superstep.py). They, the monolith and
`guardrails` run on one rank, on D data-parallel ranks and on a (data,
model) grid, as the JAX package runs them on a mesh (the envs shard over
the data ranks, the rows are gathered into JAX's global order).

`serve_actors` serves the host workers' mu(s) from one InferenceServer on
each actor host (serve/; rank 0, or each node's lead on a pod);
`serve_backend='jax'` (the JAX package's flag value) applies the policy
on `device`, and under model_axis > 1 over the server's model group (the
tensor-parallel apply, serve/server.py `mesh=`). `front_port` /
`front_http_port` add the network front (serve/front/). `host_replay`
keeps one host replay and its prefetcher on each actor host, which sends
each chunk to its node's ranks (train.py).

`replay_sharding='sharded'` splits the device replay over the data-parallel
ranks (replay/device.py; the JAX package's checks): the learner takes the
scan route, and every rank writes its slice of the ring at each
checkpoint.

`model_axis` > 1 is tensor parallelism (parallel/partition.py): a
(data, model) grid of D x M ranks, each rank holding its shards of the
params and Adam moments under the Megatron rule tables, with the JAX
package's checks and messages. The learner takes the scan route (K2
under fused_update on each rank's shards).

`sync_ship_background`, `pod_collective_timeout_s` and
`pod_startup_grace_s` are the JAX package's pod fields, with its defaults
and checks: they act on a pod of more than one node
(parallel/multihost.py) and on nothing else.

`device` is the port's own field: "cuda" (default) runs the learner on the
card and raises if none is present; "cpu" runs the plain PyTorch versions
of the kernels, as the tests do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


def resolve_device_actor_chunk(config: "DDPGConfig") -> int:
    """K, the env steps a device-actor rollout dispatch takes:
    config.device_actor_chunk when set, else 64 on the card and 8 on the
    CPU (the JAX package's rule, 64 where its kernels run natively, with
    the card in the TPU's place, as resolve_learner_chunk does)."""
    if config.device_actor_chunk > 0:
        return config.device_actor_chunk
    return 64 if config.device == "cuda" else 8


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Hyperparameters and topology for one training run."""

    # --- environment ---
    env_id: str = "Pendulum-v1"
    seed: int = 0

    # --- networks ---
    actor_hidden: Sequence[int] = (256, 256)
    critic_hidden: Sequence[int] = (256, 256)
    # Classic DDPG injects the action at the second critic layer.
    action_insert_layer: int = 1

    # --- algorithm ---
    gamma: float = 0.99
    tau: float = 1e-3
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    critic_l2: float = 0.0
    batch_size: int = 64
    n_step: int = 1

    # --- distributional critic (D4PG) ---
    distributional: bool = False
    num_atoms: int = 51
    # Value-support bounds. nan = auto (CLI: --v_min=auto --v_max=auto,
    # both together): sized from the warmup replay's reward statistics
    # before the first chunk, then widened when mean_q nears an edge
    # (ops/support_auto.py).
    v_min: float = -150.0
    v_max: float = 150.0

    # --- replay ---
    replay_capacity: int = 1_000_000
    replay_min_size: int = 1_000
    # Proportional prioritized replay on the device (replay/device.py
    # DevicePrioritizedReplay), or with host_replay in the host sum tree
    # (replay/prioritized.py): priorities (|td| + per_eps)^per_alpha, IS
    # weights annealed from per_beta to per_beta_final over the run.
    prioritized: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_beta_final: float = 1.0
    per_eps: float = 1e-6
    # The host replay (replay/uniform.py, replay/prioritized.py, numpy) and
    # the chunk prefetcher (parallel/prefetch.py) in place of the device
    # ring: the path for replays larger than the card's memory. One rank.
    host_replay: bool = False

    # --- exploration ---
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_dt: float = 1.0

    # Device-replay ingest pipeline (replay/device.py). ingest_async ships
    # host->device off the driver's thread (bounded by the 16-block staging
    # ring: a full ring blocks the drain, backpressure), so the insert's
    # copy queues behind the running chunk without holding the driver; on
    # D > 1 ranks it is off (every rank must insert at the same point of
    # its loop). ingest_coalesce caps how many staged blocks fold into one
    # insert (power-of-two groups; 1 = block-at-a-time ships).
    ingest_async: bool = True
    ingest_coalesce: int = 8
    # The transfer scheduler (transfer/scheduler.py): one dispatch thread
    # owns the replay's ingest ships (prioritized work classes, byte-fair
    # between the bulk ones). The two policies below run only with it.
    transfer_scheduler: bool = True
    # The effective coalesce cap grows (x2, up to ingest_coalesce) while
    # the staging queue backs up and shrinks on a dispatch stall
    # (transfer/adaptive.py); replay contents are the same for any cap.
    ingest_coalesce_adaptive: bool = True
    # Pooled staging buffers for the insert's H2D copy
    # (transfer/hostbuf.py): pinned on the card, so the copy is
    # non-blocking; each is fenced on an event after the insert.
    transfer_host_pool: bool = True
    # A pod (more than one node, parallel/multihost.py): run the sync_ship
    # beat that gathers every node's staged rows as a background item on
    # the transfer scheduler's lockstep lane (replay/device.py
    # sync_ship_begin) instead of blocking the training loop at every
    # chunk's end; the loop waits the beat before its next dispatch. No effect
    # on one node.
    sync_ship_background: bool = True

    # --- device actors (actors/device_pool.py) ---
    # "host": num_actors worker processes step CPU envs and ship their rows
    # through the ingest pipeline. "device": device_actor_envs vectorized
    # envs (envs/vector_envs.py) step on the card with the policy and OU
    # noise, device_actor_chunk steps a dispatch, and the rows scatter
    # straight into the device replay (no staging, no transfer item); the
    # host pool can run beside them (num_actors > 0; 0 = device only).
    actor_backend: str = "host"
    device_actor_envs: int = 1024
    # K env steps a rollout dispatch; 0 = auto: 64 on the card, 8 on the
    # CPU (resolve_device_actor_chunk).
    device_actor_chunk: int = 0
    # The fused beat (parallel/megastep.py): the loop's learn (the scan
    # route's sampling chunk), rollout (with the updated actor params) and
    # scatter as one beat, enqueued on one stream with no host read
    # between them. "auto": whenever the device actors feed the device
    # replay, the chunk kernel's route is inactive and both ratio gates
    # are 0; "on": required; "off": the dispatch-per-phase loop.
    fused_beat: str = "auto"
    # B beats a dispatch (parallel/superstep.py), their stats stacked on
    # the device and read once; needs the fused beat.
    superstep_beats: int = 1

    # --- topology ---
    # "jax_tpu": the port's trainer (the JAX package's name for its
    # default); "native": the numpy learner on the CPU; "jax_ondevice":
    # the on-device monolith (ondevice.py), num_actors vectorized envs.
    backend: str = "jax_tpu"
    num_actors: int = 1
    # Actor->learner transport: "shm" = a C++ SPSC ring in shared memory a
    # worker (native/ring.cpp, built with g++ at first use; raises if it
    # cannot be built); "queue" = an mp.Queue a worker; "auto" = shm
    # whenever the ring can be built, else queue (said once on stderr).
    transport: str = "auto"
    # Rows a worker's ring holds: a full ring blocks its worker, as a full
    # queue does.
    shm_ring_rows: int = 4096
    # Data-parallel ranks (parallel/mesh.py): -1 = every rank of the
    # torch.distributed group (one when there is none); any other value
    # must equal the group's size.
    data_axis: int = -1
    # True: batch_size is per rank, the global batch batch_size * D; False:
    # batch_size is the global batch, split over the D ranks.
    scale_batch_with_data: bool = True
    # Ingest rate limiter: drained env steps <= replay_min_size + ratio *
    # learner steps; past it the transports fill and the workers block.
    # 0 = free-running.
    max_ingest_ratio: float = 0.0
    # Learner steps <= replay_min_size + ratio * env steps; 0 = free-running.
    max_learn_ratio: float = 0.0
    train_every: int = 1             # env steps between learner steps (native backend)
    # Lockstep debug mode: the actors run inline on the driver's thread
    # (actors/sync_pool.py) in a fixed round-robin order, the transfer
    # scheduler, the shipper and the adaptive cap are off, and the
    # wall-clock floors on the param refresh and the log are ignored, so
    # two runs of one config give bit-identical records. Needs both ratio
    # gates (the drain budget is the schedule).
    strict_sync: bool = False
    param_refresh_every: int = 1     # learner steps between actor param refresh
    param_refresh_interval_s: float = 0.1
    prefetch_depth: int = 2          # host replay: chunks prefetched ahead of the learner
    # Learner steps per dispatch (one kernel launch). 0 = auto: 800 on the
    # card, 8 on the CPU (parallel/learner.resolve_learner_chunk).
    learner_chunk: int = 0

    # --- TD3 (arXiv 1802.09477) ---
    # twin_critic: a 2-critic ensemble (params stacked on a leading axis)
    # with min-over-ensemble Bellman targets (clipped double-Q).
    twin_critic: bool = False
    # Actor + target nets update once per `policy_delay` critic steps.
    policy_delay: int = 1
    # Target-policy smoothing: clip(N(0, target_noise), +-clip) added to
    # the target action inside the critic target (0 = off).
    target_noise: float = 0.0
    target_noise_clip: float = 0.5

    # --- SAC (arXiv 1801.01290/1812.05905) ---
    # sac: a tanh-Gaussian actor (head [mean | log_std], reparameterized
    # samples, the tanh log-prob correction), twin critics on a leading
    # [2, ...] axis as TD3's, and entropy-regularized targets
    # min_i Q'_i(s', a') - alpha * log pi(a'|s'). Workers explore by
    # sampling the policy (no OU noise); eval acts on tanh(mean).
    sac: bool = False
    # Entropy temperature: with sac_autotune, log(alpha) is learned toward
    # target_entropy (nan = auto = -act_dim + sum(log action_scale)), and
    # sac_alpha is only its initial value.
    sac_alpha: float = 0.2
    sac_autotune: bool = True
    target_entropy: float = float("nan")
    # The Gaussian head's log_std soft clamp.
    sac_log_std_min: float = -5.0
    sac_log_std_max: float = 2.0
    # Uniform-random actions for the first N env steps (SAC's start_steps),
    # split evenly across the actor processes. -1 = auto (replay_min_size
    # under SAC, else 0); 0 = off.
    warmup_uniform_steps: int = -1

    # --- precision ---
    # "bfloat16": every matrix product takes bf16-rounded operands and
    # accumulates in f32; params, Adam state, targets and activations stay
    # f32 (models/mlp.py, ops/fused_chunk.py).
    compute_dtype: str = "float32"
    # Adam + Polyak of each step in one fused kernel (ops/fused_update.py);
    # DDPG and D4PG only, on the scan route.
    fused_update: bool = False
    # The learner chunk kernel: "auto" runs it whenever the config is in
    # its envelope (ops/fused_chunk.supported and fits_vmem), else the scan
    # route; "on" requires it (error outside); "off" always takes the scan.
    fused_chunk: str = "auto"
    # On D > 1 ranks, "auto" runs the chunk kernel on each rank's own draws
    # and averages the float state at the chunk's end (K-step local SGD,
    # the mesh launch); "off" takes the scan route with a gradient
    # all-reduce every step.
    fused_mesh: str = "auto"

    # --- run control ---
    total_env_steps: int = 100_000
    eval_every: int = 5_000
    eval_episodes: int = 5
    log_path: str = ""               # JSONL metrics path ("" = stdout only)
    heartbeat_timeout_s: float = 30.0
    device: str = "cuda"

    # --- operations (trace.py, watchdog.py, obs/, metrics.py) ---
    # Stall watchdog: no trainer progress for this many seconds (a wait on
    # the card that never returns, a wedged driver) dumps every thread's
    # stack, writes stall_report.json and stall_trace.json, and exits 70.
    # 0 = off; unattended runs should set ~300.
    watchdog_s: float = 0.0
    tb_dir: str = ""                 # TensorBoard summary dir ("" = off)
    # torch.profiler trace of the training loop, CPU and CUDA activities,
    # exported as a Chrome trace into this dir ("" = off). It holds every
    # event in memory: keep such runs short.
    profile_dir: str = ""
    # Flight recorder: thread-tagged spans of the trainer's threads and
    # actor processes in a preallocated ring, written as Perfetto-loadable
    # Chrome trace JSON here on a clean exit (trace.json, and
    # trace_actor<k>.json a worker), on SIGUSR2, and from the watchdog's
    # stall path. "" = off (each span is a shared no-op).
    trace_dir: str = ""
    trace_events: int = 65_536       # the ring's capacity in events
    # Pod deadlines (parallel/multihost.py), on more than one node only:
    # every pod collective (the sync_ship beat, the env-step gather, the
    # resume election) must finish within this many seconds, else the
    # survivors abort cleanly with exit 76 (PodPeerLost) instead of
    # blocking on a dead or hung peer. The first chunk's kernel build and
    # a support expansion are granted pod_startup_grace_s more. Keep it
    # well under watchdog_s where both are set: peer loss should exit 76,
    # not 70. 0 = off (block for the process group's own timeout).
    pod_collective_timeout_s: float = 60.0
    # The one-time startup barrier's grace (multihost.startup_barrier),
    # much larger than the steady deadline: process start-up skew under
    # load is absorbed once here, not read as a dead peer by a beat.
    pod_startup_grace_s: float = 300.0
    # The telemetry ingress: one stdlib HTTP thread on this port serving
    # /metrics (Prometheus text of the latest record of each kind),
    # /healthz (healthy / degraded / draining) and /trace. Read-only, no
    # auth, binds all interfaces: private networks only. 0 = off.
    obs_port: int = 0
    # Sleep before each actor env step (wall clock only; the grad steps a
    # env step are unchanged): slows env production so the learner can
    # meet the ratio caps. 0 = off.
    actor_throttle_s: float = 0.0
    # Respawn a worker that heartbeats but has delivered no experience rows
    # for this many seconds (the pool's `no_rows`). 0 = off.
    actor_no_progress_s: float = 0.0

    # --- the actor pool's breaker (actors/pool.py) ---
    # Respawn backoff: the k-th recent failure of one worker slot waits
    # min(base * 2^(k-1), max) seconds before its respawn.
    respawn_backoff_s: float = 0.5
    respawn_backoff_max_s: float = 30.0
    # Crash-loop breaker: this many failures of one slot within
    # quarantine_window_s quarantine it (no more respawns; training goes on
    # with the other workers). 0 = breaker off.
    quarantine_respawns: int = 5
    quarantine_window_s: float = 60.0
    # After this cooldown a quarantined slot is probed with one respawn:
    # rows delivered and quarantine_window_s survived un-quarantine it, a
    # failure re-quarantines it. 0 = never probe.
    quarantine_probe_s: float = 300.0

    # --- fault injection (faults.py) ---
    # A deterministic schedule, e.g.
    # --faults='worker:1:crash@500;ckpt:write:ioerror@2;numeric:grad:nan@500'.
    # The old one-shot --inject_fault's 'actor:<id>:<step>' form still
    # parses, as a worker crash. "" = none.
    faults: str = ""

    # --- numerical-health guardrails (guardrails.py) ---
    # Finite checks on td, losses, grad norms and the updated params, and
    # EWMA z-scores on the critic loss and grad norm, in every learner step
    # on the device; a bad step's update is dropped, non-finite sampled
    # rows are traced to the actor that produced them, and sustained
    # divergence rolls the run back to the last valid checkpoint. Forces
    # the scan route (the chunk kernel has no probe slot; 'auto' degrades
    # to the scan, 'on' raises) and one health-word read a chunk.
    guardrails: bool = False
    # One-sided z-score threshold of the loss / grad-norm detector.
    guardrail_zmax: float = 8.0
    # Clean steps the EWMA absorbs before the z-scores arm (the finite
    # checks are armed from step 1).
    guardrail_warmup_steps: int = 64
    # Rollback trigger: this many anomalous learner steps within
    # guardrail_rollback_window steps restore the last valid checkpoint.
    # 0 = detect, skip and quarantine only.
    guardrail_rollback_k: int = 8
    guardrail_rollback_window: int = 256
    # A run that needs more rollbacks than this (or one with nothing to
    # restore) exits EXIT_NUMERIC (77).
    guardrail_max_rollbacks: int = 3
    # After a rollback both learning rates scale by this factor until
    # guardrail_lr_cooldown_steps clean steps pass. 1.0 = off.
    guardrail_lr_backoff: float = 0.5
    guardrail_lr_cooldown_steps: int = 2000
    # This many non-finite replay rows traced to one actor slot quarantine
    # it through the pool's breaker. 0 = off.
    guardrail_source_offenses: int = 3

    # --- checkpoint and resume (checkpoint.py) ---
    # Every checkpoint_every learner steps rank 0 snapshots the state, the
    # replay, the env-step count and the resolved C51 bounds, and a
    # background thread writes them to checkpoint_dir/step_<N> ("" = off).
    checkpoint_every: int = 10_000
    checkpoint_dir: str = ""
    # Latest-N retention (0 = keep all).
    checkpoint_keep: int = 3
    resume: bool = True              # restore the newest valid checkpoint
    # A write that fails with an OSError is retried this many times, with
    # exponential backoff from ckpt_retry_backoff_s.
    ckpt_write_retries: int = 2
    ckpt_retry_backoff_s: float = 0.5

    # --- batched policy serving (serve/) ---
    # serve_actors: the host workers ask one InferenceServer in the learner
    # process for mu(s) over a bounded mp queue; a dynamic batcher
    # dispatches at serve_max_batch rows or once the oldest request has
    # waited serve_max_latency_ms, whichever comes first. A worker that
    # cannot get a served action (overload, stall, a failed dispatch) acts
    # on its local policy mirror for serve_fallback_s instead of blocking.
    serve_actors: bool = False
    serve_max_batch: int = 32
    serve_max_latency_ms: float = 5.0
    # Bounded request queue: submissions past it raise typed ServeOverload.
    serve_queue: int = 1024
    # A worker waits this long for a served action before its local act().
    serve_timeout_s: float = 1.0
    # ...and stays on the local path this long before asking again.
    serve_fallback_s: float = 5.0
    # "numpy": row-wise NumpyPolicy, bit-identical to the workers' act();
    # "jax" (the JAX package's name): the device apply on `device`, params
    # resident there, batches padded to (serve_max_batch, obs_dim).
    serve_backend: str = "numpy"

    # --- the network serving front (serve/front/) ---
    # Framed-TCP and HTTP/JSON ingress over the same batcher, versioned
    # policy snapshots with canary promote, per-tenant QoS. 0 = off; any
    # other value binds that port on localhost.
    front_port: int = 0
    front_http_port: int = 0
    # A request older than this when its batch completes gets a typed
    # `timeout` answer.
    front_timeout_s: float = 2.0
    # Share of traffic the canary split routes to a staged candidate
    # (crc32(tenant:request_id) buckets: replayable, not random).
    front_canary_fraction: float = 0.1
    # Latency samples BOTH arms need before the gate may promote.
    front_canary_min_requests: int = 50
    # Allowed relative p95 regression of the candidate against stable.
    front_canary_threshold: float = 0.5
    # "name:priority[:rate[:burst]];...": priority 0 is highest (never
    # depth-shed), rate in tokens/s (0 = uncapped), burst defaults to
    # max(1, rate). Unknown tenants get front_default_priority.
    front_tenants: str = ""
    front_default_priority: int = 1
    # Queue-depth share where the lowest priority class starts to shed.
    front_shed_start: float = 0.5

    # --- tensor parallelism (parallel/partition.py) and the sharded
    # device replay (replay/device.py) ---
    model_axis: int = 1
    replay_sharding: str = "replicated"

    def replace(self, **kwargs) -> "DDPGConfig":
        return dataclasses.replace(self, **kwargs)

    def fault_plan(self):
        """The parsed --faults schedule (faults.FaultPlan)."""
        from distributed_ddpg_tpu_torch.faults import FaultPlan

        return FaultPlan.parse(self.faults, seed=self.seed)

    @property
    def takes_noise(self) -> bool:
        """TD3 target smoothing is on: the learner step and chunk then take
        the clipped noise eps as an input (ops/fused_chunk.td3_noise_eps),
        and only then."""
        return bool(self.twin_critic) and self.target_noise > 0.0

    @property
    def v_support_auto(self) -> bool:
        """The C51 support is auto-sized (v_min/v_max = nan): concrete
        bounds must be resolved (ops/support_auto.initial_bounds) before
        the first learner step."""
        return math.isnan(self.v_min)

    def resolved_warmup_uniform(self) -> int:
        """Global uniform-warmup env-step budget (warmup_uniform_steps: -1 =
        auto = replay_min_size under SAC, 0 otherwise)."""
        if self.warmup_uniform_steps >= 0:
            return self.warmup_uniform_steps
        return self.replay_min_size if self.sac else 0

    def check_noise(self, eps) -> None:
        """Raises unless eps is given exactly when `takes_noise`; under SAC
        eps must be the pair (eps_next, eps_cur) of standard normals."""
        if self.sac:
            if not (isinstance(eps, (tuple, list)) and len(eps) == 2):
                raise ValueError(
                    "eps must be the SAC normals (eps_next, eps_cur) under sac=True "
                    "(ops/fused_chunk.sac_noise_eps)")
            return
        if self.takes_noise != (eps is not None):
            raise ValueError(
                "eps (TD3 smoothing noise) is required exactly when "
                f"twin_critic and target_noise > 0 (twin_critic={self.twin_critic}, "
                f"target_noise={self.target_noise})"
            )

    @classmethod
    def from_flags(cls, argv: Sequence[str]) -> "DDPGConfig":
        """Parse `--key=value` / `--key value` CLI overrides onto the defaults."""
        import argparse

        parser = argparse.ArgumentParser(prog="distributed_ddpg_tpu_torch")
        for field in dataclasses.fields(cls):
            if field.type in ("bool", bool):
                parser.add_argument(
                    f"--{field.name}",
                    type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=field.default,
                )
            elif field.name in ("actor_hidden", "critic_hidden"):
                parser.add_argument(
                    f"--{field.name}",
                    type=lambda s: tuple(int(x) for x in s.split(",")),
                    default=field.default,
                )
            elif field.name in ("v_min", "v_max"):
                parser.add_argument(
                    f"--{field.name}",
                    type=lambda s: float("nan") if s == "auto" else float(s),
                    default=field.default,
                )
            else:
                ftype = {"int": int, "float": float, "str": str}.get(
                    str(field.type), str
                )
                parser.add_argument(f"--{field.name}", type=ftype, default=field.default)
        # The JAX package's deprecated alias: --inject_fault's
        # 'actor:<id>:<step>' one-shot crash folds into the --faults plan.
        parser.add_argument("--inject_fault", type=str, default="")
        args = vars(parser.parse_args(argv))
        legacy = args.pop("inject_fault")
        if legacy:
            args["faults"] = ";".join(filter(None, [args["faults"], legacy]))
        return cls(**args)

    def _check_model_axis(self) -> None:
        """The JAX package's tensor-parallel checks and messages (its
        config.py)."""
        if self.model_axis < 1:
            raise ValueError(
                f"model_axis must be >= 1, got {self.model_axis} (1 = "
                "data-parallel only)"
            )
        if self.model_axis > 1:
            if self.backend == "native":
                raise ValueError(
                    "model_axis > 1 shards params over a jax mesh; the "
                    "native numpy backend has no mesh — use "
                    "backend='jax_tpu' (or 'jax_ondevice'), or set "
                    "model_axis=1"
                )
            if self.fused_chunk == "on":
                raise ValueError(
                    "model_axis > 1 shards the param tensors the Pallas "
                    "megakernel needs VMEM-whole — incompatible with "
                    "fused_chunk='on'; use fused_chunk='auto' (degrades "
                    "to the XLA scan path) or 'off', or set model_axis=1"
                )
            for knob in ("actor_hidden", "critic_hidden"):
                bad = [
                    d for d in getattr(self, knob)
                    if d % self.model_axis != 0
                ]
                if bad:
                    raise ValueError(
                        f"model_axis={self.model_axis} cannot shard "
                        f"{knob}={tuple(getattr(self, knob))}: hidden "
                        f"dim(s) {bad} do not divide the model axis, so "
                        "every layer would silently replicate and TP "
                        f"would buy nothing — pick {knob} dims divisible "
                        f"by {self.model_axis}, or lower model_axis"
                    )

    def __post_init__(self):
        # The JAX package's backend gate and message (its config.py).
        if self.backend not in ("native", "jax_tpu", "jax_ondevice"):
            raise ValueError(
                "backend must be 'native', 'jax_tpu', or 'jax_ondevice', "
                f"got {self.backend!r}"
            )
        self._check_model_axis()
        # The JAX package's TD3 gates and messages (its config.py), checked
        # before the slice's own so a TD3 misconfiguration reads the same.
        if self.policy_delay < 1:
            raise ValueError("policy_delay must be >= 1")
        if self.target_noise < 0 or self.target_noise_clip < 0:
            raise ValueError("target_noise/target_noise_clip must be >= 0")
        if not self.twin_critic and (
            self.policy_delay > 1 or self.target_noise > 0
        ):
            raise ValueError(
                "policy_delay/target_noise are TD3 knobs consumed only by "
                "the twin-critic step — set twin_critic=True or they would "
                "silently do nothing"
            )
        v_min_auto, v_max_auto = math.isnan(self.v_min), math.isnan(self.v_max)
        if v_min_auto != v_max_auto:
            raise ValueError(
                "v_min/v_max auto-sizing derives BOTH bounds from the same "
                "warmup statistics — set both to 'auto' or neither"
            )
        if v_min_auto and not self.distributional:
            raise ValueError(
                "v_min/v_max='auto' sizes the distributional critic's "
                "support; it requires distributional=True"
            )
        if v_min_auto and not 0.0 < self.gamma < 1.0:
            raise ValueError(
                f"v_min/v_max='auto' needs 0 < gamma < 1 (got {self.gamma}): "
                "the sizing bound r/(1-gamma^n) blows up at gamma=1, and 51 "
                "atoms over a near-infinite range cannot resolve real "
                "returns — pass concrete bounds for undiscounted setups"
            )
        if v_min_auto and self.backend == "jax_ondevice":
            raise ValueError(
                "v_min/v_max='auto' sizes the support from host-visible "
                "warmup replay rewards; the fused on-device backend has no "
                "such window — pass concrete bounds"
            )
        if not v_min_auto and self.distributional and self.v_min >= self.v_max:
            raise ValueError(
                f"v_min ({self.v_min}) must be < v_max ({self.v_max})"
            )
        if self.twin_critic and self.distributional:
            raise ValueError(
                "twin_critic (TD3) and distributional (D4PG) are separate "
                "algorithm families; enable one"
            )
        if self.sac and (self.twin_critic or self.distributional):
            raise ValueError(
                "sac is its own algorithm family (it builds its twin-critic "
                "ensemble internally); disable twin_critic/distributional"
            )
        if self.sac and self.fused_update:
            raise ValueError(
                "sac composes with the stock Adam+Polyak tree update (the "
                "alpha scalar rides the same path), not the fused_update "
                "kernel"
            )
        if self.sac_alpha <= 0:
            raise ValueError("sac_alpha must be > 0 (it is exp(log_alpha))")
        if self.sac_log_std_min >= self.sac_log_std_max:
            raise ValueError("sac_log_std_min must be < sac_log_std_max")
        if self.sac and self.backend == "native":
            raise ValueError(
                "sac requires a JAX backend: the native numpy learner is "
                "the plain-DDPG bit-comparability oracle"
            )
        if self.twin_critic and self.fused_update:
            raise ValueError(
                "twin_critic composes with the stock Adam+Polyak tree update"
                " (delayed via lax.cond), not the fused_update kernel"
            )
        if self.twin_critic and self.backend == "native":
            raise ValueError(
                "twin_critic requires a JAX backend: the native numpy "
                "learner is the plain-DDPG bit-comparability oracle"
            )
        # The JAX package's replay_sharding checks and messages (its
        # config.py:648-700).
        if self.replay_sharding not in ("replicated", "sharded"):
            raise ValueError(
                f"replay_sharding must be 'replicated' or 'sharded', got "
                f"{self.replay_sharding!r}"
            )
        if self.replay_sharding == "sharded":
            if self.backend != "jax_tpu":
                raise ValueError(
                    "replay_sharding='sharded' partitions the DeviceReplay "
                    "HBM ring over the jax_tpu mesh; the native/ondevice "
                    "backends have no sharded ring"
                )
            if self.host_replay:
                raise ValueError(
                    "replay_sharding='sharded' shards the DEVICE replay; "
                    "host_replay has no device ring to shard — disable one"
                )
            if self.fused_chunk == "on":
                raise ValueError(
                    "replay_sharding='sharded' forces the XLA scan path "
                    "(the Pallas megakernel reads replicated storage "
                    "whole) — incompatible with fused_chunk='on'; use "
                    "'auto' (degrades to scan) or 'off'"
                )
            if self.data_axis > 0:
                # The replay checks the alignment again with the group's
                # real size; an explicit data_axis fails here first.
                if self.replay_capacity % self.data_axis:
                    raise ValueError(
                        f"replay_capacity {self.replay_capacity} must "
                        f"divide evenly over data_axis={self.data_axis} "
                        "shards (replay_sharding='sharded')"
                    )
                if self.actor_backend == "device":
                    rows = self.device_actor_envs * resolve_device_actor_chunk(self)
                    if rows % self.data_axis:
                        raise ValueError(
                            f"one device-actor chunk produces {rows} rows, "
                            f"which do not divide over data_axis="
                            f"{self.data_axis} replay shards — sharded "
                            "mode requires every insert_device_rows "
                            "scatter to move a multiple of the shard "
                            "count (keeps the ring pointer shard-aligned)."
                            " Adjust device_actor_envs/device_actor_chunk"
                        )
        # The JAX package's strict_sync checks and messages (its config.py).
        if self.strict_sync:
            if self.backend != "jax_tpu":
                raise ValueError(
                    "strict_sync is a train_jax (jax_tpu backend) debug "
                    "mode; the native backend is already single-threaded "
                    "and deterministic, and the fused on-device backend "
                    "has no host actor loop to make lockstep"
                )
            if self.max_learn_ratio <= 0 or self.max_ingest_ratio <= 0:
                raise ValueError(
                    "strict_sync derives its deterministic ingest schedule "
                    "from the ratio gates; set max_learn_ratio and "
                    "max_ingest_ratio (1.0 each = the reference's "
                    "synchronous 1:1 schedule)"
                )
            if self.host_replay:
                raise ValueError(
                    "strict_sync requires the device replay path: the host "
                    "prefetch thread samples concurrently with ingest, "
                    "which is exactly the nondeterminism this mode removes"
                )
        # The JAX package's serve and front checks and messages (its
        # config.py), then the slice's refusal of serving on D > 1 ranks.
        if self.serve_max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        if self.serve_max_latency_ms < 0:
            raise ValueError("serve_max_latency_ms must be >= 0")
        if self.serve_queue < 1:
            raise ValueError("serve_queue must be >= 1")
        if self.serve_timeout_s <= 0:
            raise ValueError("serve_timeout_s must be > 0")
        if self.serve_fallback_s < 0:
            raise ValueError("serve_fallback_s must be >= 0")
        if self.serve_backend not in ("numpy", "jax"):
            raise ValueError(
                f"serve_backend must be 'numpy' or 'jax', got "
                f"{self.serve_backend!r}"
            )
        if self.serve_actors:
            if self.backend != "jax_tpu":
                raise ValueError(
                    "serve_actors serves the actor POOL (jax_tpu backend); "
                    "the native/ondevice backends have no worker fleet to "
                    "serve"
                )
            if self.strict_sync:
                raise ValueError(
                    "serve_actors is incompatible with strict_sync: batch "
                    "composition and dispatch timing are wall-clock-driven, "
                    "which breaks the bit-identical-two-runs contract"
                )
        if self.front_port < 0 or self.front_port > 65535:
            raise ValueError("front_port must be in [0, 65535] (0 = off)")
        if self.front_http_port < 0 or self.front_http_port > 65535:
            raise ValueError(
                "front_http_port must be in [0, 65535] (0 = off)"
            )
        if (
            self.front_port
            and self.front_http_port
            and self.front_port == self.front_http_port
        ):
            raise ValueError(
                "front_port and front_http_port must differ: the frame "
                "server and the HTTP adapter each bind their own socket"
            )
        if self.front_timeout_s <= 0:
            raise ValueError("front_timeout_s must be > 0")
        if not 0.0 < self.front_canary_fraction < 1.0:
            raise ValueError(
                "front_canary_fraction must be in (0, 1): 0 would starve "
                "the candidate of gate samples forever, 1 would route ALL "
                "traffic through an unproven version"
            )
        if self.front_canary_min_requests < 1:
            raise ValueError("front_canary_min_requests must be >= 1")
        if self.front_canary_threshold <= 0:
            raise ValueError("front_canary_threshold must be > 0")
        if self.front_default_priority < 0:
            raise ValueError("front_default_priority must be >= 0")
        if not 0.0 < self.front_shed_start <= 1.0:
            raise ValueError("front_shed_start must be in (0, 1]")
        if self.front_tenants:
            # Fail at parse, not at the first shed.
            from distributed_ddpg_tpu_torch.serve.front.qos import parse_tenants

            parse_tenants(self.front_tenants)
        if (self.front_port or self.front_http_port) and not self.serve_actors:
            raise ValueError(
                "the network front rides the serve subsystem's "
                "InferenceServer: set serve_actors=True (docs/SERVING.md "
                "'Network front')"
            )
        # The JAX package's device-actor, fused-beat and superstep checks
        # and messages (its config.py), before the slice's own refusals.
        if self.actor_backend not in ("host", "device"):
            raise ValueError(
                f"actor_backend must be 'host' or 'device', got "
                f"{self.actor_backend!r}"
            )
        if self.device_actor_envs < 1:
            raise ValueError("device_actor_envs must be >= 1")
        if self.device_actor_chunk < 0:
            raise ValueError("device_actor_chunk must be >= 0 (0 = auto)")
        if self.num_actors < 0 or (
            self.num_actors == 0 and self.actor_backend != "device"
        ):
            raise ValueError(
                "num_actors must be >= 1 (0 is allowed only with "
                "actor_backend='device', where the on-device rollout loop "
                "is the experience source and the host pool runs empty)"
            )
        if self.actor_backend == "device":
            if self.backend != "jax_tpu":
                raise ValueError(
                    "actor_backend='device' runs the vectorized rollout "
                    "loop inside the jax_tpu trainer; the native backend "
                    "has no device, and jax_ondevice already fuses its "
                    "envs into the learner monolith — use backend='jax_tpu'"
                )
            # Lazy: the env table imports torch, which parsing the default
            # (host) config does not need.
            from distributed_ddpg_tpu_torch.envs.vector_envs import (
                _VECTOR_ENVS,
                has_vector_env,
            )

            if not has_vector_env(self.env_id):
                raise ValueError(
                    f"actor_backend='device' needs an on-device (JAX) "
                    f"implementation of {self.env_id!r}; available: "
                    f"{sorted(set(_VECTOR_ENVS))} — keep actor_backend='host' "
                    "for Gym/Mujoco envs (docs/DEVICE_ACTORS.md)"
                )
            if self.serve_actors:
                raise ValueError(
                    "serve_actors batches host workers' act() requests; "
                    "device actors never call act() on the host — mu(s) "
                    "runs inside the rollout program. Disable serve_actors "
                    "(or serve a host pool alongside via actor_backend="
                    "'host')"
                )
            if self.n_step != 1:
                raise ValueError(
                    "actor_backend='device' stores 1-step transitions "
                    "(the n-step window is a host-side accumulator, "
                    "replay/nstep.py); use the host pool for n_step > 1"
                )
            if self.host_replay:
                raise ValueError(
                    "actor_backend='device' scatters rollout rows "
                    "directly into DeviceReplay's HBM ring; host_replay "
                    "has no device ring to insert into — disable one"
                )
            if self.strict_sync:
                raise ValueError(
                    "strict_sync's lockstep schedule is defined over the "
                    "host pool's deterministic drain budget; device-actor "
                    "chunks dispatch outside it — use actor_backend='host' "
                    "for lockstep debugging"
                )
            rows = self.device_actor_envs * resolve_device_actor_chunk(self)
            if rows > self.replay_capacity:
                raise ValueError(
                    f"one device-actor chunk produces {rows} rows "
                    f"(device_actor_envs={self.device_actor_envs} x "
                    f"chunk {resolve_device_actor_chunk(self)}) — more "
                    f"than replay_capacity={self.replay_capacity}: the "
                    "scatter insert would write duplicate ring positions "
                    "in unspecified order. Shrink the chunk/env count or "
                    "grow the replay"
                )
        if self.fused_beat not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_beat must be 'auto', 'on', or 'off', got "
                f"{self.fused_beat!r}"
            )
        if self.fused_beat == "on":
            if self.backend != "jax_tpu":
                raise ValueError(
                    "fused_beat='on' fuses the jax_tpu training loop; the "
                    "native backend has no device programs and "
                    "jax_ondevice is already a fused monolith (ondevice.py)"
                )
            if self.actor_backend != "device":
                raise ValueError(
                    "fused_beat='on' needs the on-device rollout leg "
                    "(actor_backend='device'): host actor processes step "
                    "envs outside XLA and cannot be compiled into the "
                    "beat — use the dispatch-per-phase loop for host "
                    "actors"
                )
            if self.fused_chunk == "on":
                raise ValueError(
                    "fused_beat='on' composes the XLA scan sampling chunk "
                    "(the Pallas megakernel has no rollout/probe slot "
                    "inside a larger traced program) — incompatible with "
                    "fused_chunk='on'; use 'auto' or 'off'"
                )
            if self.max_ingest_ratio > 0.0 or self.max_learn_ratio > 0.0:
                raise ValueError(
                    "fused_beat='on' fixes the rollout:learn ratio inside "
                    "one program (device_actor_envs x chunk rows per "
                    "learner_chunk steps, every beat); the "
                    "max_ingest_ratio/max_learn_ratio gates need "
                    "independently dispatchable phases to throttle — "
                    "disable the gates or use fused_beat='auto'/'off'"
                )
        if self.superstep_beats < 1:
            raise ValueError(
                f"superstep_beats must be >= 1, got {self.superstep_beats}"
            )
        if self.superstep_beats > 1 and self.fused_beat == "off":
            raise ValueError(
                "superstep_beats > 1 composes B FUSED beats into one "
                "lax.fori_loop program (parallel/superstep.py) — it has "
                "no unfused dispatch to wrap; use fused_beat='auto'/'on' "
                "or superstep_beats=1"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}"
            )
        if self.compute_dtype == "bfloat16" and self.backend == "native":
            raise ValueError(
                "compute_dtype='bfloat16' requires a JAX backend: the "
                "native numpy learner is the f32 bit-comparability oracle"
            )
        if self.transport not in ("auto", "shm", "queue"):
            raise ValueError(
                f"transport must be 'auto', 'shm', or 'queue', got "
                f"{self.transport!r}"
            )
        if self.shm_ring_rows < 1:
            raise ValueError("shm_ring_rows must be >= 1")
        if self.ingest_coalesce < 1:
            raise ValueError("ingest_coalesce must be >= 1")
        if self.max_ingest_ratio < 0:
            raise ValueError("max_ingest_ratio must be >= 0 (0 = unlimited)")
        if (
            self.max_learn_ratio > 0
            and self.max_ingest_ratio > 0
            and self.max_learn_ratio * self.max_ingest_ratio < 1.0
        ):
            raise ValueError(
                "max_learn_ratio * max_ingest_ratio < 1 livelocks: each "
                "counter waits on the other and neither allowance can ever "
                "open. With product >= 1 (e.g. both 1.0 — the equal-return "
                "gate pinning ~1 grad step per env step from BOTH sides) "
                "the two advance together at the slower side's pace."
            )
        if self.data_axis == 0 or self.data_axis < -1:
            raise ValueError(
                f"data_axis must be -1 (every rank) or >= 1, got {self.data_axis}"
            )
        if self.fused_mesh not in ("auto", "off"):
            raise ValueError(
                f"fused_mesh must be 'auto' or 'off', got {self.fused_mesh!r}"
            )
        if self.fused_chunk not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_chunk must be 'auto', 'on', or 'off', got "
                f"{self.fused_chunk!r}"
            )
        if not 0 <= self.action_insert_layer <= len(self.critic_hidden):
            raise ValueError(
                f"action_insert_layer={self.action_insert_layer} out of range "
                f"for critic with {len(self.critic_hidden) + 1} layers"
            )
        if self.distributional and self.num_atoms < 2:
            raise ValueError(f"num_atoms must be >= 2, got {self.num_atoms}")
        if len(self.actor_hidden) < 1:
            raise ValueError("the actor needs >= 1 hidden layer")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.n_step < 1:
            raise ValueError("n_step must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.learner_chunk < 0:
            raise ValueError("learner_chunk must be >= 0 (0 = auto)")
        if self.max_learn_ratio < 0:
            raise ValueError("max_learn_ratio must be >= 0 (0 = unlimited)")
        if self.warmup_uniform_steps < -1:
            raise ValueError(
                "warmup_uniform_steps must be >= -1 (-1 = auto, 0 = off)"
            )
        if self.param_refresh_interval_s < 0:
            raise ValueError("param_refresh_interval_s must be >= 0")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0")
        if self.actor_throttle_s < 0:
            raise ValueError("actor_throttle_s must be >= 0 (0 = off)")
        if self.actor_no_progress_s < 0:
            raise ValueError("actor_no_progress_s must be >= 0 (0 = off)")
        if self.pod_collective_timeout_s < 0:
            raise ValueError("pod_collective_timeout_s must be >= 0 (0 = off)")
        if self.pod_startup_grace_s < 0:
            raise ValueError("pod_startup_grace_s must be >= 0")
        if self.trace_events < 16:
            raise ValueError("trace_events must be >= 16")
        if not 0 <= self.obs_port < 65536:
            raise ValueError(
                f"obs_port must be 0 (off) or a valid TCP port, "
                f"got {self.obs_port}"
            )
        if self.checkpoint_keep < 0:
            raise ValueError("checkpoint_keep must be >= 0 (0 = keep all)")
        if self.ckpt_write_retries < 0:
            raise ValueError("ckpt_write_retries must be >= 0")
        if self.ckpt_retry_backoff_s < 0:
            raise ValueError("ckpt_retry_backoff_s must be >= 0")
        if self.train_every < 1:
            raise ValueError("train_every must be >= 1")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        # The JAX package's checks of the breaker, the fault plan and the
        # guardrails (its config.py).
        self.fault_plan()
        if self.respawn_backoff_s < 0 or self.respawn_backoff_max_s < 0:
            raise ValueError("respawn backoff values must be >= 0")
        if self.quarantine_respawns < 0:
            raise ValueError("quarantine_respawns must be >= 0 (0 = off)")
        if self.quarantine_window_s <= 0:
            raise ValueError("quarantine_window_s must be > 0")
        if self.quarantine_probe_s < 0:
            raise ValueError("quarantine_probe_s must be >= 0 (0 = off)")
        if self.guardrails:
            if self.backend != "jax_tpu":
                raise ValueError(
                    "guardrails instrument the sharded-learner chunk "
                    "programs (jax_tpu backend); the native/ondevice "
                    "backends have no probe slot"
                )
            if self.fused_chunk == "on":
                raise ValueError(
                    "guardrails=True forces the XLA scan path (the Pallas "
                    "megakernel has no health-probe slot) — incompatible "
                    "with fused_chunk='on'; use 'auto' (degrades to scan) "
                    "or 'off'"
                )
        if self.guardrail_zmax <= 0:
            raise ValueError("guardrail_zmax must be > 0")
        if self.guardrail_warmup_steps < 1:
            raise ValueError("guardrail_warmup_steps must be >= 1")
        if self.guardrail_rollback_k < 0:
            raise ValueError(
                "guardrail_rollback_k must be >= 0 (0 = never roll back)"
            )
        if self.guardrail_rollback_window < 1:
            raise ValueError("guardrail_rollback_window must be >= 1")
        if self.guardrail_max_rollbacks < 0:
            raise ValueError("guardrail_max_rollbacks must be >= 0")
        if not 0.0 < self.guardrail_lr_backoff <= 1.0:
            raise ValueError(
                "guardrail_lr_backoff must be in (0, 1] (1.0 = off)"
            )
        if self.guardrail_lr_cooldown_steps < 1:
            raise ValueError("guardrail_lr_cooldown_steps must be >= 1")
        if self.guardrail_source_offenses < 0:
            raise ValueError(
                "guardrail_source_offenses must be >= 0 (0 = off)"
            )
