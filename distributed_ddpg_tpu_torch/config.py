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

`device` is the port's own field: "cuda" (default) runs the learner on the
card and raises if none is present; "cpu" runs the plain PyTorch versions
of the kernels, as the tests do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


# Options outside this slice: field -> the value that means "off".
_NOT_IN_SLICE = {
    "serve_actors": False,
    "actor_backend": "host",
    "model_axis": 1,
}


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
    # DevicePrioritizedReplay): priorities (|td| + per_eps)^per_alpha, IS
    # weights annealed from per_beta to per_beta_final over the run.
    prioritized: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_beta_final: float = 1.0
    per_eps: float = 1e-6

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

    # --- topology ---
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
    param_refresh_every: int = 1     # learner steps between actor param refresh
    param_refresh_interval_s: float = 0.1
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

    # --- fault injection (faults.py; the numeric component only) ---
    # e.g. --faults='numeric:grad:nan@500;numeric:replay:inf@42'. "" = none.
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

    # --- options outside this slice (see _NOT_IN_SLICE) ---
    serve_actors: bool = False
    actor_backend: str = "host"
    model_axis: int = 1

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
        return cls(**vars(parser.parse_args(argv)))

    def __post_init__(self):
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
        if self.twin_critic and self.fused_update:
            raise ValueError(
                "twin_critic composes with the stock Adam+Polyak tree update"
                " (delayed via lax.cond), not the fused_update kernel"
            )
        for name, off in _NOT_IN_SLICE.items():
            if getattr(self, name) != off:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not implemented in "
                    f"the PyTorch port yet (only {name}={off!r}); ROADMAP.md "
                    "lists what is left to port"
                )
        # The JAX package also refuses bfloat16 under backend='native' (its
        # numpy learner is the f32 oracle); the port has no backend switch.
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}"
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
        if self.num_actors < 1:
            raise ValueError("num_actors must be >= 1")
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
        if self.checkpoint_keep < 0:
            raise ValueError("checkpoint_keep must be >= 0 (0 = keep all)")
        if self.ckpt_write_retries < 0:
            raise ValueError("ckpt_write_retries must be >= 0")
        if self.ckpt_retry_backoff_s < 0:
            raise ValueError("ckpt_retry_backoff_s must be >= 0")
        # The JAX package's checks of the breaker, the fault plan and the
        # guardrails (its config.py), its `backend` check left out: the port
        # has one backend.
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
            if self.fused_chunk == "on":
                raise ValueError(
                    "guardrails=True forces the XLA scan path (the Pallas "
                    "megakernel has no health-probe slot) — incompatible "
                    "with fused_chunk='on'; use 'auto' (degrades to scan) "
                    "or 'off'"
                )
            if self.data_axis not in (-1, 1):
                raise ValueError(
                    f"guardrails=True with data_axis={self.data_axis} is not in "
                    "this slice of the PyTorch port: the row screen shared "
                    "across ranks comes with ROADMAP.md Queue 1 item 10; run "
                    "the guarded learner on one rank"
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
