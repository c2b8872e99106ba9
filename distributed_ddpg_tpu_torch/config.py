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
fused_update=True, whose steps run the fused Adam + Polyak kernel). Options the port does not implement
yet keep their field and default, and a non-default value raises a
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
    "guardrails": False,
    "serve_actors": False,
    "checkpoint_dir": "",
    "faults": "",
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

    # --- topology ---
    num_actors: int = 1
    # Actor->learner transport. The port has the queue transport only;
    # "auto" resolves to it. The shm ring needs the C++ native core.
    transport: str = "auto"
    # -1: all devices. The port runs one device; more is not in the slice.
    data_axis: int = -1
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

    # --- run control ---
    total_env_steps: int = 100_000
    eval_every: int = 5_000
    eval_episodes: int = 5
    log_path: str = ""               # JSONL metrics path ("" = stdout only)
    heartbeat_timeout_s: float = 30.0
    device: str = "cuda"

    # --- options outside this slice (see _NOT_IN_SLICE) ---
    guardrails: bool = False
    serve_actors: bool = False
    checkpoint_dir: str = ""         # checkpoint and resume come later
    faults: str = ""
    actor_backend: str = "host"
    model_axis: int = 1

    def replace(self, **kwargs) -> "DDPGConfig":
        return dataclasses.replace(self, **kwargs)

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
        if self.transport not in ("auto", "queue"):
            raise ValueError(
                f"transport={self.transport!r} is not implemented in the "
                "PyTorch port yet (the shm ring needs the native C++ core); "
                "use 'queue' or 'auto'"
            )
        if self.data_axis not in (-1, 1):
            raise ValueError(
                f"data_axis={self.data_axis} is not implemented in the "
                "PyTorch port yet: the learner runs on one device"
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
