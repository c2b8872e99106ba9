"""The run configuration of the port: one frozen dataclass, CLI-overridable.

Counterpart of distributed_ddpg_tpu/config.py, trimmed to the fields this
slice reads. Every kept field has the JAX package's name and default, so a
command line written for `python -m distributed_ddpg_tpu.train` means the
same thing here; a flag the port does not know is an argparse error. The
learner chunk is always the hand-written kernel on the card (there is no
scan path, so no `fused_chunk` or `backend` switch). Options the port
does not implement yet keep their field and default, and a non-default
value raises a ValueError naming the option (ROADMAP.md lists the order
they arrive in) — never a silent no-op.

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
    "sac": False,
    "prioritized": False,
    "guardrails": False,
    "fused_update": False,
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

    # --- precision ---
    compute_dtype: str = "float32"

    # --- run control ---
    total_env_steps: int = 100_000
    eval_every: int = 5_000
    eval_episodes: int = 5
    log_path: str = ""               # JSONL metrics path ("" = stdout only)
    heartbeat_timeout_s: float = 30.0
    device: str = "cuda"

    # --- options outside this slice (see _NOT_IN_SLICE) ---
    sac: bool = False
    prioritized: bool = False
    guardrails: bool = False
    fused_update: bool = False
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

    def check_noise(self, eps) -> None:
        """Raises unless eps is given exactly when `takes_noise`."""
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
        if self.compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r} is not implemented in "
                "the PyTorch port yet (only 'float32')"
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
        if self.action_insert_layer != 1:
            raise ValueError(
                f"action_insert_layer={self.action_insert_layer} is not "
                "implemented in the PyTorch port yet (only 1)"
            )
        if self.critic_l2 != 0.0:
            raise ValueError(
                f"critic_l2={self.critic_l2} is not implemented in the "
                "PyTorch port yet (only 0)"
            )
        if self.distributional and not 2 <= self.num_atoms <= 256:
            raise ValueError(
                f"num_atoms={self.num_atoms} is not implemented in the PyTorch "
                "port yet: the learner chunk kernel takes 2 to 256 atoms"
            )
        if len(self.critic_hidden) < 2 or len(self.actor_hidden) < 1:
            raise ValueError(
                "the learner chunk kernel needs >= 2 critic hidden layers "
                "and >= 1 actor hidden layer"
            )
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
        if self.param_refresh_interval_s < 0:
            raise ValueError("param_refresh_interval_s must be >= 0")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0")
