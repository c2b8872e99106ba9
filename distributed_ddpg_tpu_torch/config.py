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
from typing import Sequence


# Options outside this slice: field -> the value that means "off".
_NOT_IN_SLICE = {
    "twin_critic": False,
    "distributional": False,
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
    twin_critic: bool = False
    distributional: bool = False
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
            else:
                ftype = {"int": int, "float": float, "str": str}.get(
                    str(field.type), str
                )
                parser.add_argument(f"--{field.name}", type=ftype, default=field.default)
        return cls(**vars(parser.parse_args(argv)))

    def __post_init__(self):
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
