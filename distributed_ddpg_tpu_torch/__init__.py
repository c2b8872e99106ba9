"""distributed_ddpg_tpu_torch — the PyTorch/CUDA port of distributed_ddpg_tpu.

The JAX package beside it stays the reference. This package mirrors its
module paths (types, config, models/mlp, ops/*, learner, replay/*,
parallel/learner, envs/*, actors/*, train) and imports nothing of it: where
it needs a JAX-free module of the old package it keeps its own trimmed copy.

The slices ported so far are the DDPG, TD3 and D4PG training paths:
Pendulum-v1, 2x256 actor and critic, batch 64, f32, one CPU actor process,
a uniform replay ring in device memory, and K learner steps per dispatch
carried by one launch of the hand-written CUDA kernel in
csrc/fused_chunk.cu (ops/fused_chunk.py wraps it).

Importing the package imports no torch: actor worker processes import
`actors/` and `envs/` only and never touch CUDA. DDPGAgent, exported as
the JAX package exports it, loads (with torch) at its first use.
"""

from distributed_ddpg_tpu_torch.config import DDPGConfig

__version__ = "0.1.0"

__all__ = ["DDPGAgent", "DDPGConfig", "__version__"]


def __getattr__(name: str):
    if name == "DDPGAgent":
        from distributed_ddpg_tpu_torch.agent import DDPGAgent

        return DDPGAgent
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
