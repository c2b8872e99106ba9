"""Replay: the device ring (device.py), its host staging ring, the host
replays (uniform.py, prioritized.py, sum_tree.py) and the n-step
accumulator. Importing the package imports no torch: actor workers import
replay.nstep."""

from distributed_ddpg_tpu_torch.replay.prioritized import PrioritizedReplay
from distributed_ddpg_tpu_torch.replay.uniform import UniformReplay


def make_replay(config, obs_dim: int, act_dim: int):
    """The host replay config.prioritized asks for (the JAX package's
    replay/__init__.make_replay)."""
    if config.prioritized:
        return PrioritizedReplay(
            capacity=config.replay_capacity,
            obs_dim=obs_dim,
            act_dim=act_dim,
            alpha=config.per_alpha,
            beta=config.per_beta,
            eps=config.per_eps,
            seed=config.seed,
        )
    return UniformReplay(
        capacity=config.replay_capacity,
        obs_dim=obs_dim,
        act_dim=act_dim,
        seed=config.seed,
    )


__all__ = ["PrioritizedReplay", "UniformReplay", "make_replay"]
