from distributed_ddpg_tpu_torch.envs.registry import EnvSpec, make, spec_of

__all__ = ["make", "spec_of", "EnvSpec"]
