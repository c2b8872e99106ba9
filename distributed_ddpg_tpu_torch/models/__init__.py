from distributed_ddpg_tpu_torch.models.mlp import (
    actor_apply,
    actor_init,
    critic_apply,
    critic_init,
    mlp_init,
)

__all__ = ["actor_init", "actor_apply", "critic_init", "critic_apply", "mlp_init"]
