"""Polyak (soft) target update: target <- tau*online + (1-tau)*target.

Counterpart of distributed_ddpg_tpu/ops/polyak.py.
"""

from __future__ import annotations

from distributed_ddpg_tpu_torch.ops.optim import tree_map


def polyak_update(online, target, tau):
    return tree_map(lambda o, t: tau * o + (1.0 - tau) * t, online, target)
