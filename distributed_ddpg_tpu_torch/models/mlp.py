"""Actor/critic MLPs as plain functions on tensors.

Counterpart of distributed_ddpg_tpu/models/mlp.py, same shapes and init:

- Actor mu(s): relu hiddens, tanh output mapped onto the action box.
- Critic Q(s, a): relu MLP whose layer 1 takes [features, action]
  (classic DDPG; the action enters at the second layer); under D4PG its
  head has num_atoms logits.
- Hidden layers ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)); final layers
  ~ U(-FINAL_INIT_SCALE, +FINAL_INIT_SCALE).

Params are a tuple of {"w": [in, out], "b": [out]} dicts, the JAX layout,
so a state converts across frameworks leaf by leaf (learner.py). A TD3
critic ensemble has the same tree with every leaf stacked on a leading
[2, ...] axis (learner.init_train_state), as in the JAX package. The two
frameworks draw different random numbers from one seed: parity tests start
from a state the JAX package made.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Params = Tuple[Dict[str, torch.Tensor], ...]

FINAL_INIT_SCALE = 3e-3


def _linear_init(gen: torch.Generator, in_dim: int, out_dim: int, final: bool,
                 device) -> Dict[str, torch.Tensor]:
    bound = FINAL_INIT_SCALE if final else 1.0 / math.sqrt(in_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * (2.0 * bound) - bound).to(device)

    return {"w": uniform((in_dim, out_dim)), "b": uniform((out_dim,))}


def mlp_init(gen: torch.Generator, dims: Sequence[int], device="cpu") -> Params:
    """A chain of linear layers dims[0] -> ... -> dims[-1]. `gen` is a CPU
    generator, so one seed gives the same params on every device."""
    n = len(dims) - 1
    return tuple(
        _linear_init(gen, dims[i], dims[i + 1], final=(i == n - 1), device=device)
        for i in range(n)
    )


def actor_init(gen: torch.Generator, obs_dim: int, act_dim: int,
               hidden: Sequence[int], device="cpu") -> Params:
    return mlp_init(gen, [obs_dim, *hidden, act_dim], device)


def critic_init(gen: torch.Generator, obs_dim: int, act_dim: int,
                hidden: Sequence[int], device="cpu", num_outputs: int = 1) -> Params:
    """Critic params; layer 1's input is [hidden[0] features, action].
    `num_outputs > 1` is the D4PG categorical head (one logit per atom)."""
    dims = [obs_dim, *hidden, num_outputs]
    n = len(dims) - 1
    return tuple(
        _linear_init(
            gen, dims[i] + (act_dim if i == 1 else 0), dims[i + 1],
            final=(i == n - 1), device=device,
        )
        for i in range(n)
    )


def actor_apply(params: Params, obs: torch.Tensor, action_scale,
                action_offset=0.0) -> torch.Tensor:
    """mu(s) onto the box [offset - scale, offset + scale]."""
    x = obs
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    x = x @ params[-1]["w"] + params[-1]["b"]
    return torch.tanh(x) * action_scale + action_offset


def critic_apply(params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    """Q(s, a) -> f32[B] (f32[B, num_atoms] logits for a D4PG head); the
    action joins the features at layer 1."""
    x = obs
    n = len(params)
    for i, layer in enumerate(params):
        if i == 1:
            x = torch.cat([x, action], dim=-1)
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x.squeeze(-1) if x.shape[-1] == 1 else x


def critic_member(params: Params, m: int) -> Params:
    """Member m of a [2, ...] critic ensemble, as a plain critic tree."""
    return tuple({k: layer[k][m] for k in ("w", "b")} for layer in params)


def ensemble_critic_apply(params: Params, obs: torch.Tensor,
                          action: torch.Tensor) -> torch.Tensor:
    """Q of both members of a [2, ...] critic ensemble -> f32[2, B] (the
    JAX package vmaps critic_apply over the leading axis)."""
    return torch.stack(
        [critic_apply(critic_member(params, m), obs, action) for m in range(2)]
    )
