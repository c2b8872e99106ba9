"""Actor/critic MLPs as plain functions on tensors.

Counterpart of distributed_ddpg_tpu/models/mlp.py, same shapes and init:

- Actor mu(s): relu hiddens, tanh output mapped onto the action box.
- Critic Q(s, a): relu MLP whose layer 1 takes [features, action]
  (classic DDPG; the action enters at the second layer).
- Hidden layers ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)); final layers
  ~ U(-FINAL_INIT_SCALE, +FINAL_INIT_SCALE).

Params are a tuple of {"w": [in, out], "b": [out]} dicts, the JAX layout,
so a state converts across frameworks leaf by leaf (learner.py). The two
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
                hidden: Sequence[int], device="cpu") -> Params:
    """Critic params; layer 1's input is [hidden[0] features, action]."""
    dims = [obs_dim, *hidden, 1]
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
    """Q(s, a) -> f32[B]; the action joins the features at layer 1."""
    x = obs
    n = len(params)
    for i, layer in enumerate(params):
        if i == 1:
            x = torch.cat([x, action], dim=-1)
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x.squeeze(-1)
