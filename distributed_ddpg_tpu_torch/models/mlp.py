"""Actor/critic MLPs as plain functions on tensors.

Counterpart of distributed_ddpg_tpu/models/mlp.py, same shapes and init:

- Actor mu(s): relu hiddens, tanh output mapped onto the action box.
- SAC's Gaussian actor: the same MLP with a linear [mean | log_std_raw]
  head (2*act wide), log_std soft-clamped onto [min, max] with a tanh.
- Critic Q(s, a): relu MLP whose layer `action_insert_layer` takes
  [features, action] (1 by default: classic DDPG, the action enters at
  the second layer; 0 is the input layer); under D4PG its head has
  num_atoms logits.
- Hidden layers ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)); final layers
  ~ U(-FINAL_INIT_SCALE, +FINAL_INIT_SCALE).

Mixed precision (`mm_dtype=torch.bfloat16`, compute_dtype='bfloat16'):
each dense layer takes bf16-rounded operands, accumulates in f32 and adds
the f32 bias; its gradient is JAX autodiff's of that dot (`_Bf16Dense`).

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
                hidden: Sequence[int], device="cpu", num_outputs: int = 1,
                action_insert_layer: int = 1) -> Params:
    """Critic params; layer `action_insert_layer`'s input is [features,
    action]. `num_outputs > 1` is the D4PG categorical head (one logit per
    atom)."""
    dims = [obs_dim, *hidden, num_outputs]
    n = len(dims) - 1
    if not 0 <= action_insert_layer < n:
        raise ValueError(
            f"action_insert_layer={action_insert_layer} out of range for a "
            f"{n}-layer critic (valid: 0..{n - 1})"
        )
    return tuple(
        _linear_init(
            gen, dims[i] + (act_dim if i == action_insert_layer else 0), dims[i + 1],
            final=(i == n - 1), device=device,
        )
        for i in range(n)
    )


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value (ties to even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16Dense(torch.autograd.Function):
    """x @ w + b as the JAX package's models/mlp.py::_dense computes it in
    bf16, and its gradient as JAX autodiff computes that: the forward
    rounds both operands to bf16 and keeps the f32 sum (a product of two
    bf16 values is exact in f32); the backward multiplies the UNROUNDED f32
    cotangent g by the other rounded operand in f32 and rounds the product
    to bf16 (gx = bf16(g @ bf16(w)^T), gw = bf16(bf16(x)^T @ g)); the bias
    gradient g.sum(0) is not rounded. (`x.bfloat16() @ w.bfloat16()` would
    round the output, and its autograd the incoming cotangent.)"""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gx = round_bf16(g @ wr.T) if ctx.needs_input_grad[0] else None
        gw = round_bf16(xr.T @ g) if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb


def _dense(x: torch.Tensor, layer, mm_dtype) -> torch.Tensor:
    """x @ w + b; with mm_dtype = torch.bfloat16 (the only other value),
    _Bf16Dense."""
    if mm_dtype is None:
        return x @ layer["w"] + layer["b"]
    return _Bf16Dense.apply(x, layer["w"], layer["b"])


def actor_apply(params: Params, obs: torch.Tensor, action_scale,
                action_offset=0.0, mm_dtype=None) -> torch.Tensor:
    """mu(s) onto the box [offset - scale, offset + scale]."""
    x = obs
    for layer in params[:-1]:
        x = torch.relu(_dense(x, layer, mm_dtype))
    x = _dense(x, params[-1], mm_dtype)
    return torch.tanh(x) * action_scale + action_offset


def actor_gaussian_apply(params: Params, obs: torch.Tensor, log_std_min: float,
                         log_std_max: float,
                         mm_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAC's head: raw (mean, log_std), each [B, act], with
    log_std = min + (max - min) / 2 * (tanh(raw) + 1). Sampling, the squash
    and the log-prob live in ops/losses.py."""
    x = obs
    for layer in params[:-1]:
        x = torch.relu(_dense(x, layer, mm_dtype))
    x = _dense(x, params[-1], mm_dtype)
    mean, log_std_raw = torch.chunk(x, 2, dim=-1)
    log_std = log_std_min + 0.5 * (log_std_max - log_std_min) * (torch.tanh(log_std_raw) + 1.0)
    return mean, log_std


def critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor,
                 mm_dtype=None, action_insert_layer: int = 1) -> torch.Tensor:
    """Q(s, a) -> f32[B] (f32[B, num_atoms] logits for a D4PG head); the
    action joins the features at layer `action_insert_layer`."""
    x = obs
    n = len(params)
    for i, layer in enumerate(params):
        if i == action_insert_layer:
            x = torch.cat([x, action], dim=-1)
        x = _dense(x, layer, mm_dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x.squeeze(-1) if x.shape[-1] == 1 else x


def critic_member(params: Params, m: int) -> Params:
    """Member m of a [2, ...] critic ensemble, as a plain critic tree."""
    return tuple({k: layer[k][m] for k in ("w", "b")} for layer in params)


def ensemble_critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor,
                          mm_dtype=None, action_insert_layer: int = 1) -> torch.Tensor:
    """Q of both members of a [2, ...] critic ensemble -> f32[2, B] (the
    JAX package vmaps critic_apply over the leading axis)."""
    return torch.stack([
        critic_apply(critic_member(params, m), obs, action, mm_dtype, action_insert_layer)
        for m in range(2)
    ])
