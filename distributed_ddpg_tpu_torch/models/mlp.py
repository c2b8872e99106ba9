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

Tensor parallelism (model_axis M > 1, parallel/partition.py): every apply
takes `tp`, a NetTP (each layer's kind under the net's rule table and the
model group, parallel/mesh.DataGroup's `model`), and then runs on the
rank's shards, Megatron's way. A column-parallel layer ("col": w
[in, out / M], b [out / M]) takes the whole input and computes its slice
of the output; a row-parallel layer ("row": w [in / M, out]) multiplies
its slice of the input and sums the partial products over the model
group before the (whole) bias; a replicated layer ("rep") takes the whole
input. A slice that a layer needs and the previous layer did not leave
is cut from the whole activation, gathered over the group first: so at
the critic's action-insert layer, [h | action] is whole (a replicated
layer when hidden + act does not divide M) or cut at (hidden + act) / M,
not at layer 0's boundaries. The collectives are autograd Functions
whose backward keeps every whole activation's gradient whole and the
same on every rank: a gather's backward takes the rank's slice, the cut
and the copy into a column layer sum their rank-local gradients over the
group, and the sum after a row layer passes its gradient through. So
each rank's parameter gradient is the logical gradient's slice (its
shards) or the whole logical gradient (its replicated leaves, the same
on every rank). With mm = bf16 a partial product that is summed over the
group is rounded once, after the sum (the JAX package's step on a
(data, model) mesh rounds the whole contraction's: tests/test_torch_tp.py
holds the two).

Row tiles (`row_tile`, the rollouts' policy apply, ops/exploration.py):
each dense layer multiplies ROW_TILE rows at a time (one addmm a tile).
cuBLAS picks its kernel, and with it the order of a row's sums, by the
row count: on an H100 `x @ w` over 512 rows differs from the same rows of
a 1024-row product (chip_smoke.py 3d (a) prints it). With fixed tiles a
row's result depends on its tile only, so a rank stepping its block of
the envs gets the bits of the whole batch wherever its block starts on a
tile boundary (its envs a multiple of ROW_TILE, or all of them).

Params are a tuple of {"w": [in, out], "b": [out]} dicts, the JAX layout,
so a state converts across frameworks leaf by leaf (learner.py). A TD3
critic ensemble has the same tree with every leaf stacked on a leading
[2, ...] axis (learner.init_train_state), as in the JAX package. The two
frameworks draw different random numbers from one seed: parity tests start
from a state the JAX package made.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

Params = Tuple[Dict[str, torch.Tensor], ...]

FINAL_INIT_SCALE = 3e-3

# Rows a dense layer takes at a time under `row_tile` (the module's docstring).
ROW_TILE = 256


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
    round the output, and its autograd the incoming cotangent.) With
    `partial_gx` (a column-parallel layer's, whose gx is a partial sum over
    the model group) gx stays f32: the sum is rounded once, after the
    group's sum (_CopyToModel), where the JAX package's step on a
    (data, model) mesh rounds the whole contraction's."""

    @staticmethod
    def forward(ctx, x, w, b, partial_gx=False):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.partial_gx = partial_gx
        return xr @ wr if b is None else xr @ wr + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gx = None
        if ctx.needs_input_grad[0]:
            gx = g @ wr.T if ctx.partial_gx else round_bf16(g @ wr.T)
        gw = round_bf16(xr.T @ g) if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


def _dense(x: torch.Tensor, layer, mm_dtype, row_tile: bool = False) -> torch.Tensor:
    """x @ w + b; with mm_dtype = torch.bfloat16 (the only other value),
    _Bf16Dense; with `row_tile` (f32) ROW_TILE rows at a time."""
    if mm_dtype is None and row_tile:
        return torch.cat([torch.addmm(layer["b"], t, layer["w"])
                          for t in x.split(ROW_TILE)])
    if mm_dtype is None:
        return x @ layer["w"] + layer["b"]
    return _Bf16Dense.apply(x, layer["w"], layer["b"])


# --- tensor parallelism (the module's docstring) ---------------------------


class NetTP(NamedTuple):
    """A net's Megatron split on one rank: each layer's kind ("col", "row"
    or "rep", parallel/partition.layer_kinds) and the model group."""

    kinds: Tuple[str, ...]
    group: object


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    from distributed_ddpg_tpu_torch.parallel.mesh import all_reduce_sum_

    out = x.contiguous().clone()
    all_reduce_sum_([out], group)
    return out


class _CopyToModel(torch.autograd.Function):
    """A whole activation into a rank-local consumer (a column layer):
    the identity; the gradient summed over the model group, and under
    bf16 (`rounded`) rounded to bf16 after the sum."""

    @staticmethod
    def forward(ctx, x, group, rounded=False):
        ctx.group, ctx.rounded = group, rounded
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = _summed(g, ctx.group)
        return (round_bf16(total) if ctx.rounded else total), None, None


class _SumFromModel(torch.autograd.Function):
    """The partial products of a row layer summed over the model group;
    the gradient (whole, the same on every rank) passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Each rank's [..., w] slice -> the whole [..., M * w] activation, in
    model-rank order (exact: mesh.all_gather); the gradient is the rank's
    slice of the whole activation's."""

    @staticmethod
    def forward(ctx, x, group):
        from distributed_ddpg_tpu_torch.parallel.mesh import all_gather

        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(all_gather(x.contiguous(), group).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.group.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


class _Cut(torch.autograd.Function):
    """The whole activation -> this rank's [..., width] slice (a row
    layer's input); the gradient is each rank's slice gradient put in its
    place, -0.0 elsewhere, summed over the group (exact)."""

    @staticmethod
    def forward(ctx, x, group, width):
        ctx.group, ctx.width, ctx.n = group, width, x.shape[-1]
        lo = group.rank * width
        return x[..., lo:lo + width].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_full((*g.shape[:-1], ctx.n), -0.0)
        lo = ctx.group.rank * ctx.width
        full[..., lo:lo + ctx.width] = g
        return _summed(full, ctx.group), None, None


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the model group; its gradient passes through (the
    sum's consumers are whole, the same on every rank)."""
    return _SumFromModel.apply(x, group)


def sum_sq(params: Params, tp=None, keys=("w", "b")) -> torch.Tensor:
    """The sum of squares of every layer's `keys` leaves; with `tp` (the
    net's NetTP) the logical tree's: the shards' squares summed over the
    model group (a column layer's w and b, a row layer's w), the
    replicated leaves' counted once."""
    local, shards = [], []
    for i, layer in enumerate(params):
        kind = tp.kinds[i] if tp is not None else "rep"
        for k in keys:
            sq = torch.sum(torch.square(layer[k]))
            (shards if kind == "col" or kind == "row" and k == "w" else local).append(sq)
    total = sum(local)
    if shards:
        total = total + sum_over_model(sum(shards), tp.group)
    return total


def _matmul(x: torch.Tensor, w: torch.Tensor, mm_dtype) -> torch.Tensor:
    return x @ w if mm_dtype is None else _Bf16Dense.apply(x, w, None)


def _chain(params: Params, x: torch.Tensor, tp, mm_dtype,
           action=None, insert_at: int = -1, row_tile: bool = False) -> torch.Tensor:
    """The relu MLP with a linear last layer; `action` joins the features
    at layer `insert_at`. With `tp` (a NetTP) on a rank's shards (the
    module's docstring), else every layer whole ("rep"), in row tiles
    with `row_tile`. Returns the whole output."""
    group = tp.group if tp is not None else None
    n, sharded = len(params), False
    for i, layer in enumerate(params):
        kind = tp.kinds[i] if tp is not None else "rep"
        if i == insert_at:
            if sharded:
                x, sharded = _Gather.apply(x, group), False
            x = torch.cat([x, action], dim=-1)
        if kind == "row":
            width = layer["w"].shape[-2]
            if not (sharded and x.shape[-1] == width):
                if sharded:
                    x = _Gather.apply(x, group)
                x = _Cut.apply(x, group, width)
            x = _SumFromModel.apply(_matmul(x, layer["w"], mm_dtype), group) + layer["b"]
            sharded = False
        else:
            if sharded:
                x, sharded = _Gather.apply(x, group), False
            if kind == "col":
                x, sharded = _CopyToModel.apply(x, group, mm_dtype is not None), True
                x = (x @ layer["w"] + layer["b"] if mm_dtype is None
                     else _Bf16Dense.apply(x, layer["w"], layer["b"], True))
            else:
                x = _dense(x, layer, mm_dtype, row_tile)
        if i < n - 1:
            x = torch.relu(x)
    return _Gather.apply(x, group) if sharded else x


def actor_apply(params: Params, obs: torch.Tensor, action_scale,
                action_offset=0.0, mm_dtype=None, tp=None,
                row_tile: bool = False) -> torch.Tensor:
    """mu(s) onto the box [offset - scale, offset + scale]."""
    x = _chain(params, obs, tp, mm_dtype, row_tile=row_tile)
    return torch.tanh(x) * action_scale + action_offset


def actor_gaussian_apply(params: Params, obs: torch.Tensor, log_std_min: float,
                         log_std_max: float, mm_dtype=None, tp=None,
                         row_tile: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAC's head: raw (mean, log_std), each [B, act], with
    log_std = min + (max - min) / 2 * (tanh(raw) + 1). Sampling, the squash
    and the log-prob live in ops/losses.py."""
    x = _chain(params, obs, tp, mm_dtype, row_tile=row_tile)
    mean, log_std_raw = torch.chunk(x, 2, dim=-1)
    log_std = log_std_min + 0.5 * (log_std_max - log_std_min) * (torch.tanh(log_std_raw) + 1.0)
    return mean, log_std


def critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor,
                 mm_dtype=None, action_insert_layer: int = 1, tp=None) -> torch.Tensor:
    """Q(s, a) -> f32[B] (f32[B, num_atoms] logits for a D4PG head); the
    action joins the features at layer `action_insert_layer`."""
    x = _chain(params, obs, tp, mm_dtype, action, action_insert_layer)
    return x.squeeze(-1) if x.shape[-1] == 1 else x


def critic_member(params: Params, m: int) -> Params:
    """Member m of a [2, ...] critic ensemble, as a plain critic tree."""
    return tuple({k: layer[k][m] for k in ("w", "b")} for layer in params)


def ensemble_critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor,
                          mm_dtype=None, action_insert_layer: int = 1,
                          tp=None) -> torch.Tensor:
    """Q of both members of a [2, ...] critic ensemble -> f32[2, B] (the
    JAX package vmaps critic_apply over the leading axis)."""
    return torch.stack([
        critic_apply(critic_member(params, m), obs, action, mm_dtype, action_insert_layer, tp)
        for m in range(2)
    ])
