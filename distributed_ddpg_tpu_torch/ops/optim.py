"""Explicit Adam over a params tree (tuple of {"w","b"} dicts).

Counterpart of distributed_ddpg_tpu/ops/optim.py: optax.adam defaults
(b1=0.9, b2=0.999, eps=1e-8, eps_root=0), bias-corrected moments with
`1 - B**count` from the carried count, eps added outside the sqrt. The
formulas and their order are the JAX package's, so the two agree to f32
rounding. The learner chunk kernel (csrc/fused_chunk.cu) does the same
update with the correction written as 1 - exp(count * log B), which
differs from B**count at ULP level.
"""

from __future__ import annotations

import torch

from distributed_ddpg_tpu_torch.types import OptState

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def tree_map(fn, *trees):
    """Map `fn` over the leaves of params trees of one structure."""
    return tuple(
        {k: fn(*(t[i][k] for t in trees)) for k in trees[0][i]}
        for i in range(len(trees[0]))
    )


def tree_leaves(tree):
    return [layer[k] for layer in tree for k in ("w", "b")]


def adam_update(params, grads, opt: OptState, lr):
    """One Adam step. Returns (new_params, new_opt)."""
    count = opt.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(B1, c)
    bc2 = 1.0 - torch.pow(B2, c)
    mu = tree_map(lambda m, g: B1 * m + (1.0 - B1) * g, opt.mu, grads)
    nu = tree_map(lambda v, g: B2 * v + (1.0 - B2) * (g * g), opt.nu, grads)
    new_params = tree_map(
        lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS),
        params,
        mu,
        nu,
    )
    return new_params, OptState(mu=mu, nu=nu, count=count)
