"""The trees that the fused update's checks run on (chip_smoke.py,
tests/test_torch_on_card.py, tests/test_torch_fused_update.py): shapes
that test how the kernel (csrc/fused_update.cu) finds and reads its
leaves, and a function that lays a tree out as separate tensors or as
views that are not 16-byte aligned.

A tree is given as a list of layers, (w shape, b shape) each, as the
port's params trees hold them ({"w", "b"} a layer).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_ddpg_tpu_torch.ops.optim import tree_leaves
from distributed_ddpg_tpu_torch.types import OptState

# The JAX test's ragged leaves (tests/test_fused.py:23); leaves of odd
# lengths (1, 3, 5, 4097); the ragged leaves again, laid out unaligned
# (SHIFTS); and more leaves than one launch's table holds
# (ops/fused_update.MAX_LEAVES).
SHAPES = {
    "ragged": [((17, 256), (256,)), ((256, 129), (3,))],
    "odd": [((1,), (3,)), ((5,), (4097,)), ((3, 7), (1,))],
    "unaligned": [((17, 256), (256,)), ((256, 129), (3,))],
    "many": [((i % 7 + 1, 3 * i + 1), (2 * i + 1,)) for i in range(24)] + [((64, 65), (4097,))],
}

# For a tree laid out unaligned, the shift (in f32 past a 16-byte
# boundary) of each of its five trees, in the order the checks make them:
# params, targets, mu, nu, grads. Every other tree is separate tensors.
SHIFTS = {"unaligned": (1, 2, 3, 1, 2)}
NO_SHIFTS = (0,) * 5


def leaf_shapes(layers):
    """The leaves' shapes of a tree of `layers`, in tree_leaves order."""
    return tuple(s for layer in layers for s in layer)


def tree_of(layers, leaves, shift: int = 0, device="cuda"):
    """A params tree (a tuple of {"w", "b"}) of `layers` holding `leaves`
    (numpy arrays or tensors) on `device`: separate tensors, or with
    `shift` (1, 2 or 3) views into one buffer, each leaf `shift` f32 past
    a 16-byte boundary, so that none is aligned."""
    leaves = [torch.as_tensor(x).to(device) for x in leaves]
    if shift:
        buf = torch.zeros(sum(x.numel() + 4 for x in leaves) + 4, dtype=torch.float32,
                          device=device)
        at, views = 0, []
        for x in leaves:
            at = -(-at // 4) * 4 + shift
            views.append(buf[at:at + x.numel()].view(x.shape))
            views[-1].copy_(x)
            at += x.numel()
        leaves = views
    it = iter(leaves)
    return tuple({"w": next(it), "b": next(it)} for _ in layers)


def update_inputs(layers, shifts=NO_SHIFTS, count: int = 5, zero_moments: bool = False,
                  seed: int = 0, device="cuda"):
    """(params, opt, targets, grads of step i) for a fused update of a tree
    of `layers` on `device`, from a seeded numpy draw: params and targets
    N(0, 1); moments zero, or mu N(0, 1e-3^2) and nu U(1e-6, 1e-4); the
    count `count`; grads sin(p + i), laid out as the params are. The five
    trees are laid out with `shifts` (tree_of; params, targets, mu, nu,
    grads)."""
    rng = np.random.default_rng(seed)
    shifts = iter(shifts)
    normal = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if zero_moments:
        mu = nu = lambda s: np.zeros(s, np.float32)  # noqa: E731
    else:
        mu = lambda s: (1e-3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
        nu = lambda s: rng.uniform(1e-6, 1e-4, s).astype(np.float32)  # noqa: E731

    def tree(fn):
        return tree_of(layers, [fn(s) for s in leaf_shapes(layers)], next(shifts), device)

    params, targets = tree(normal), tree(normal)
    opt = OptState(mu=tree(mu), nu=tree(nu),
                   count=torch.tensor(count, dtype=torch.int32, device=device))
    grad_shift = next(shifts)

    def grads_at(i, p):
        return tree_of(layers, [torch.sin(x + i) for x in tree_leaves(p)], grad_shift, device)

    return params, opt, targets, grads_at
