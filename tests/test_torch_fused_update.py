"""The fused Adam + Polyak wrapper's contract where it runs on the CPU
(distributed_ddpg_tpu_torch/ops/fused_update.py).

The kernel (csrc/fused_update.cu) runs only on the card
(tests/test_torch_on_card.py, chip_smoke.py). What decides where it reads
and writes is Python, and runs here: `plan` (each leaf's offset in the
output buffer; which leaves go to which launch; each leaf's first block)
and `leaf_table` (the bytes the launch takes). The kernel's walk over a
table is written out below (`kernel_walk`, the formula of
fused_update_kernel) and must cover every element of every leaf once. The
plain version against the JAX kernel is
tests/test_torch_scan.py::test_fused_update_plain_version_matches_jax_kernel.
"""

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import init_train_state
from distributed_ddpg_tpu_torch.ops import fused_update as fu
from distributed_ddpg_tpu_torch.ops.optim import tree_leaves
from distributed_ddpg_tpu_torch.tools import update_trees as ut

torch.set_num_threads(1)

# The kernel's Table (csrc/fused_update.cu), field by field: what the
# wrapper's packed bytes must read as.
TABLE_DTYPE = np.dtype([
    ("first_block", np.int32, (fu.MAX_LEAVES + 1,)),
    ("lr", np.float32), ("tau", np.float32), ("omtau", np.float32),
    ("count", np.int64), ("new_count", np.int64),
    ("leaf", np.int64, (fu.MAX_LEAVES, 10)),
])


def _read(table: bytes):
    return np.frombuffer(table, TABLE_DTYPE)[0]

# The Pendulum DDPG critic (obs 3, act 1, 2x256; the action enters the
# second layer) and actor; the checks' trees (tools/update_trees.py).
CRITIC = ((3, 256), (256,), (257, 256), (256,), (256, 1), (1,))
ACTOR = ((3, 256), (256,), (256, 256), (256,), (256, 1), (1,))
RAGGED = ut.leaf_shapes(ut.SHAPES["ragged"])
ODD = ut.leaf_shapes(ut.SHAPES["odd"])
MANY = ut.leaf_shapes(ut.SHAPES["many"])
EMPTY = ((0,), (300,), (0, 3), (5,))


def test_pendulum_trees_have_the_shapes_above():
    cfg = DDPGConfig(device="cpu")
    state = init_train_state(cfg, 3, 1, 0)
    assert tuple(tuple(x.shape) for x in tree_leaves(state.critic_params)) == CRITIC
    assert tuple(tuple(x.shape) for x in tree_leaves(state.actor_params)) == ACTOR


def test_plan_of_the_pendulum_critic():
    layout = fu.plan(CRITIC)
    assert layout.numels == (768, 256, 65792, 256, 256, 1)
    assert layout.offsets == (0, 768, 1024, 66816, 67072, 67328)
    assert layout.stride == 67329
    (launch,) = layout.launches
    assert launch.leaves == range(6)
    assert launch.first_blocks == (0, 3, 4, 261, 262, 263)
    assert launch.blocks == 264


def test_plan_past_one_table_takes_further_launches():
    layout = fu.plan(MANY, max_leaves=fu.MAX_LEAVES)
    assert len(MANY) == 50 > fu.MAX_LEAVES
    first, second = layout.launches
    assert first.leaves == range(0, 40) and second.leaves == range(40, 50)
    for launch in layout.launches:
        assert launch.first_blocks[0] == 0           # each launch numbers its own blocks
        ends = launch.first_blocks[1:] + (launch.blocks,)
        for i, start, end in zip(launch.leaves, launch.first_blocks, ends):
            assert end - start == -(-layout.numels[i] // fu.THREADS)
    assert len(fu.plan(MANY, max_leaves=7).launches) == 8


def test_plan_gives_a_leaf_of_no_elements_no_block():
    (launch,) = fu.plan(EMPTY).launches
    assert launch.first_blocks == (0, 0, 2, 2) and launch.blocks == 3
    (launch,) = fu.plan(((0,),)).launches
    assert launch.blocks == 1                         # a launch still writes the count


@pytest.mark.parametrize("shapes", [CRITIC, ODD, MANY], ids=["critic", "odd", "many"])
def test_output_views_are_disjoint_and_fill_the_buffer(shapes):
    layout = fu.plan(shapes)
    spans = []
    for k, (size, strides, offset) in enumerate(layout.views):
        leaf = k % len(shapes)
        assert size == shapes[leaf]
        assert offset == (k // len(shapes)) * layout.stride + layout.offsets[leaf]
        spans.append((offset, offset + layout.numels[leaf]))
        assert torch.empty(size).stride() == strides
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == 4 * layout.stride
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _pointers(shapes, shift_bytes):
    """Input pointers of five trees, leaf by leaf, each tree a flat run from
    its own base, every leaf `shift_bytes` past its natural offset."""
    bases = [(1 << 32) * (k + 1) for k in range(5)]
    out, at = [[] for _ in range(5)], 0
    for s in shapes:
        for k in range(5):
            out[k].append(bases[k] + 4 * at + shift_bytes[k])
        at += int(np.prod(s))
    return out


def test_leaf_table_rows():
    layout = fu.plan(ODD)
    (launch,) = layout.launches
    in_ptrs = _pointers(ODD, (0, 4, 8, 12, 4))
    out_ptr = 1 << 40
    table = _read(fu.leaf_table(layout, launch, in_ptrs, out_ptr, 1000, 2000, 3e-4, 5e-3))
    assert TABLE_DTYPE.itemsize == 40 * 84 + 32 == 3392 <= 4096
    assert all(fu.table_format(k).size == 3392 for k in (0, 1, fu.MAX_LEAVES))
    rows = table["leaf"]
    region = 4 * layout.stride
    for i, shape in enumerate(ODD):
        assert list(rows[i, :5]) == [p[i] for p in in_ptrs]
        out0 = out_ptr + 4 * layout.offsets[i]
        assert list(rows[i, 5:9]) == [out0 + k * region for k in range(4)]
        assert rows[i, 9] == int(np.prod(shape))
    assert not rows[len(ODD):].any()
    assert tuple(table["first_block"][:len(ODD) + 1]) == launch.first_blocks + (launch.blocks,)
    assert not table["first_block"][len(ODD) + 1:].any()
    assert table["count"] == 1000 and table["new_count"] == 2000
    assert table["lr"] == np.float32(3e-4) and table["tau"] == np.float32(5e-3)
    assert table["omtau"] == np.float32(1.0 - 5e-3)           # rounded from the double


def test_leaf_table_of_a_later_launch_holds_its_own_leaves():
    layout = fu.plan(MANY)
    in_ptrs = _pointers(MANY, (0,) * 5)
    out_ptr = 1 << 40
    _, second = layout.launches
    table = _read(fu.leaf_table(layout, second, in_ptrs, out_ptr, 1000, 2000, 1e-3, 1e-3))
    rows = table["leaf"]
    for row, i in enumerate(second.leaves):
        assert list(rows[row, :5]) == [p[i] for p in in_ptrs]
        assert rows[row, 5] == out_ptr + 4 * layout.offsets[i]
        assert rows[row, 9] == layout.numels[i]
    assert not rows[len(second.leaves):].any()
    assert table["first_block"][len(second.leaves)] == second.blocks
    assert table["count"] == 1000 and table["new_count"] == 2000


def kernel_walk(table, n_leaves, blocks):
    """The elements fused_update_kernel touches for one launch's table, by
    its formula: block b takes the leaf l before the first i >= 1 with
    first_block[i] > b (the block count ends the list), thread x element
    e = (b - first_block[l]) * THREADS + x, those below the leaf's length.
    Returns {leaf: counts of each element}."""
    first = table["first_block"]
    rows = table["leaf"]
    seen = {i: np.zeros(int(rows[i, 9]), np.int64) for i in range(n_leaves)}
    for b in range(blocks):
        leaf = 0
        while leaf + 1 < fu.MAX_LEAVES and first[leaf + 1] <= b:
            leaf += 1
        assert leaf < n_leaves
        e = (b - int(first[leaf])) * fu.THREADS + np.arange(fu.THREADS)
        np.add.at(seen[leaf], e[e < int(rows[leaf, 9])], 1)
    return seen


@pytest.mark.parametrize("shapes, max_leaves", [
    (CRITIC, fu.MAX_LEAVES), (ACTOR, fu.MAX_LEAVES), (RAGGED, fu.MAX_LEAVES),
    (ODD, fu.MAX_LEAVES), (MANY, fu.MAX_LEAVES), (MANY, 7), (EMPTY, fu.MAX_LEAVES)],
    ids=["critic", "actor", "ragged", "odd", "many", "many-7-a-launch", "empty-leaves"])
def test_kernel_walk_covers_each_element_once(shapes, max_leaves):
    layout = fu.plan(shapes, max_leaves=max_leaves)
    in_ptrs = _pointers(shapes, (0,) * 5)
    covered = set()
    for launch in layout.launches:
        table = _read(fu.leaf_table(layout, launch, in_ptrs, 1 << 40, 0, 8, 1e-3, 1e-3))
        seen = kernel_walk(table, len(launch.leaves), launch.blocks)
        for i, counts in seen.items():
            assert (counts == 1).all(), (launch.leaves[i], np.unique(counts))
            covered.add(launch.leaves[i])
    assert covered == set(range(len(shapes)))


@pytest.mark.parametrize("tree", list(ut.SHAPES))
def test_a_call_on_the_cpu_leaves_its_inputs_untouched(tree):
    params, opt, targets, grads_at = ut.update_inputs(
        ut.SHAPES[tree], ut.SHIFTS.get(tree, ut.NO_SHIFTS), count=41, device="cpu")
    grads = grads_at(0, params)
    trees = (params, grads, opt.mu, opt.nu, targets)
    before = [x.clone() for t in trees for x in tree_leaves(t)] + [opt.count.clone()]
    new_params, new_opt, new_targets = fu.fused_adam_polyak(params, grads, opt, targets,
                                                            1e-3, 5e-3)
    after = [x for t in trees for x in tree_leaves(t)] + [opt.count]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    inputs = {x.data_ptr() for x in after}
    outputs = [x for t in (new_params, new_opt.mu, new_opt.nu, new_targets)
               for x in tree_leaves(t)]
    assert not inputs & {x.data_ptr() for x in outputs}
    assert int(new_opt.count) == 42 and int(opt.count) == 41
