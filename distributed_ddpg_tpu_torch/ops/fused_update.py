"""Adam + Polyak of one parameter tree in ONE launch of a hand-written CUDA kernel.

Replaces distributed_ddpg_tpu/ops/fused_update.py (fused_adam_polyak ->
_fused_flat -> pl.pallas_call, kernel body _kernel): for every element of
the tree, Adam's moments, the bias-corrected param and the Polyak target
in one element-wise pass (csrc/fused_update.cu). The scan route's step
calls it twice when fused_update=True, critic first, then actor
(learner.make_learner_step, as learner.py:417-430 of the JAX package), for
DDPG and D4PG.

- `fused_adam_polyak` is the wrapper, with the JAX signature. On CUDA
  tensors it gathers nothing: it allocates one buffer that holds the four
  output trees (params, both moments, targets; `plan`) and the new count,
  writes a table of the leaves' pointers (`leaf_table`), and launches the
  kernel once, which reads each input leaf where it lies, reads the count
  and computes the bias corrections itself, and writes the new count. A
  tree of more than MAX_LEAVES leaves takes one launch per MAX_LEAVES. It
  returns views into the buffer shaped as the input trees and leaves the
  inputs as they were. No host read of a device value and no
  synchronisation, so a CUDA graph can capture it. Each launch is counted
  in KERNEL_LAUNCHES["fused_update"]; on the CPU it runs the plain
  version.
- `fused_adam_polyak_reference` is the plain version: ops/optim.adam_update
  then ops/polyak.polyak_update. The kernel computes the same operations in
  the same order with the same f32 constants, so on the card the two agree
  bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
import struct
from typing import NamedTuple, Sequence, Tuple

import torch

from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
from distributed_ddpg_tpu_torch.ops.optim import adam_update, tree_leaves
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update
from distributed_ddpg_tpu_torch.types import OptState

# Threads a block, one element each (the kernel's kThreads): a block takes
# one tile of THREADS elements of one leaf. Leaves in one launch's table
# (the kernel's kMaxLeaves).
THREADS = 256
MAX_LEAVES = 40


class Launch(NamedTuple):
    """One launch: its leaves (indices into the tree), the first block of
    each, and its grid."""

    leaves: range
    first_blocks: Tuple[int, ...]
    blocks: int


class Layout(NamedTuple):
    """Where a tree's outputs go and how its leaves are launched: each
    leaf's length and offset in an output tree's region, the region's
    length (`stride`; the buffer holds four), the (size, stride, offset) of
    each output leaf's view into the buffer, region by region, and the
    launches."""

    numels: Tuple[int, ...]
    offsets: Tuple[int, ...]
    stride: int
    views: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]
    launches: Tuple[Launch, ...]


@functools.lru_cache(maxsize=64)
def plan(shapes: Tuple[Tuple[int, ...], ...], max_leaves: int = MAX_LEAVES) -> Layout:
    """The layout of a tree whose leaves have `shapes`: leaves one after
    another in each output region, launched in order, `max_leaves` a
    launch, one block for every THREADS elements of a leaf (a leaf of no
    elements has no block)."""
    numels = tuple(math.prod(s) for s in shapes)
    offsets = tuple(itertools.accumulate((0,) + numels[:-1]))
    stride = sum(numels)
    views = tuple((tuple(s), _contiguous_strides(s), k * stride + o)
                  for k in range(4) for s, o in zip(shapes, offsets))
    launches = []
    for start in range(0, max(len(shapes), 1), max_leaves):
        leaves = range(start, min(start + max_leaves, len(shapes)))
        firsts, blocks = [], 0
        for i in leaves:
            firsts.append(blocks)
            blocks += -(-numels[i] // THREADS)
        launches.append(Launch(leaves, tuple(firsts), max(blocks, 1)))
    return Layout(numels, offsets, stride, views, tuple(launches))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, step = [], 1
    for size in reversed(tuple(shape)):
        strides.append(step)
        step *= max(int(size), 1)
    return tuple(reversed(strides))


@functools.lru_cache(maxsize=None)
def table_format(n_leaves: int) -> struct.Struct:
    """The bytes of the kernel's Table with `n_leaves` rows filled: each
    leaf's first block and then the launch's block count (MAX_LEAVES + 1
    int32), lr, tau and 1 - tau (f32), the count's and the new count's
    pointers, then a row of 10 int64 a leaf: the pointers of the five
    inputs p, m, v, g, t and the four outputs p', m', v', t', and the
    length; the unused rows zero."""
    return struct.Struct(f"<{MAX_LEAVES + 1}i3f2q{10 * n_leaves}q{80 * (MAX_LEAVES - n_leaves)}x")


def leaf_table(layout: Layout, launch: Launch, in_ptrs: Sequence[Sequence[int]],
               out_ptr: int, count_ptr: int, new_count_ptr: int, lr, tau) -> bytes:
    """The kernel's Table for one launch (table_format): `in_ptrs` the data
    pointers of the five input trees (p, m, v, g, t), leaf by leaf;
    `out_ptr` the output buffer's (four regions of layout.stride f32: p',
    m', v', t')."""
    region = 4 * layout.stride
    rows = []
    for i in launch.leaves:
        out0 = out_ptr + 4 * layout.offsets[i]
        rows += [p[i] for p in in_ptrs] + [out0, out0 + region, out0 + 2 * region,
                                           out0 + 3 * region, layout.numels[i]]
    firsts = launch.first_blocks + (launch.blocks,) + (0,) * (MAX_LEAVES - len(launch.leaves))
    return table_format(len(launch.leaves)).pack(
        *firsts, lr, tau, 1.0 - float(tau), count_ptr, new_count_ptr, *rows)


def fused_adam_polyak_reference(params, grads, opt: OptState, targets, lr, tau):
    """The plain version: Adam, then Polyak toward the new params. Returns
    (new_params, new_opt, new_targets)."""
    new_params, new_opt = adam_update(params, grads, opt, lr)
    return new_params, new_opt, polyak_update(new_params, targets, tau)


def _lib():
    from distributed_ddpg_tpu_torch.ops import _build

    lib = _build.load("fused_update")
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        lib.fused_update_table_bytes.restype = ctypes.c_int
        table = ctypes.c_char_p          # the table's bytes
        lib.fused_update_launch.argtypes = [table, ctypes.c_longlong, ctypes.c_int, ptr]
        lib.fused_update_launch.restype = ctypes.c_int
        lib.fused_update_bias_sweep.argtypes = [ptr, ptr, ctypes.c_int, ptr]
        lib.fused_update_bias_sweep.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        if lib.fused_update_table_bytes() != table_format(0).size:
            raise RuntimeError(
                f"fused_update: the kernel's table is {lib.fused_update_table_bytes()} bytes, "
                f"the wrapper's {table_format(0).size}")
        lib._typed = True
    return lib


def check(lib, code: int, what: str = "fused_update launch") -> None:
    """Raise on a CUDA error code that the library returned (0 = ok)."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.fused_update_error_string(code).decode()})")


def kernel_bias_corrections(counts: int):
    """(bc1, bc2) of every new count 1..counts as the kernel computes them,
    on the card (a check against the plain version's torch.pow; not
    counted)."""
    lib = _lib()
    out = torch.empty((2, counts), dtype=torch.float32, device="cuda")
    check(lib, lib.fused_update_bias_sweep(
        out[0].data_ptr(), out[1].data_ptr(), counts,
        torch.cuda.current_stream(out.device).cuda_stream), "fused_update bias sweep")
    return out[0], out[1]


def fused_adam_polyak(params, grads, opt: OptState, targets, lr, tau):
    """One fused step: (params, opt) <- Adam(params, grads, opt, lr);
    targets <- tau * new_params + (1 - tau) * targets. Returns (new_params,
    OptState(mu, nu, count + 1), new_targets); on the card the new trees
    are views into one fresh buffer, and the inputs are left as they
    were."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    if device.type == "cpu":
        return fused_adam_polyak_reference(params, grads, opt, targets, lr, tau)
    if device.type != "cuda":
        raise RuntimeError(f"fused_update kernel needs a CUDA device, got {device}")
    trees = [tree_leaves(t) for t in (params, opt.mu, opt.nu, grads, targets)]
    kinds = {(x.dtype, x.device) for t in trees for x in t}
    if kinds != {(torch.float32, device)}:
        raise ValueError(f"fused_adam_polyak takes float32 leaves on {device}, got {kinds}")
    shapes = tuple(x.shape for x in leaves)
    if any(tuple(x.shape for x in t) != shapes for t in trees[1:]):
        raise ValueError("fused_adam_polyak: the trees' leaf shapes differ")
    count = opt.count
    if (count.dtype, count.device, count.numel()) != (torch.int32, device, 1):
        raise ValueError(f"fused_adam_polyak takes an int32 count of one element on {device}, "
                         f"got {count.dtype} {tuple(count.shape)} on {count.device}")
    lib = _lib()
    layout = plan(shapes)
    # A leaf that is not contiguous is copied first (the port's trees have
    # none); `inputs` keeps every input alive until the launches are queued.
    inputs = [[x.contiguous() for x in t] for t in trees]
    in_ptrs = [[x.data_ptr() for x in t] for t in inputs]
    out = torch.empty(4 * layout.stride, dtype=torch.float32, device=device)
    new_count = torch.empty_like(count)
    stream = torch.cuda.current_stream(device).cuda_stream
    for launch in layout.launches:
        table = leaf_table(layout, launch, in_ptrs, out.data_ptr(), count.data_ptr(),
                           new_count.data_ptr(), lr, tau)
        check(lib, lib.fused_update_launch(table, launch.blocks, 0, stream))
        KERNEL_LAUNCHES["fused_update"] += 1
    it = iter([out.as_strided(size, strides, offset) for size, strides, offset in layout.views])

    def tree():
        return tuple({"w": next(it), "b": next(it)} for _ in params)

    new_params, mu, nu, new_targets = tree(), tree(), tree(), tree()
    return new_params, OptState(mu=mu, nu=nu, count=new_count), new_targets
