"""Adam + Polyak of one parameter tree in ONE launch of a hand-written CUDA kernel.

Replaces distributed_ddpg_tpu/ops/fused_update.py (fused_adam_polyak ->
_fused_flat -> pl.pallas_call, kernel body _kernel): for every element of
the flattened tree, Adam's moments, the bias-corrected param and the
Polyak target in one element-wise pass (csrc/fused_update.cu). The scan
route's step calls it twice when fused_update=True, critic first, then
actor (learner.make_learner_step, as learner.py:417-430 of the JAX
package), for DDPG and D4PG.

- `fused_adam_polyak` is the wrapper, with the JAX signature. It gathers
  each of the five trees (params, both moments, targets, gradients) into a
  fresh flat f32 buffer (the counterpart of ravel_pytree; one C++ call
  each), computes the bias corrections 1 - B^c on the device from the
  carried count with ops/optim.adam_update's own expression (no host read
  of the count), launches the kernel, which updates four of the buffers
  in place, and returns views into them shaped as the input trees. On a
  CUDA tensor it launches the kernel (counted in
  KERNEL_LAUNCHES["fused_update"]) or raises; on the CPU it runs the
  plain version.
- `fused_adam_polyak_reference` is the plain version: ops/optim.adam_update
  then ops/polyak.polyak_update. The kernel computes the same operations in
  the same order with the same f32 constants, so on the card the two agree
  bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
from distributed_ddpg_tpu_torch.ops.optim import B1, B2, adam_update, tree_leaves
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update
from distributed_ddpg_tpu_torch.types import OptState

# Threads a block (the kernel's NT), and at most this many blocks a launch
# (16 a streaming multiprocessor of an H100); the kernel's loop strides
# over the rest.
THREADS = 256
MAX_BLOCKS = 132 * 16


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
        lib.fused_update_launch.argtypes = (
            [ptr] * 7 + [ctypes.c_float] * 3 + [ctypes.c_longlong, ctypes.c_int, ptr])
        lib.fused_update_launch.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _views(flat: torch.Tensor, like):
    """The params tree `like` (a tuple of {"w", "b"}) as views into flat."""
    it = iter(_unflatten_dense_tensors(flat, tree_leaves(like)))
    return tuple({k: next(it) for k in ("w", "b")} for _ in like)


def fused_adam_polyak(params, grads, opt: OptState, targets, lr, tau):
    """One fused step: (params, opt) <- Adam(params, grads, opt, lr);
    targets <- tau * new_params + (1 - tau) * targets. Returns (new_params,
    OptState(mu, nu, count + 1), new_targets); on the card the new trees
    are views into fresh flat buffers, and the inputs are left as they
    were."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    if device.type == "cpu":
        return fused_adam_polyak_reference(params, grads, opt, targets, lr, tau)
    if device.type != "cuda":
        raise RuntimeError(f"fused_update kernel needs a CUDA device, got {device}")
    trees = [tree_leaves(t) for t in (params, opt.mu, opt.nu, targets, grads)]
    kinds = {(x.dtype, x.device) for t in trees for x in t}
    if kinds != {(torch.float32, device)}:
        raise ValueError(f"fused_adam_polyak takes float32 leaves on {device}, got {kinds}")
    shapes = [x.shape for x in leaves]
    if any([x.shape for x in t] != shapes for t in trees[1:]):
        raise ValueError("fused_adam_polyak: the trees' leaf shapes differ")
    lib = _lib()
    p, m, v, t, g = (_flatten_dense_tensors(t) for t in trees)
    n = p.numel()
    # The bias corrections, on the device, as adam_update computes them.
    count = opt.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(B1, c)
    bc2 = 1.0 - torch.pow(B2, c)
    blocks = max(1, min(MAX_BLOCKS, -(-n // THREADS)))
    code = lib.fused_update_launch(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), t.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), float(lr), float(tau), 1.0 - float(tau), n, blocks,
        torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"fused_update launch failed: CUDA error {code} "
            f"({lib.fused_update_error_string(code).decode()})")
    KERNEL_LAUNCHES["fused_update"] += 1
    return (_views(p, params), OptState(mu=_views(m, params), nu=_views(v, params), count=count),
            _views(t, params))
