"""The device apply's checks (serve/server.py, backend 'jax'), shared by
chip_smoke.py's phase 4f and tests/test_torch_on_card.py, and run on the
CPU by tests/test_torch_serve.py: the apply at 2x256 and max_batch 32,
n = 1, 7 and 32, against the numpy oracle, the same apply on the CPU and
a full batch's rows, with stale values in the pad rows' buffer; a seqlock
refresh served from the next batch on; and the synchronizing calls an
apply makes. The caller turns TF32 off on the card first
(torch.backends.cuda.matmul.allow_tf32 = False).
"""

from __future__ import annotations

import multiprocessing as mp
import warnings

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import actor_head_dim, layout_size, param_layout

HIDDEN = (256, 256)
MAX_BATCH = 32
BATCH_SIZES = (1, 7, MAX_BATCH)
PAD_GARBAGE = 1e6      # written where the pad rows go before every checked apply


def layout_of(obs: int, act: int, sac: bool = False):
    return param_layout(obs, actor_head_dim(act, sac), HIDDEN)


def flat_params(layout, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(layout_size(layout)) * 0.1).astype(np.float32)


def make_server(layout, act: int, device: str = "cuda", backend: str = "jax", **kw):
    """An InferenceServer on a box of half-width 2 (Pendulum's), max_batch
    MAX_BATCH, seed 7; `device` only for the device backend."""
    from distributed_ddpg_tpu_torch.serve import InferenceServer

    return InferenceServer(layout, np.full(act, 2.0, np.float32), backend=backend,
                           max_batch=MAX_BATCH, seed=7,
                           **({"device": device} if backend == "jax" else {}), **kw)


def check_apply(obs: int, act: int, sac: bool, device: str = "cuda", atol: float = 1e-5,
                seed: int = 0):
    """The apply on `device` for n in BATCH_SIZES, the pad rows' buffer
    filled with PAD_GARBAGE before each call, within `atol` of the numpy
    oracle, of the same apply on the CPU and of the same rows of a full
    batch. Raises AssertionError outside it; returns (largest difference,
    whether every answer was bit-identical to the full batch's rows,
    the server on `device`)."""
    layout = layout_of(obs, act, sac)
    flat = flat_params(layout, seed)
    srv = make_server(layout, act, device, sac=sac)
    others = (make_server(layout, act, "cpu", sac=sac),
              make_server(layout, act, backend="numpy", sac=sac))
    for s in (srv, *others):
        s.refresh(flat)
    if srv.device.type != device.split(":")[0]:
        raise AssertionError(f"the apply runs on {srv.device}, not {device}")
    x = np.random.default_rng(seed + 1).standard_normal((MAX_BATCH, obs)).astype(np.float32)
    whole = srv._compute(x)
    width = 2 * act if sac else act
    err, same = 0.0, True
    for n in BATCH_SIZES:
        srv._in_host.fill_(PAD_GARBAGE)
        got = srv._compute(x[:n])
        if got.shape != (n, width):
            raise AssertionError(f"the apply gave {got.shape} rows, not {(n, width)}")
        for want in (*(o._compute(x[:n]) for o in others), whole[:n]):
            err = max(err, float(np.max(np.abs(got - want))))
        same = same and np.array_equal(got, whole[:n])
    if not err <= atol:
        raise AssertionError(f"the apply at obs {obs} act {act} sac {sac} on {device} is "
                             f"{err} from the oracle, the CPU or a full batch (atol {atol})")
    return err, same, srv


def check_seqlock_refresh(device: str = "cuda", atol: float = 1e-5):
    """Pendulum 2x256 on `device` with a broadcast buffer as its param
    source (version 2): the first batch serves params a; with b written
    and the version odd (a write in progress) a still serves; at version 4
    b serves from the next batch on, each within `atol` of the numpy
    oracle. Raises AssertionError otherwise; returns the server."""
    layout = layout_of(3, 1)
    ctx = mp.get_context("spawn")
    shared = ctx.Array("f", layout_size(layout), lock=False)
    version = ctx.Value("l", 0)
    view = np.frombuffer(shared, dtype=np.float32)
    a, b = flat_params(layout, 1), flat_params(layout, 2)
    view[:] = a
    version.value = 2
    srv = make_server(layout, 1, device, param_source=(shared, version))
    oracle = make_server(layout, 1, backend="numpy")
    x = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    oracle.refresh(a)
    want_a = oracle._compute(x)
    oracle.refresh(b)
    want_b = oracle._compute(x)
    first = srv._apply_batch(x)
    view[:] = b
    version.value = 3                      # mid-write: the old params serve
    torn = srv._apply_batch(x)
    version.value = 4                      # consistent: the next batch serves them
    fresh = srv._apply_batch(x)
    for got, want, what in ((first, want_a, "the first batch"), (torn, want_a, "an odd version"),
                            (fresh, want_b, "the batch after the refresh")):
        if not float(np.max(np.abs(got - want))) <= atol:
            raise AssertionError(f"the seqlock refresh on {device}: {what} served the wrong "
                                 "params")
    return srv


def count_syncs(srv, reps: int = 5) -> int:
    """The synchronizing calls `reps` applies of a full batch make on the
    card (torch's sync debug mode, 'warn'); the wait on the apply's own
    event is not one."""
    import torch

    x = np.random.default_rng(4).standard_normal((MAX_BATCH, srv.obs_dim)).astype(np.float32)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(reps):
                srv._compute(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)
