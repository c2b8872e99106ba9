"""Chip smoke test of the PyTorch/CUDA port (distributed_ddpg_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises; nothing is caught and passed over):

1. Require CUDA; print the card's name and power limit; turn TF32 off for
   matmul and cuDNN (the kernels and their plain versions are true f32).
2. Build every kernel of the port from csrc/ (one nvcc per source, all
   started together).
3. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs, from one random TrainState carried in with
   train_state_from_numpy: the learner chunk (ops/fused_chunk.py) at
   Pendulum shapes (obs 3, act 1) and at the bench's (obs 17, act 6),
   2x256 nets, batch 64, K = 16 and K = 800 (the main path's chunk).
4. Drive the main path, `distributed_ddpg_tpu_torch.train` (Pendulum-v1,
   2x256, batch 64, f32, one actor process, K = 800), with the launch
   counts zeroed just before and read just after: every chunk must have
   been one kernel launch, learner_steps = chunks x K, metrics finite.
5. Time each kernel at the main path's shapes (CUDA events, warmed up)
   beside its plain version and its bound; the eager autograd step x K is
   printed as context only. Then break the kernel's time down into its
   barriers, its optimizer pass and each stage's tiles.

It imports nothing of JAX or of the JAX package. The second-to-last line
is the kernels' JSON record; the last line is the device record.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at the full 700 W
# power limit): f32 on the CUDA cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel-vs-plain tolerances. Both are f32 with different summation orders
# (16x16 tiles vs cuBLAS) and FMA contraction, so one step's gradients agree
# to ~1e-7 relative. Adam divides by sqrt(v): where a gradient is itself at
# the rounding level of its sum, the two can take different Adam steps, each
# at most ~lr (1e-3 for the critic). So the end state must agree within
# STATE_TOL everywhere, and within TIGHT_TOL on all but a TIGHT_FRAC share
# of its elements (a wrong kernel misses on most of them, not a few); td
# and the metrics, computed from the drifting params, within OUT_TOL.
STATE_TOL = dict(rtol=1e-4, atol=1e-3)
TIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT_FRAC = 1e-3
OUT_TOL = dict(rtol=1e-3, atol=1e-4)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def random_state_np(cfg, obs: int, act: int, seed: int):
    """A TrainState with numpy leaves: random params near the init
    scale, targets near the params, nonzero Adam moments, count 1000 —
    a state in mid-training rather than at init."""
    from distributed_ddpg_tpu_torch.ops.fused_chunk import _net_dims
    from distributed_ddpg_tpu_torch.types import OptState, TrainState

    rng = np.random.default_rng(seed)
    adims, cdims = _net_dims(cfg, obs, act)

    def net(dims, fn):
        return tuple(
            {"w": fn((i, o), i, j == len(dims) - 1), "b": fn((o,), i, j == len(dims) - 1)}
            for j, (i, o) in enumerate(dims)
        )

    def param(shape, fan_in, final):
        bound = 3e-3 if final else 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def near(tree):
        return tuple({k: (v + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
                      for k, v in layer.items()} for layer in tree)

    def opt(dims):
        return OptState(
            mu=net(dims, lambda s, i, f: (1e-3 * rng.standard_normal(s)).astype(np.float32)),
            nu=net(dims, lambda s, i, f: rng.uniform(1e-6, 1e-4, s).astype(np.float32)),
            count=np.int32(1000),
        )

    actor, critic = net(adims, param), net(cdims, param)
    return TrainState(actor, critic, near(actor), near(critic), opt(adims), opt(cdims),
                      np.int32(1000))


def random_batches(seed: int, k: int, b: int, obs: int, act: int) -> torch.Tensor:
    from distributed_ddpg_tpu_torch.types import pack_batch_np

    rng = np.random.default_rng(seed)
    packed = pack_batch_np({
        "obs": rng.standard_normal((k, b, obs)).astype(np.float32),
        "action": rng.uniform(-2, 2, (k, b, act)).astype(np.float32),
        "reward": rng.standard_normal((k, b)).astype(np.float32),
        "discount": np.full((k, b), 0.99, np.float32),
        "next_obs": rng.standard_normal((k, b, obs)).astype(np.float32),
        "weight": np.ones((k, b), np.float32),
    })
    return torch.from_numpy(packed).cuda()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_fused_chunk(cfg, obs: int, act: int, k: int) -> float:
    """Kernel vs plain version on one random state and batch; returns the
    largest absolute difference over end state, td and metrics."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=obs), "cuda")
    packed = random_batches(seed=100 + obs, k=k, b=cfg.batch_size, obs=obs, act=act)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
    new, td, met = run(state, packed)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0)
    torch.cuda.synchronize()
    pairs = [
        ("state", fc.flatten_state(new), fc.flatten_state(ref)),
        ("td", td, rtd),
        ("metrics", torch.stack([met[n] for n in METRIC_KEYS]),
         torch.stack([rmet[n] for n in METRIC_KEYS])),
    ]
    groups = ("actor", "critic", "target_actor", "target_critic",
              "actor_mu", "actor_nu", "critic_mu", "critic_nu")
    prog = fc._plan(cfg, obs, act)
    sizes = [prog.n_actor, prog.n_critic] * 4
    worst = 0.0
    for name, got, want in pairs:
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"fused_chunk obs={obs} K={k}: non-finite {name}")
        err = np.abs(got - want)
        worst = max(worst, float(err.max()))
        tol = STATE_TOL if name == "state" else OUT_TOL
        np.testing.assert_allclose(got, want, **tol,
                                   err_msg=f"fused_chunk obs={obs} K={k} {name}")
        line = f"  fused_chunk obs={obs} act={act} K={k} {name}: max_abs_err={err.max():.3e}"
        if name == "state":
            loose = err > TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(want)
            frac = float(loose.mean())
            where = {g: int(n) for g, n in zip(groups, np.add.reduceat(
                loose.astype(np.int64), np.cumsum([0] + sizes[:-1]))) if n}
            line += f", outside {TIGHT_TOL}: {frac:.2e} of elements {where}"
            if frac > TIGHT_FRAC:
                raise AssertionError(f"fused_chunk obs={obs} K={k}: {line}")
        log(line)
    if int(new.actor_opt.count) != 1000 + k or int(new.step) != 1000 + k:
        raise AssertionError("fused_chunk counts did not advance by K")
    return worst


def breakdown(run, state, packed, k: int) -> None:
    """Where the kernel's time goes: the same launch with every stage's
    tiles turned off (barriers + optimizer pass), with the optimizer off
    too (barriers alone), and with one stage's tiles at a time on top of
    the barriers. Restores the launch parameters afterwards."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    ip, saved = run.ip, run.ip.clone()
    n_stages = len(run.program.stage_tiles)
    tiles = slice(fc.IP_STAGE_TILES, fc.IP_STAGE_TILES + n_stages)

    def us_per_step() -> float:
        return time_ms(lambda: run(state, packed), reps=3) * 1e3 / k

    try:
        ip[tiles] = 0
        barriers_opt = us_per_step()
        ip[fc.IP_NA] = ip[fc.IP_NC] = 0
        barriers = us_per_step()
        per_stage = []
        for s in range(n_stages):
            ip[tiles] = 0
            ip[fc.IP_STAGE_TILES + s] = saved[fc.IP_STAGE_TILES + s]
            per_stage.append(us_per_step() - barriers)
    finally:
        ip.copy_(saved)
    log(f"[breakdown] us/step: {n_stages + 1} barriers {barriers:.2f} "
        f"({barriers / (n_stages + 1):.2f} each), optimizer pass "
        f"{barriers_opt - barriers:.2f}, stage tiles "
        + ", ".join(f"s{s}({run.program.stage_tiles[s]}) {t:.2f}"
                    for s, t in enumerate(per_stage)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2. build every kernel ---
    from distributed_ddpg_tpu_torch.ops import _build

    t0 = time.monotonic()
    reports = _build.build_all(["fused_chunk"])
    log(f"[build] {time.monotonic() - t0:.1f}s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # --- 3. kernels against their plain versions ---
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import (
        METRIC_KEYS,
        make_learner_step,
        train_state_from_numpy,
    )
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.types import unpack_batch

    cfg = DDPGConfig()                        # 2x256, batch 64, f32, cuda
    K = resolve_learner_chunk(cfg)            # the main path's chunk (800)
    log("[parity] fused_chunk kernel vs fused_chunk_reference on the card")
    errs = {}
    for obs, act in ((3, 1), (17, 6)):
        for k in (16, K):
            errs[(obs, k)] = check_fused_chunk(cfg, obs, act, k)

    # --- 4. the main path ---
    from distributed_ddpg_tpu_torch.train import train

    # 20k env steps: ~50 chunks, so the rates are the steady state's and
    # not the first chunk's one-time costs.
    main_cfg = DDPGConfig(num_actors=1, replay_min_size=1000, total_env_steps=20_000,
                          eval_every=0, eval_episodes=2)
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(main_cfg, echo=False)
    launches = dict(fc.KERNEL_LAUNCHES)
    log(f"[main path] {time.monotonic() - t0:.1f}s: "
        + json.dumps({k: v for k, v in summary.items()}))
    if summary["chunks"] < 1 or launches.get("fused_chunk", 0) != summary["chunks"]:
        raise AssertionError(f"kernel launches {launches} != chunks {summary['chunks']}")
    if summary["learner_steps"] != summary["chunks"] * K:
        raise AssertionError("learner_steps != chunks x K")
    for key in (*METRIC_KEYS, "final_return"):
        if not math.isfinite(summary[key]):
            raise AssertionError(f"main path {key} = {summary[key]} is not finite")

    # --- 5. timing at the main path's shapes ---
    obs, act, B = 3, 1, cfg.batch_size
    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=7), "cuda")
    packed = random_batches(seed=8, k=K, b=B, obs=obs, act=act)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=K, device="cuda")
    kernel_ms = time_ms(lambda: run(state, packed), reps=10)
    plain_ms = time_ms(lambda: fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0), reps=2)
    step = make_learner_step(cfg, 2.0)
    eager_steps = 50

    def eager():
        s = state
        for i in range(eager_steps):
            s = step(s, unpack_batch(packed[i], obs, act)).state

    eager_ms = time_ms(eager, reps=1) * K / eager_steps
    ops = fc.ops_per_chunk(cfg, obs, act, K)
    nbytes = 2 * fc.state_bytes(cfg, obs, act) + packed.numel() * 4 + K * B * 4 + 6 * 4
    bound_ops_ms, bound_bytes_ms = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    log(f"[timing] {card}: fused_chunk K={K}: {kernel_ms:.3f} ms/chunk = "
        f"{kernel_ms * 1e3 / K:.2f} us/step; plain {plain_ms:.3f} ms; eager autograd "
        f"step x K {eager_ms:.3f} ms (context); bound {bound_ms:.4f} ms "
        f"({ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    breakdown(run, state, packed, K)
    log(f"[done] {time.monotonic() - t_start:.1f}s")

    print(json.dumps({"kernels": [{
        "name": "fused_chunk",
        "route": "cuda",
        "source": "distributed_ddpg_tpu_torch/csrc/fused_chunk.cu",
        "replaces": "distributed_ddpg_tpu/ops/fused_chunk.py:992",
        "launches": launches.get("fused_chunk", 0),
        "max_abs_err": errs[(3, K)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
