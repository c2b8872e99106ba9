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
   2x256 nets, batch 64 -- its DDPG branch at K = 16 and K = 800 (the main
   path's chunk), its TD3 branch at K = 16 and 800 with policy_delay=2,
   target_noise=0.2 (one noise stream drawn on the card, given to both)
   and at K = 16 with policy_delay=1, target_noise=0 (no noise input),
   from an odd step so the delay schedule is offset. One case, TD3 at the
   bench's shape over K = 800, may instead be refereed by the chunk in
   float64 (SHARE_RATIO, DRIFT_RATIO).
4. Drive the main paths, `distributed_ddpg_tpu_torch.train` (Pendulum-v1,
   2x256, batch 64, f32, one actor process, K = 800): DDPG with the
   default flags, then TD3 with --twin_critic=true --policy_delay=2
   --target_noise=0.2. For each, the launch counts are zeroed just before
   and read just after: every chunk must have been one launch of that
   branch's kernel, learner_steps = chunks x K, metrics finite.
5. Time each branch of the kernel at the main path's shapes (CUDA events,
   warmed up) beside its plain version and its bound; the eager autograd
   step x K is printed as context only. Then break each branch's time
   down into its barriers, its optimizer pass and each stage's tiles.

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
# These hold every check but one. TD3 at the bench's shape (obs 17, act 6)
# over K = 800 steps from step 1001 amplifies rounding: a ReLU mask that
# flips on a rounding difference changes a gradient by a whole upstream
# term, Adam turns that into a step of ~lr, and the gap then grows step
# by step. On an H100 (700 W) the f32 plain version itself ended 6.7e-3 from
# the same chunk in float64 in the critic and 4.0e-3 in td, the kernel
# 1.3e-2 and 2.8e-3, and the two f32 runs differed beyond TIGHT_TOL in
# 11.8% of the state's elements. Whether a run meets such a flip depends on
# the data and the rounding, not on the code being right: on the CPU with
# 64-wide nets the plain DDPG chunk drifts so from its float64 twin and
# TD3 does not. In that one case an output that fails the tolerances above
# is refereed by the exact chunk (the plain version in float64), per state
# group, td and each metric: the share of elements where the kernel misses
# it by more than TIGHT_TOL may be at most SHARE_RATIO times the f32 plain
# version's own share plus TIGHT_FRAC, and no element may miss it by more
# than DRIFT_RATIO times the plain version's largest miss plus TIGHT_TOL.
# Measured there: the kernel's share was at most 0.91x the plain version's
# (critic_mu), its largest miss at most 1.87x (critic). With a critic bias
# correction one step late, target_critic's share rose to 2.8x.
SHARE_RATIO = 1.5
DRIFT_RATIO = 3.0


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def random_state_np(cfg, obs: int, act: int, seed: int, step: int = 1000):
    """A TrainState with numpy leaves: random params near the init
    scale, targets near the params, nonzero Adam moments, both counts
    1000 and the given step — a state in mid-training rather than at
    init. A TD3 config gets two independent critics on a [2, ...] axis."""
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

    def critic_net(fn):
        if not cfg.twin_critic:
            return net(cdims, fn)
        a, b = net(cdims, fn), net(cdims, fn)
        return tuple({k: np.stack([la[k], lb[k]]) for k in la} for la, lb in zip(a, b))

    def critic_opt():
        return OptState(
            mu=critic_net(lambda s, i, f: (1e-3 * rng.standard_normal(s)).astype(np.float32)),
            nu=critic_net(lambda s, i, f: rng.uniform(1e-6, 1e-4, s).astype(np.float32)),
            count=np.int32(1000),
        )

    actor, critic = net(adims, param), critic_net(param)
    return TrainState(actor, critic, near(actor), near(critic), opt(adims), critic_opt(),
                      np.int32(step))


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


def noise_for(cfg, k: int, b: int, act: int, step: int):
    """TD3's smoothing noise for a chunk, drawn on the card, or None."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    if not cfg.takes_noise:
        return None
    return fc.td3_noise_eps(cfg, torch.Generator(device="cuda"), step, k, b, act)


def to_double(tree):
    """A TrainState (or any tuple/dict tree of tensors) in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: to_double(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [to_double(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def check_fused_chunk(cfg, obs: int, act: int, k: int, step: int = 1000,
                      referee: bool = False) -> float:
    """Kernel vs plain version on one random state and batch (and noise);
    returns the largest absolute difference over end state, td and
    metrics. Raises where an output is outside the tolerances; with
    `referee` (one drifting case, see SHARE_RATIO) such an output is held
    against the plain version in float64 instead."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    label = (f"fused_chunk_td3 delay={cfg.policy_delay} noise={cfg.target_noise}"
             if cfg.twin_critic else "fused_chunk")
    label += f" obs={obs} act={act} K={k}"
    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=obs, step=step), "cuda")
    packed = random_batches(seed=100 + obs, k=k, b=cfg.batch_size, obs=obs, act=act)
    eps = noise_for(cfg, k, cfg.batch_size, act, step)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
    new, td, met = run(state, packed, eps)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0, eps)
    torch.cuda.synchronize()

    def outputs(s, t, m):
        return {"state": fc.flatten_state(s), "td": t,
                "metrics": torch.stack([m[n] for n in METRIC_KEYS])}

    got_all, want_all = outputs(new, td, met), outputs(ref, rtd, rmet)
    groups = ("actor", "critic", "target_actor", "target_critic",
              "actor_mu", "actor_nu", "critic_mu", "critic_nu")
    prog = fc._plan(cfg, obs, act)
    cuts = np.cumsum([0] + [prog.n_actor, prog.n_critic] * 4)
    worst, failed = 0.0, []
    for name in got_all:
        got = got_all[name].double().cpu().numpy()
        want = want_all[name].double().cpu().numpy()
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{label}: non-finite {name}")
        err = np.abs(got - want)
        worst = max(worst, float(err.max()))
        tol = STATE_TOL if name == "state" else OUT_TOL
        ok = bool(np.all(err <= tol["atol"] + tol["rtol"] * np.abs(want)))
        line = f"  {label} {name}: max_abs_err={err.max():.3e}"
        if name == "state":
            loose = err > TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(want)
            frac = float(loose.mean())
            where = {g: int(n) for g, n in zip(groups, np.add.reduceat(
                loose.astype(np.int64), cuts[:-1])) if n}
            line += f", outside {TIGHT_TOL}: {frac:.2e} of elements {where}"
            ok = ok and frac <= TIGHT_FRAC
        if not ok:
            failed.append(name)
        log(line + ("" if ok else f" -- outside {tol} or TIGHT_FRAC"))
    if failed and not referee:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")
    if failed:
        exact, etd, emet = fc.fused_chunk_reference(
            cfg, to_double(state), packed.double(), 2.0, 0.0,
            None if eps is None else eps.double())
        exact_all = outputs(exact, etd, emet)
        bad = []
        for name in failed:
            got = got_all[name].double().cpu().numpy()
            want = want_all[name].double().cpu().numpy()
            ex = exact_all[name].cpu().numpy()
            if name == "state":
                pieces = [(g, slice(cuts[i], cuts[i + 1])) for i, g in enumerate(groups)]
            elif name == "td":
                pieces = [("td", slice(None))]
            else:
                pieces = [(n, slice(i, i + 1)) for i, n in enumerate(METRIC_KEYS)]
            for piece, sl in pieces:
                tight = TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(ex[sl])
                e_k, e_p = np.abs(got[sl] - ex[sl]), np.abs(want[sl] - ex[sl])
                share_k, share_p = float((e_k > tight).mean()), float((e_p > tight).mean())
                ok = (share_k <= SHARE_RATIO * share_p + TIGHT_FRAC
                      and bool(np.all(e_k <= DRIFT_RATIO * e_p.max() + tight)))
                log(f"  {label} {piece} against the float64 chunk: kernel max "
                    f"{e_k.max():.3e}, {share_k:.2e} outside TIGHT_TOL; f32 plain max "
                    f"{e_p.max():.3e}, {share_p:.2e}"
                    + ("" if ok else " -- fails SHARE_RATIO or DRIFT_RATIO"))
                if not ok:
                    bad.append(piece)
        if bad:
            raise AssertionError(
                f"{label}: {', '.join(bad)} farther from the float64 chunk than "
                f"SHARE_RATIO and DRIFT_RATIO allow")
    # The actor count advances by the chunk's actor updates (all K, or
    # under TD3's delay f(step0 + K) - f(step0)); the rest by K.
    want_a = 1000 + fc.actor_updates(cfg, step, k)
    if (int(new.actor_opt.count), int(new.critic_opt.count), int(new.step)) != (
            want_a, 1000 + k, step + k) or int(ref.actor_opt.count) != want_a:
        raise AssertionError(
            f"{label}: counts {int(new.actor_opt.count)}, {int(new.critic_opt.count)}, "
            f"{int(new.step)}; expected {want_a}, {1000 + k}, {step + k}")
    log(f"  {label}: actor count +{want_a - 1000} from step {step}")
    return worst


def breakdown(run, state, packed, eps, k: int) -> None:
    """Where the kernel's time goes: the same launch with every stage's
    tiles turned off (barriers + optimizer pass), with the optimizer off
    too (barriers alone), and with one stage's tiles at a time on top of
    the barriers (on update steps and, under TD3's delay, on the steps
    that skip the actor's backward). Restores the launch parameters
    afterwards."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    ip, saved = run.ip, run.ip.clone()
    prog = run.program
    n_stages = len(prog.stage_tiles)
    firsts = (fc.IP_STAGE_TILES, fc.IP_STAGE_TILES_SKIP)

    def us_per_step() -> float:
        return time_ms(lambda: run(state, packed, eps), reps=3) * 1e3 / k

    def tiles_off() -> None:
        for first in firsts:
            ip[first:first + n_stages] = 0

    skips = prog.stage_tiles_skip != prog.stage_tiles
    try:
        if skips:   # the actor's backward tiles run on every step
            ip[fc.IP_STAGE_TILES_SKIP:fc.IP_STAGE_TILES_SKIP + n_stages] = \
                saved[fc.IP_STAGE_TILES:fc.IP_STAGE_TILES + n_stages]
            unmasked = us_per_step()
        tiles_off()
        barriers_opt = us_per_step()
        ip[fc.IP_NA] = ip[fc.IP_NC] = 0
        barriers = us_per_step()
        per_stage = []
        for s in range(n_stages):
            tiles_off()
            for first in firsts:
                ip[first + s] = saved[first + s]
            per_stage.append(us_per_step() - barriers)
    finally:
        ip.copy_(saved)
    log(f"[breakdown] us/step: {n_stages + 1} barriers {barriers:.2f} "
        f"({barriers / (n_stages + 1):.2f} each), optimizer pass "
        f"{barriers_opt - barriers:.2f}, stage tiles "
        + ", ".join(f"s{s}({prog.stage_tiles[s]}"
                    + (f"/{prog.stage_tiles_skip[s]}" if skips else "") + f") {t:.2f}"
                    for s, t in enumerate(per_stage))
        + (" (tiles: update step / step without an actor update)" if skips else ""))
    if skips:
        log(f"[breakdown] with the actor's backward tiles run on every step too: "
            f"{unmasked:.2f} us/step")


def drive_main_path(flags, name: str) -> dict:
    """One run of `distributed_ddpg_tpu_torch.train` with these flags (the
    CLI's own parser), with the launch counts zeroed just before and read
    just after. Every chunk must be one launch of kernel `name`."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    cfg = DDPGConfig.from_flags(flags)
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False)
    launches = dict(fc.KERNEL_LAUNCHES)
    log(f"[main path {name}] {time.monotonic() - t0:.1f}s: " + json.dumps(summary))
    if summary["chunks"] < 1 or launches != {name: summary["chunks"]}:
        raise AssertionError(f"kernel launches {launches} != {summary['chunks']} x {name}")
    if summary["learner_steps"] != summary["chunks"] * resolve_learner_chunk(cfg):
        raise AssertionError("learner_steps != chunks x K")
    for key in (*METRIC_KEYS, "final_return"):
        if not math.isfinite(summary[key]):
            raise AssertionError(f"main path {name}: {key} = {summary[key]} is not finite")
    return launches


def time_branch(cfg, name: str, k: int, step: int, card: str, eager: bool) -> dict:
    """The kernel's time at the main path's shapes (Pendulum, K = k) beside
    its plain version and its bound, then its breakdown. Returns the
    timing fields of the kernel's record."""
    from distributed_ddpg_tpu_torch.learner import make_learner_step, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.types import unpack_batch

    obs, act, b = 3, 1, cfg.batch_size
    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=7, step=step), "cuda")
    packed = random_batches(seed=8, k=k, b=b, obs=obs, act=act)
    eps = noise_for(cfg, k, b, act, step)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
    kernel_ms = time_ms(lambda: run(state, packed, eps), reps=10)
    plain_ms = time_ms(
        lambda: fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0, eps), reps=2)
    context = ""
    if eager:
        step_fn, eager_steps = make_learner_step(cfg, 2.0), min(50, k)

        def eager_run():
            s = state
            for i in range(eager_steps):
                s = step_fn(s, unpack_batch(packed[i], obs, act)).state

        context = f"; eager autograd step x K {time_ms(eager_run, reps=1) * k / eager_steps:.3f} ms (context)"
    # The bound counts this run's work: the actor's backward, its Adam and
    # the Polyak updates only on the chunk's update steps.
    ops = fc.ops_per_chunk(cfg, obs, act, k, step)
    nbytes = (2 * fc.state_bytes(cfg, obs, act) + packed.numel() * 4
              + (eps.numel() * 4 if eps is not None else 0) + k * b * 4 + 6 * 4)
    bound_ops_ms, bound_bytes_ms = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    log(f"[timing] {card}: {name} K={k} from step {step}: {kernel_ms:.3f} ms/chunk = "
        f"{kernel_ms * 1e3 / k:.2f} us/step; plain {plain_ms:.3f} ms{context}; bound "
        f"{bound_ms:.4f} ms = {bound_ms * 1e3 / k:.3f} us/step ({ops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    breakdown(run, state, packed, eps, k)
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
    }


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
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk

    cfg = DDPGConfig()                        # 2x256, batch 64, f32, cuda
    td3 = cfg.replace(twin_critic=True, policy_delay=2, target_noise=0.2)
    td3_plain = cfg.replace(twin_critic=True)  # delay 1, no noise input
    K = resolve_learner_chunk(cfg)            # the main path's chunk (800)
    td3_step = 1001                           # odd: the delay schedule is offset
    log("[parity] fused_chunk kernel vs fused_chunk_reference on the card")
    errs = {}
    for obs, act in ((3, 1), (17, 6)):
        for k in (16, K):
            errs[("fused_chunk", obs, k)] = check_fused_chunk(cfg, obs, act, k)
            errs[("fused_chunk_td3", obs, k)] = check_fused_chunk(
                td3, obs, act, k, td3_step, referee=(obs, k) == (17, K))
        check_fused_chunk(td3_plain, obs, act, 16, td3_step)

    # --- 4. the main paths ---
    # 20k env steps: tens of chunks, so the rates are the steady state's
    # and not the first chunk's one-time costs.
    common = ["--num_actors=1", "--replay_min_size=1000", "--total_env_steps=20000",
              "--eval_every=0", "--eval_episodes=2"]
    launches = drive_main_path(common, "fused_chunk")
    launches.update(drive_main_path(
        common + ["--twin_critic=true", "--policy_delay=2", "--target_noise=0.2"],
        "fused_chunk_td3"))

    # --- 5. timing at the main path's shapes ---
    timing = {
        "fused_chunk": time_branch(cfg, "fused_chunk", K, 1000, card, eager=True),
        "fused_chunk_td3": time_branch(td3, "fused_chunk_td3", K, td3_step, card, eager=False),
    }
    log(f"[done] {time.monotonic() - t_start:.1f}s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "distributed_ddpg_tpu_torch/csrc/fused_chunk.cu",
        "replaces": "distributed_ddpg_tpu/ops/fused_chunk.py:992",
        "launches": launches[name],
        "max_abs_err": errs[(name, 3, K)],
        **timing[name],
        "library_ms": None,
    } for name in ("fused_chunk", "fused_chunk_td3")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
