"""Times the fused Adam + Polyak update (K2) and the scan route that runs it,
for several trees of this repository, in alternation, on one card.

    python3 -m distributed_ddpg_tpu_torch.tools.ab_update TREE [TREE ...] \
        [--rounds 1] [--chunks 2]

Each TREE is the root of a checkout (the directory that holds
chip_smoke.py and distributed_ddpg_tpu_torch/), for example the parent
commit unpacked with `git archive` into a git-ignored directory, and `.`.
Each round runs the trees in order and then in reverse (A B B A for two),
each in a fresh child process whose PYTHONPATH is that tree, so the
tree's own package, kernel source and chip_smoke.py are the ones used.

A child builds its tree's fused update and times, at the main path's
shapes (Pendulum obs 3 / act 1, 2x256 nets, the state and gradients of
its chip_smoke.update_trees): the wrapper `fused_adam_polyak` on the DDPG
critic and actor, as device time in a CUDA graph (chip_smoke.graph_ms)
and as host time launched eagerly (chip_smoke.time_ms, 300 calls); then
the scan route's chunk with fused_update=True at K = 800 (batch 64, the
state and batch of chip_smoke's scan timing): `chunks` chunks after one
warm-up, host enqueue included, in us a step; and torch.profiler over a
chunk of chip_smoke.PROFILE_STEPS steps, for the device operations
(kernels, copies, sets) and the device time a step, whose ratio to the
step time is the card's busy share. Each child prints one JSON line; the
last line is the median of each figure per tree over the rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

K, OBS, ACT = 800, 3, 1


def child(chunks: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import _build
    from distributed_ddpg_tpu_torch.ops import fused_update as fu
    from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["fused_update"])
    figures = {}
    for net in ("critic", "actor"):
        params, opt, targets, grads_at = cs.update_trees(f"ddpg_{net}")
        grads = grads_at(0, params)

        def call():
            fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 1e-3)

        figures[f"{net} wrapper device us"] = cs.graph_ms(call) * 1e3
        figures[f"{net} wrapper host us"] = cs.time_ms(call, reps=300) * 1e3

    cfg = DDPGConfig(fused_update=True, fused_chunk="off")
    state = train_state_from_numpy(cs.random_state_np(cfg, OBS, ACT, seed=7), "cuda")
    packed = cs.random_batches(seed=8, k=K, b=cfg.batch_size, obs=OBS, act=ACT,
                               weighted=False)
    scan = make_scan_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K)
    step_us = cs.time_ms(lambda: scan(state, packed, None, step0=1000), reps=chunks) * 1e3 / K
    few = make_scan_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=cs.PROFILE_STEPS)
    short = packed[:cs.PROFILE_STEPS].contiguous()
    few(state, short, None, step0=1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        few(state, short, None, step0=1000)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sum(e.count for e in device) / cs.PROFILE_STEPS
    busy_us = sum(e.self_device_time_total for e in device) / cs.PROFILE_STEPS
    figures.update({"scan us/step": step_us, "scan device ops/step": ops,
                    "scan device us/step": busy_us, "scan busy share": busy_us / step_us})
    print(json.dumps({"tree": os.getcwd(), "card": cs.card_line(), "figures": figures}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.chunks)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    from distributed_ddpg_tpu_torch.tools._ab import alternate

    medians = alternate(os.path.abspath(__file__), args.trees, args.rounds,
                        ["--chunks", str(args.chunks)], "figures")
    print(json.dumps({"median": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
