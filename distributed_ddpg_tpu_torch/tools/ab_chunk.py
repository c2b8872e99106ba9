"""Times the learner chunk kernel of several trees of this repository, in
alternation, on one card.

    python3 -m distributed_ddpg_tpu_torch.tools.ab_chunk TREE [TREE ...] \
        [--rounds 2] [--reps 20]

Each TREE is the root of a checkout (the directory that holds
chip_smoke.py and distributed_ddpg_tpu_torch/), for example the parent
commit unpacked with `git archive` into a git-ignored directory, and `.`.
Each round runs the trees in order and then in reverse (A B B A for two),
each in a fresh child process whose PYTHONPATH is that tree, so the
tree's own package, kernel source and chip_smoke.py are the ones used.

A child builds its tree's kernel (printing ptxas's register and spill
report when it compiles) and times each branch the tree has at the main
path's shapes (Pendulum obs 3 / act 1, 2x256, batch 64, K = 800): DDPG
from step 1000, TD3 with policy_delay 2 and target_noise 0.2 from step
1001, D4PG at 51 atoms and SAC (README's learning rates, the temperature
learned) from step 1000 where the tree has them, and each of the four
again with compute_dtype='bfloat16' where the tree has that branch. The state, batch and
noise come from the tree's chip_smoke.py with the seeds its timing phase
uses (trees may differ in the batch's weight column, which does not
change the kernel's work). One warm-up chunk, then `reps` chunks between
two CUDA events. Each child prints one JSON line; the last line is the
median us/step per tree and branch over the rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

K, OBS, ACT = 800, 3, 1


def child(reps: int) -> None:
    import torch

    import chip_smoke as cs
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import _build
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    report = _build.build_all(["fused_chunk"])["fused_chunk"]
    cfg = DDPGConfig()
    branches = {
        "fused_chunk": (cfg, 1000),
        "fused_chunk_td3": (cfg.replace(twin_critic=True, policy_delay=2,
                                        target_noise=0.2), 1001),
    }
    if hasattr(cfg, "v_support_auto"):   # a tree with the D4PG branch
        branches["fused_chunk_d4pg"] = (
            cfg.replace(distributional=True, v_min=-10.0, v_max=10.0), 1000)
    if hasattr(cfg, "sac_autotune"):     # a tree with the SAC branch
        branches["fused_chunk_sac"] = (
            cfg.replace(sac=True, actor_lr=3e-4, critic_lr=3e-4, tau=0.005), 1000)
    if hasattr(fc, "rounded_product_ops"):   # a tree with the bf16 branch
        branches.update({f"{name}_bf16": (c.replace(compute_dtype="bfloat16"), step)
                         for name, (c, step) in list(branches.items())})
    times = {}
    for name, (c, step) in branches.items():
        state = train_state_from_numpy(cs.random_state_np(c, OBS, ACT, seed=7, step=step),
                                       "cuda")
        packed = cs.random_batches(seed=8, k=K, b=c.batch_size, obs=OBS, act=ACT)
        eps = cs.noise_for(c, K, c.batch_size, ACT, step)
        run = fc.make_fused_chunk_fn(c, OBS, ACT, 2.0, 0.0, chunk_size=K, device="cuda")
        times[name] = cs.time_ms(lambda: run(state, packed, eps), reps) * 1e3 / K
    print(json.dumps({
        "tree": os.getcwd(),
        "ptxas": [ln.strip() for ln in report.splitlines()
                  if "registers" in ln or "spill" in ln or "entry function" in ln],
        "us_per_step": times,
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    from distributed_ddpg_tpu_torch.tools._ab import alternate

    medians = alternate(os.path.abspath(__file__), args.trees, args.rounds,
                        ["--reps", str(args.reps)], "us_per_step")
    print(json.dumps({"median_us_per_step": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
