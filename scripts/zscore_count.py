"""Where the guarded learner's z-score skips come from: the PyTorch port
(distributed_ddpg_tpu_torch) against the JAX package, on the CPU.

The guardrails' detector (guardrails.make_guarded_step in both packages)
skips a step whose critic loss or critic grad norm sits more than zmax
standard deviations above its EWMA, and a skipped step never moves the
EWMA. Two modes:

  batches  Both packages' guarded steps, full width (2x256, batch 64,
           Pendulum-v1, zmax 8, warmup 64; the stock update, or with
           --fused_update K2 (JAX's Pallas kernel in interpret mode, the
           port's plain version on the CPU)), from one
           initial state (JAX's init, converted) over the SAME 2400
           batches: a ring that starts with --warm rows and takes --landed
           new rows before each of the 2nd and 3rd 800-step chunks, the
           rows rolled out by VectorPendulum with JAX's actor params of the
           moment plus OU noise, the batch indices from numpy. A third arm
           is the control: JAX again from its initial critic nudged one ULP,
           so it parts from JAX by f32 rounding alone. Prints each arm's skip
           count, the critic's relative L2 gap to JAX's at marked steps, the
           first step where an arm's skip flag parts from JAX's, and there
           both z-scores against JAX's margin to zmax.
  cli      Each package's CLI (python -m distributed_ddpg_tpu_torch.train /
           distributed_ddpg_tpu.train) with the guarded chip path's flags
           (--learner_chunk=800 --guardrails=true --fused_update=true
           --guardrail_rollback_k=0 --total_env_steps=10000), --runs times a
           --max_ingest_ratio (0 = free-running: the rows that land between
           chunks follow the actors' pace against the learner's; r > 0 caps
           the drained env steps at replay_min_size + r * learner steps,
           r = 1.28 lands 1024 rows a chunk, 3.84 lands 3072). Each run is
           a child process that wraps DeviceReplay.device_state to record
           the ring's size as each chunk draws from it. Prints every run's skips,
           guarded steps, env steps, the ring at each chunk and the rows
           that landed between chunks.

Each line printed is one JSON object. Run from the repo's root:

  python scripts/zscore_count.py batches --seeds 0 1 2 --landed 1024 3072
  python scripts/zscore_count.py batches --seeds 0 1 2 --landed 1024 3072 --fused_update
  python scripts/zscore_count.py cli --runs 3 --ratios 0 1.28 3.84
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ZMAX, WARMUP, CHUNK, CHUNKS = 8.0, 64, 800, 3
OBS, ACT = 3, 1


def _z(mean, var, x):
    """The detector's one-sided z-score, in float64 from its f32 inputs."""
    return (float(x) - float(mean)) / np.sqrt(float(var) + 1e-12)


def run_batches(seed: int, warm: int, landed: int, fused_update: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from distributed_ddpg_tpu import guardrails as jax_guard
    from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
    from distributed_ddpg_tpu.learner import init_train_state as jax_init
    from distributed_ddpg_tpu.learner import make_learner_step as jax_make_step
    from distributed_ddpg_tpu.types import Batch as JaxBatch
    from distributed_ddpg_tpu_torch import guardrails
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.envs.vector_envs import make_vector_env
    from distributed_ddpg_tpu_torch.learner import make_learner_step, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops.exploration import draw_step, vector_env_step
    from distributed_ddpg_tpu_torch.types import Batch

    torch.set_num_threads(1)
    jcfg = JaxConfig(seed=seed, fused_update=fused_update)
    cfg = DDPGConfig(seed=seed, device="cpu", fused_update=fused_update)
    scale = np.array([2.0], np.float32)
    jstep = jax_make_step(jcfg, scale)
    jraw = jax.jit(jstep)
    jguarded = jax.jit(jax_guard.make_guarded_step(jstep, ZMAX, WARMUP))
    pstep = make_learner_step(cfg, scale)
    pguarded = guardrails.make_guarded_step(pstep, ZMAX, WARMUP)
    jstate = jax_init(jcfg, OBS, ACT, seed)
    jg = jax_guard.init_guard_state()
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    pg = guardrails.guard_state_from_numpy(jax.tree.map(np.asarray, jg))

    # The rollout: 8 Pendulum envs, the actor params of the moment + OU.
    E = 8
    env = make_vector_env("Pendulum-v1", E, "cpu")
    gen = torch.Generator().manual_seed(1000 + seed)
    on = dict(dtype=torch.float32)
    low, high = torch.tensor(env.action_low, **on), torch.tensor(env.action_high, **on)
    sc, off = torch.tensor(scale), torch.zeros(1)
    env_state = env.init(env.draw_reset(gen))
    obs = env.observe(env_state)
    ou = torch.zeros((E, ACT))
    ring = []

    def roll(n_rows):
        nonlocal env_state, obs, ou
        params = train_state_from_numpy(jax.tree.map(np.asarray, jstate)).actor_params
        for _ in range(n_rows // E):
            d = draw_step(env, ACT, gen, low, high, False)
            ou, _, out, rows = vector_env_step(cfg, env, params, env_state, obs, ou, sc, off,
                                               low, high, d)
            env_state, obs = out.state, out.obs
            ring.append(rows.numpy())

    # The control arm: JAX again, its initial critic nudged one ULP up, so
    # the two JAX arms differ by f32 rounding alone from the first step.
    nstate = jstate._replace(critic_params=jax.tree.map(
        lambda x: jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf))),
        jstate.critic_params))
    ng = jg

    def critic_flat(state):
        if isinstance(state.critic_params[0]["w"], torch.Tensor):
            leaves = [layer[k].numpy() for layer in state.critic_params for k in ("w", "b")]
        else:
            leaves = [np.asarray(layer[k]) for layer in state.critic_params for k in ("w", "b")]
        return np.concatenate([x.reshape(-1) for x in leaves]).astype(np.float64)

    def rel_gap(a, b):
        fa, fb = critic_flat(a), critic_flat(b)
        return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))

    def zscores(g, m):
        return (_z(g.loss_mean, g.loss_var, m["critic_loss"]),
                _z(g.gnorm_mean, g.gnorm_var, m["critic_grad_norm"]))

    rng = np.random.default_rng(seed)
    flags = {"jax": [], "port": [], "nudged": []}
    parted = {"port": None, "nudged": None}
    gaps = {"port": {}, "nudged": {}}
    marks = {1, 10, 100, 200, 400, 800, 1200, 1600, 2000, 2400}
    for c in range(CHUNKS):
        roll(warm if c == 0 else landed)
        data = np.concatenate(ring)
        for _ in range(CHUNK):
            rows = data[rng.integers(0, len(data), cfg.batch_size)]
            fields = dict(obs=rows[:, :3], action=rows[:, 3:4], reward=rows[:, 4],
                          discount=rows[:, 5], next_obs=rows[:, 6:9], weight=rows[:, 9])
            jb = JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
            pb = Batch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
            z = {"jax": zscores(jg, jraw(jstate, jb).metrics),
                 "port": zscores(pg, pstep(pstate, pb).metrics),
                 "nudged": zscores(ng, jraw(nstate, jb).metrics)}
            before = {"jax": int(jg.skipped), "port": int(pg.skipped), "nudged": int(ng.skipped)}
            pre = {"port": rel_gap(pstate, jstate), "nudged": rel_gap(nstate, jstate)}
            jstate, jg, _, _ = jguarded(jstate, jg, jb, jnp.asarray(False))
            pstate, pg, _, _ = pguarded(pstate, pg, pb, torch.tensor(False))
            nstate, ng, _, _ = jguarded(nstate, ng, jb, jnp.asarray(False))
            after = {"jax": int(jg.skipped), "port": int(pg.skipped), "nudged": int(ng.skipped)}
            for arm in flags:
                flags[arm].append(after[arm] > before[arm])
            step = len(flags["jax"])
            for arm in ("port", "nudged"):
                if step in marks:
                    gaps[arm][step] = pre[arm]
                if parted[arm] is None and flags[arm][-1] != flags["jax"][-1]:
                    # Where the arm's skip flag first parts from JAX's: the
                    # critic's gap going in, both z-scores (loss, grad norm)
                    # and JAX's margin to zmax against the arms' z gap.
                    z_gap = max(abs(a - b) for a, b in zip(z[arm], z["jax"]))
                    margin = min(abs(x - ZMAX) for x in z["jax"])
                    parted[arm] = dict(step=step, critic_rel_gap_before=pre[arm],
                                       z_jax=list(z["jax"]), z_arm=list(z[arm]),
                                       z_gap=z_gap, jax_margin_to_zmax=margin,
                                       gap_straddles_zmax=bool(margin <= z_gap))
    f = {arm: np.asarray(v) for arm, v in flags.items()}
    out = dict(mode="batches", seed=seed, warm=warm, landed=landed,
               fused_update=fused_update, steps=len(f["jax"]))
    for arm in flags:
        out[f"skips_{arm}"] = int(f[arm].sum())
        out[f"skips_by_chunk_{arm}"] = [int(x) for x in f[arm].reshape(CHUNKS, CHUNK).sum(1)]
    for arm in ("port", "nudged"):
        out[f"flags_differ_{arm}"] = int((f[arm] != f["jax"]).sum())
        out[f"first_parting_{arm}"] = parted[arm]
        out[f"critic_rel_gap_{arm}"] = gaps[arm]
    return out


CLI_FLAGS = ["--learner_chunk=800", "--guardrails=true", "--fused_update=true",
             "--guardrail_rollback_k=0", "--total_env_steps=10000", "--eval_every=0"]


def _child(impl: str, argv) -> None:
    """One CLI run in this process, the ring's size as each learner chunk
    draws from it recorded: DeviceReplay.device_state, which the guarded
    main path's chunk (ShardedLearner.run_sample_chunk) calls once under
    the ingest lock in both packages, is wrapped. JAX's size is a device
    scalar: its references are kept and read after the run, so the record
    adds no host sync. Prints the summary line, then the sizes last."""
    if impl == "port":
        from distributed_ddpg_tpu_torch import train as trainer
        from distributed_ddpg_tpu_torch.replay import device as replay_mod
    else:
        from distributed_ddpg_tpu import train as trainer
        from distributed_ddpg_tpu.replay import device as replay_mod
    sizes = []
    state = replay_mod.DeviceReplay.device_state

    def recorded(self):
        storage, size = state(self)
        sizes.append(size)
        return storage, size

    replay_mod.DeviceReplay.device_state = recorded
    try:
        trainer.main(argv)
    finally:
        print(json.dumps({"ring_at_chunks": [int(np.asarray(x)) for x in sizes]}), flush=True)


def run_cli(impl: str, ratio: float, seed: int, outdir: str) -> dict:
    log = os.path.join(outdir, f"{impl}_{ratio}_{seed}.jsonl")
    flags = [*CLI_FLAGS, f"--seed={seed}", f"--max_ingest_ratio={ratio}", f"--log_path={log}"]
    if impl == "port":
        flags.insert(0, "--device=cpu")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, os.path.abspath(__file__), "child", "--impl", impl, "--", *flags]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        return dict(mode="cli", impl=impl, ratio=ratio, seed=seed, rc=res.returncode,
                    stderr=res.stderr[-2000:])
    lines = res.stdout.strip().splitlines()
    ring = json.loads(lines[-1])["ring_at_chunks"]
    summary = ast.literal_eval(lines[-2])
    records = [json.loads(line) for line in open(log) if line.strip()]
    final = [r for r in records if r.get("kind") == "final"][-1]
    return dict(mode="cli", impl=impl, ratio=ratio, seed=seed,
                skips=summary["guardrail_skipped_updates"],
                spikes=summary["guardrail_loss_spikes"],
                guarded_steps=summary["learner_steps"], chunks=len(ring),
                env_steps=final.get("env_steps", final.get("step")),
                ring_at_chunks=ring,
                landed_between_chunks=[b - a for a, b in zip(ring, ring[1:])])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["batches", "cli", "child"])
    ap.add_argument("--impl", choices=["port", "jax"], default="port")
    ap.add_argument("flags", nargs="*", help="child: the CLI's flags, after --")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--warm", type=int, default=1024)
    ap.add_argument("--landed", type=int, nargs="+", default=[1024, 3072])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--ratios", type=float, nargs="+", default=[0.0, 1.28, 3.84])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--fused_update", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "child":
        if args.impl == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
        _child(args.impl, args.flags)
        return
    if args.mode == "batches":
        jobs = [(s, args.warm, n, args.fused_update) for n in args.landed for s in args.seeds]
        fn = run_batches
        if args.workers > 1:
            # One process a case, --workers at a time: each its own JAX and torch.
            def child(job):
                s, w, n, fu = job
                return subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "batches", "--seeds", str(s),
                     "--warm", str(w), "--landed", str(n), "--workers", "1",
                     *(["--fused_update"] if fu else [])],
                    capture_output=True, text=True, check=True).stdout

            with ThreadPoolExecutor(args.workers) as ex:
                for out in ex.map(child, jobs):
                    sys.stdout.write(out)
                    sys.stdout.flush()
            return
        for job in jobs:
            print(json.dumps(fn(*job)), flush=True)
        return
    outdir = tempfile.mkdtemp(prefix="zscore_cli_")
    jobs = [(impl, r, s) for r in args.ratios for s in range(args.runs)
            for impl in ("port", "jax")]
    with ThreadPoolExecutor(args.workers) as ex:
        for res in ex.map(lambda j: run_cli(*j, outdir), jobs):
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
