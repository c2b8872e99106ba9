"""One rank of the port's data-parallel tests (tests/test_torch_mesh.py).

    python tests/torch_mesh_child.py JOB.npz RANK WORLD_SIZE INIT_METHOD

joins a gloo group (on the CPU, or on the card when the job's spec says
"device": "cuda"), runs the job the .npz describes and writes this rank's
results to JOB.rank<RANK>.npz. It imports torch and the port, never JAX:
the test process makes the JAX side and the inputs. `run_ranks` starts
the ranks of one job from a test and waits for them.

Jobs (`spec["kind"]`):

- "chunk": one learner chunk on a replay of the job's rows, from the
  job's state: uniform (`run_sample_chunk`) with the rank's own idx and
  noise (`idx<rank>`, `eps<rank>` ...) or the global ones (`idx`, `eps`),
  or PER (`run_sample_chunk_per`) with the global idx and weights from the
  job's priorities. Writes the end state, the global td, the metrics, the
  route, global_batch, (PER) the priorities and max priority, and whether
  every rank's state (and priorities) is bit-identical to rank 0's. On a
  (data, model) grid (the job's config has model_axis > 1) the state
  written is the logical one (ShardedLearner.logical_state), the replicas
  are held as parallel/mesh.replicas_equal holds shards, and with
  `"replay_sharding": "sharded"` the ring is split over the data group
  (the PER priorities written are then the logical vector);
- "train": train() at the job's config, in this rank's group; writes its
  summary as JSON;
- "shard_suite": the sharded replay's cases (tests/torch_shard_child.py);
- "ckpt": a learner at the job's config (model_axis > 1) restores the
  logical checkpoint in `src`, writes this rank's shards, and rank 0
  writes the gathered logical state to `dst` (checkpoints across
  model_axis).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120

def run_ranks(tmp_path, spec, arrays, name="job", world=2, check=True):
    """Run the job on `world` gloo ranks (child processes); returns each
    rank's results. Fails at once when a rank exits non-zero, and when the
    ranks outlive RANK_TIMEOUT_S. With check=False it waits for every rank
    (up to RANK_TIMEOUT_S) and returns their exit codes."""
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, spec=np.array(json.dumps(spec)), **arrays)
    init = "file://" + str(tmp_path / f"{name}.rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [tmp_path / f"{name}.rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), path, str(r), str(world), init],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=str(tmp_path)))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = check and any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if not check:
        return [p.returncode for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"rank {r} exited with {p.returncode}:\n"
                                   f"{log.read_text(errors='replace')[-4000:]}")
    return [dict(np.load(path[:-len(".npz")] + f".rank{r}.npz", allow_pickle=False))
            for r in range(world)]


STATE_GROUPS = ("actor_params", "critic_params", "target_actor_params",
                "target_critic_params")


def state_arrays(state) -> dict:
    """A TrainState with numpy (or torch) leaves -> flat {"state/...": array}."""
    out = {}

    def put(name, x):
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
        out[f"state/{name}"] = x

    def tree(name, t):
        for i, layer in enumerate(t):
            for k in ("w", "b"):
                put(f"{name}.{i}.{k}", layer[k])

    for g in STATE_GROUPS:
        tree(g, getattr(state, g))
    for opt in ("actor_opt", "critic_opt"):
        o = getattr(state, opt)
        tree(f"{opt}.mu", o.mu)
        tree(f"{opt}.nu", o.nu)
        put(f"{opt}.count", o.count)
    put("step", state.step)
    if getattr(state, "log_alpha", None) is not None:
        put("log_alpha", state.log_alpha)
    if getattr(state, "alpha_opt", None) is not None:
        put("alpha_opt.mu", state.alpha_opt.mu)
        put("alpha_opt.nu", state.alpha_opt.nu)
        put("alpha_opt.count", state.alpha_opt.count)
    return out


def state_from_arrays(arrays: dict):
    """state_arrays' inverse: a port TrainState with numpy leaves (what
    learner.train_state_from_numpy takes)."""
    from distributed_ddpg_tpu_torch.types import OptState, TrainState

    def tree(name):
        n = 0
        while f"state/{name}.{n}.w" in arrays:
            n += 1
        return tuple({k: arrays[f"state/{name}.{i}.{k}"] for k in ("w", "b")}
                     for i in range(n))

    def opt(name):
        return OptState(mu=tree(f"{name}.mu"), nu=tree(f"{name}.nu"),
                        count=arrays[f"state/{name}.count"])

    alpha = None
    if "state/alpha_opt.mu" in arrays:
        alpha = OptState(mu=arrays["state/alpha_opt.mu"], nu=arrays["state/alpha_opt.nu"],
                         count=arrays["state/alpha_opt.count"])
    return TrainState(
        **{g: tree(g) for g in STATE_GROUPS},
        actor_opt=opt("actor_opt"), critic_opt=opt("critic_opt"),
        step=arrays["state/step"], log_alpha=arrays.get("state/log_alpha"), alpha_opt=alpha,
    )


def _noise(job, suffix, device):
    """The job's noise for this rank (suffix = rank) or the global one
    (suffix = ""): TD3's eps, SAC's (eps_next, eps_cur), or None."""
    import torch

    if f"eps_next{suffix}" in job:
        return (torch.from_numpy(job[f"eps_next{suffix}"]).to(device),
                torch.from_numpy(job[f"eps_cur{suffix}"]).to(device))
    if f"eps{suffix}" in job:
        return torch.from_numpy(job[f"eps{suffix}"]).to(device)
    return None


def run_chunk(spec, job, group) -> dict:
    import torch

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay

    device = spec.get("device", "cpu")
    cfg = DDPGConfig(device=device, **spec["config"])
    obs, act, k = spec["obs"], spec["act"], spec["k"]
    state = (train_state_from_numpy(state_from_arrays(job), device) if "state/step" in job
             else None)
    learner = ShardedLearner(cfg, obs, act, spec["scale"], spec["offset"], chunk_size=k,
                             state=state, group=group)
    per = spec.get("per", False)
    cls = DevicePrioritizedReplay if per else DeviceReplay
    sharded = spec.get("replay_sharding") == "sharded"
    placement = (dict(replay_sharding="sharded", group=learner.group.data if learner.group
                      else None) if sharded else {})
    rep = cls(spec["capacity"], obs, act, device, block_size=spec["block"], **placement)
    rep.add_packed(job["rows"])
    if sharded:
        rep.flush()
    if per and "prios" in job:
        rep.set_per_state(torch.from_numpy(job["prios"].copy()).to(device),
                          torch.tensor(float(job["max_priority"]), device=device))
    if spec.get("fail_rank") == group.rank:
        raise RuntimeError("a launch failure planted on this rank")
    out = {}
    for _ in range(spec.get("chunks", 1)):
        if per:
            given = "idx" in job
            res = learner.run_sample_chunk_per(
                rep, spec["beta"],
                idx=torch.from_numpy(job["idx"]) if given else None,
                weights=torch.from_numpy(job["weights"]) if given else None,
                eps=_noise(job, "", device))
            prios = rep.priorities
            if sharded:
                from torch_shard_child import _logical

                prios = _logical(prios, learner.group.data)
            out.update(priorities=prios.cpu().numpy(),
                       max_priority=np.float32(rep.max_priority.cpu()))
        else:
            suffix = str(group.rank) if f"idx{group.rank}" in job else ""
            idx = job.get(f"idx{suffix}")
            res = learner.run_sample_chunk(
                rep, idx=None if idx is None else torch.from_numpy(idx),
                eps=_noise(job, suffix, device))
    # A sharded ring's priorities are each rank's own slots: only the max
    # priority is a replica (as train.py holds them).
    held = state_tensors(learner.state) + (
        ([rep.max_priority] if sharded else [rep.priorities, rep.max_priority]) if per else [])
    flags = learner.state_sharded() + [False] * (len(held) - len(learner.state_sharded()))
    out.update(state_arrays(learner.logical_state()))
    out.update(
        td=res.td_errors.cpu().numpy(),
        metrics=np.array([float(res.metrics[name]) for name in METRIC_KEYS]),
        replicas=np.array(mesh.replicas_equal(held, learner.group or group, sharded=flags)),
        route=np.array(learner.route(per=per)),
        global_batch=np.array(learner.global_batch),
    )
    return out


def run_ckpt(spec, group) -> dict:
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import state_items
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

    cfg = DDPGConfig(device="cpu", **spec["config"])
    learner = ShardedLearner(cfg, spec["obs"], spec["act"], spec["scale"], spec["offset"],
                             group=group)
    template = learner.state_template()
    # The template carries shapes only: a rank holds no logical copy.
    assert all(t.device.type == "meta" for _, t in state_items(template))
    state, step, _ = ckpt_lib.restore(spec["src"], template, device=learner.device)
    learner.load_state(state)
    out = {f"shard/{path}": t.numpy() for path, t in state_items(learner.state)}
    logical = learner.logical_state()
    if group.rank == 0:
        ckpt_lib.save(spec["dst"], step, logical, config=cfg)
    out["step"] = np.int64(step)
    return out


def main(argv) -> int:
    import torch

    from distributed_ddpg_tpu_torch.parallel.mesh import init_data_group

    torch.set_num_threads(1)
    path, rank, world, init_method = argv[0], int(argv[1]), int(argv[2]), argv[3]
    job = dict(np.load(path, allow_pickle=False))
    spec = json.loads(str(job.pop("spec")))
    group = init_data_group("gloo", spec.get("device", "cpu"), init_method=init_method,
                            rank=rank, world_size=world,
                            timeout_s=spec.get("timeout_s", 60.0))
    if spec["kind"] == "chunk":
        out = run_chunk(spec, job, group)
    elif spec["kind"] == "ckpt":
        out = run_ckpt(spec, group)
    elif spec["kind"] == "shard_suite":
        from torch_shard_child import run_suite

        out = run_suite(spec, job, group)
    else:
        from distributed_ddpg_tpu_torch.config import DDPGConfig
        from distributed_ddpg_tpu_torch.train import train

        summary = train(DDPGConfig(device="cpu", **spec["config"]), echo=False, group=group)
        out = dict(summary=np.array(json.dumps(summary)))
    np.savez(path[:-len(".npz")] + f".rank{rank}.npz", **out)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
