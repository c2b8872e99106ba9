"""The device-side data plane on gloo ranks (tests/test_torch_dataplane_ranks.py),
run by tests/torch_mesh_child.py for `spec["kind"]` "dataplane" and
"beats". Never imports JAX: the test process makes the inputs (JAX's
states, rows and draws) and the JAX side.

"dataplane": one launch runs every case of `spec["cases"]`, each writing
its arrays under its own name:

- "rollout": a DeviceActorPool on the ranks (the case's config: D = 2 with
  the envs sharded or replicated, or a (1, 2) grid) bound to a learner
  holding the job's state, two rollouts, with the job's draws of all E
  envs (`<name>/noise`, `reset`, `uniform`) or the pool's own generator,
  from the job's env reset values (`<name>/init`) or the pool's own: the
  replicated ring, the sharded ring's logical rows (on D > 1), the
  rank's env block and its carry;
- "guard": a guarded chunk of the case's config on the job's rows (some of
  them non-finite) with the job's global draw `<name>/idx`: the health
  word, the bad indices, the logical end state, the td, whether the
  replicas are bit-identical;
- "monolith": OnDeviceDDPG on the ranks from the job's state and env
  values, `chunks` chunks with the job's draws and global indices: the
  ring, ptr, size, the logical state and each chunk's stats;
- "rules": the multi-rank rules of the device actors: a failed dispatch
  raises at once (no restart), the sidecar is None with the envs sharded
  and every rank's with the envs replicated.

"beats": a fused beat, then a superstep of `superstep` beats, of the
spec's variant (uniform or PER, replicated or sharded ring, guarded or
not) from the job's converted JAX stack (state, ring, priorities,
rollout carry) with JAX's numbers passed in, and the same from a second
stack of the same inputs as the separate sequence (the learner's
scan-route chunk, then the pool's rollout into the ring): each stage's
logical state, ring, priorities, carry, metrics, td and health, and
whether the fused and the separate stacks are bit-identical.
"""

from __future__ import annotations

import hashlib

import numpy as np

SCALE, OFFSET = np.array([2.0], np.float32), np.array([0.0], np.float32)


def _draws(job, name, c, k):
    """Rollout c's K StepDraws of all E envs from the job, or None."""
    import torch

    from distributed_ddpg_tpu_torch.ops.exploration import StepDraws

    if f"{name}/noise" not in job:
        return None
    out = []
    for s in range(c * k, (c + 1) * k):
        uni = job.get(f"{name}/uniform")
        out.append(StepDraws(torch.from_numpy(job[f"{name}/noise"][s]),
                             torch.from_numpy(job[f"{name}/reset"][s]),
                             None if uni is None else torch.from_numpy(uni[s])))
    return out


def _logical(local, group):
    from torch_shard_child import _logical as gather

    return gather(local, group)


def _state(job, prefix="state/"):
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from torch_mesh_child import state_from_arrays

    arrays = {"state/" + k[len(prefix):]: v for k, v in job.items() if k.startswith(prefix)}
    return train_state_from_numpy(state_from_arrays(arrays), "cpu")


def _np(x):
    """A copy on the host (a CPU tensor's .numpy() shares its storage, which
    a later in-place write would change under the result)."""
    return np.array(x.detach().cpu().numpy() if hasattr(x, "detach") else x, copy=True)


def _put(out, name, arrays):
    for k, v in arrays.items():
        out[f"{name}/{k}"] = _np(v)


def _set_env(pool, init):
    """The pool's envs at the job's reset values of all E envs (its block)."""
    import torch

    env_state = pool.env.init(torch.from_numpy(init[pool.env_slice]).contiguous())
    pool._carry = pool.carry._replace(env_state=env_state, obs=pool.env.observe(env_state))


def run_rollout(case, job, group, out) -> None:
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    name = case["name"]
    cfg = DDPGConfig(device="cpu", **case["config"])
    learner = ShardedLearner(cfg, 3, 1, SCALE, OFFSET, state=_state(job), group=group)
    pool = DeviceActorPool(cfg, group=learner.group)
    pool.bind(lambda: learner.actor_params_logical)
    if f"{name}/init" in job:
        _set_env(pool, job[f"{name}/init"])
    data = learner.group.data
    rep = DeviceReplay(cfg.replay_capacity, 3, 1, "cpu")
    shard = (DeviceReplay(cfg.replay_capacity, 3, 1, "cpu", replay_sharding="sharded",
                          group=data) if data.world_size > 1 else None)
    for c in range(case["chunks"]):
        rows = pool.advance(_draws(job, name, c, pool.chunk_size))
        rep.insert_device_rows(rows)
        if shard is not None:
            shard.insert_device_rows(rows)
    n = len(rep)
    ring = _np(rep.storage[:n])
    carry = pool.carry
    _put(out, name, dict(
        ring=ring, ptr=np.int64(rep.ptr), size=np.int64(n),
        sha=np.array(hashlib.sha256(ring.tobytes()).hexdigest()),
        env_slice=np.array([pool.env_slice.start, pool.env_slice.stop]),
        sharded=np.bool_(pool.env_sharded), local_envs=np.int64(pool.local_envs),
        obs=carry.obs, ou=carry.ou, ep_ret=carry.ep_ret, steps=carry.steps,
        episodes=carry.episodes, ret_sum=carry.ret_sum, host_steps=np.int64(carry.host_steps),
        **{f"env_state{i}": t for i, t in enumerate(carry.env_state)}))
    if shard is not None:
        out[f"{name}/ring_sharded"] = _np(_logical(shard.storage, data)[:n])
    snap = pool.snapshot()
    out[f"{name}/gather_ms"] = np.float64(snap.get("devactor_gather_ms", -1.0))


def run_guard(case, job, group, out) -> None:
    import torch

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
    from torch_mesh_child import state_arrays

    name = case["name"]
    cfg = DDPGConfig(device="cpu", **case["config"])
    learner = ShardedLearner(cfg, 3, 1, SCALE, OFFSET, chunk_size=case["k"],
                             state=_state(job), group=group)
    rows = job[f"{name}/rows"]
    rep = DeviceReplay(cfg.replay_capacity, 3, 1, "cpu")
    rep.storage[:len(rows)] = torch.from_numpy(rows)
    rep.ptr, rep.size = len(rows) % cfg.replay_capacity, len(rows)
    res = learner.run_sample_chunk(rep, idx=torch.from_numpy(job[f"{name}/idx"]))
    h = learner.poll_health()
    out.update({f"{name}/{k}": v for k, v in state_arrays(learner.logical_state()).items()})
    _put(out, name, dict(
        health=np.array([h[k] for k in ("total", "nonfinite", "spikes", "skipped",
                                        "bad_rows")]),
        bad=learner.bad_indices(), td=res.td_errors,
        replicas=np.bool_(mesh.replicas_equal(state_tensors(learner.state), learner.group,
                                              sharded=learner.state_sharded()))))


def run_monolith(case, job, group, out) -> None:
    import torch

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.ondevice import OnDeviceDDPG
    from torch_mesh_child import state_arrays

    name = case["name"]
    cfg = DDPGConfig(device="cpu", **case["config"])
    od = OnDeviceDDPG(cfg, chunk_size=case["k"], group=group)
    od.load_train_state(_state(job))
    init = job[f"{name}/init"]
    od.env_state = od.env.init(torch.from_numpy(init[od.env_slice]).contiguous())
    od.obs = od.env.observe(od.env_state)
    indices = [torch.from_numpy(i) for i in job[f"{name}/indices"]]
    used = 0
    for c in range(case["chunks"]):
        stats = od.run_chunk(draws=_draws(job, name, c, case["k"]), indices=indices[used:])
        used += stats.learn_steps
        _put(out, f"{name}/chunk{c}", dict(
            metrics=stats.metrics, learn_steps=np.int64(stats.learn_steps),
            dones=stats.dones, ep_returns=stats.ep_returns))
    out.update({f"{name}/{k}": v for k, v in state_arrays(od.logical_state()).items()})
    _put(out, name, dict(ring=od.replay.storage, ptr=np.int64(od.replay.ptr),
                         size=np.int64(len(od.replay)), global_batch=np.int64(od.global_batch),
                         local_envs=np.int64(od.local_envs)))


class _Crash:
    """A fault site that fails every dispatch (the plan's devactor:rollout)."""

    def tick(self):
        raise RuntimeError("an injected rollout failure")


def run_rules(case, job, group, out) -> None:
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorError, DeviceActorPool
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    name = case["name"]
    base = dict(case["config"])
    params = _state(job).actor_params
    # A failed dispatch on more than one rank: raised at once, no restart.
    pool = DeviceActorPool(DDPGConfig(device="cpu", **base), fault=_Crash(), group=group)
    pool.set_params(params)
    try:
        pool.run_chunk(DeviceReplay(4096, 3, 1, "cpu"))
        raised = ""
    except DeviceActorError as e:
        raised = str(e)
    out[f"{name}/raised"] = np.array(raised)
    out[f"{name}/restarts"] = np.int64(pool.restarts)
    # The sidecar: None with the envs sharded, the carry with them replicated.
    for envs in (8, 3):
        pool = DeviceActorPool(DDPGConfig(device="cpu", **dict(base, device_actor_envs=envs)),
                               group=group)
        pool.set_params(params)
        pool.run_chunk(DeviceReplay(4096, 3, 1, "cpu"))
        sd = pool.carry_state_dict()
        out[f"{name}/sidecar{envs}"] = np.bool_(sd is not None)
        if sd is not None:
            for k, v in sd.items():
                out[f"{name}/sidecar{envs}/{k}"] = v


def run_dataplane(spec, job, group) -> dict:
    out: dict = {}
    runners = dict(rollout=run_rollout, guard=run_guard, monolith=run_monolith,
                   rules=run_rules)
    for case in spec["cases"]:
        runners[case["case"]](case, job, group, out)
    return out


# --- "beats" -------------------------------------------------------------------------

def _stack(spec, job, group):
    """The port's learner, pool and replay holding the job's JAX stack."""
    import torch

    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay

    # The probe's state is fresh on both sides (JAX's learner has taken no
    # guarded step before the beat), so it needs no conversion.
    cfg = DDPGConfig(device="cpu", **spec["config"])
    learner = ShardedLearner(cfg, 3, 1, SCALE, OFFSET, chunk_size=cfg.learner_chunk,
                             state=_state(job), group=group)
    pool = DeviceActorPool(cfg, group=learner.group)
    pool.bind(lambda: learner.actor_params_logical)
    sl = pool.env_slice
    t = {k[len("carry/"):]: torch.from_numpy(v.copy()) for k, v in job.items()
         if k.startswith("carry/")}
    n_env = len(pool.carry.env_state)
    env_state = type(pool.carry.env_state)(*(t[f"env_state{i}"][sl].contiguous()
                                             for i in range(n_env)))
    pool._carry = pool.carry._replace(
        env_state=env_state, obs=t["obs"][sl].contiguous(), ou=t["ou"][sl].contiguous(),
        ep_ret=t["ep_ret"][sl].contiguous(), steps=t["steps"].long(),
        episodes=t["episodes"].long(), ret_sum=t["ret_sum"],
        host_steps=int(job["carry/steps"]))
    data = learner.group.data
    sharded = spec["sharded"] and data.world_size > 1
    placement = dict(replay_sharding="sharded", group=data) if sharded else {}
    if cfg.prioritized:
        rep = DevicePrioritizedReplay(cfg.replay_capacity, 3, 1, "cpu", alpha=cfg.per_alpha,
                                      eps=cfg.per_eps, **placement)
    else:
        rep = DeviceReplay(cfg.replay_capacity, 3, 1, "cpu", **placement)
    d, r = (data.world_size, data.rank) if sharded else (1, 0)
    ring = torch.from_numpy(job["ring"].copy())
    rep.storage.copy_(ring[r::d])
    rep.ptr, rep.size = int(job["ptr"]), int(job["size"])
    rep.local_fill = rep._local_count(rep.size)
    if cfg.prioritized:
        rep.set_per_state(torch.from_numpy(job["prios"].copy())[r::d].contiguous(),
                          torch.tensor(float(job["max_priority"])))
    return cfg, learner, pool, rep, data, sharded


def _numbers(job, stage, b, k):
    import torch

    from distributed_ddpg_tpu_torch.ops.exploration import StepDraws

    pre = f"{stage}{b}/"
    idx = torch.from_numpy(job[pre + "idx"]).long()
    weights = torch.from_numpy(job[pre + "weights"]) if pre + "weights" in job else None
    draws = [StepDraws(torch.from_numpy(job[pre + "noise"][s]),
                       torch.from_numpy(job[pre + "reset"][s]),
                       torch.from_numpy(job[pre + "uniform"][s])) for s in range(k)]
    return idx, weights, draws


def _view(learner, pool, rep, data, sharded):
    """What a stage leaves: the logical state, ring and priorities, the
    carry (this rank's env block), the probe state."""
    from torch_mesh_child import state_arrays

    ring = _logical(rep.storage, data) if sharded else rep.storage
    out = {k: _np(v) for k, v in state_arrays(learner.logical_state()).items()}
    out["ring"] = _np(ring)
    out["ptr"], out["size"] = np.int64(rep.ptr), np.int64(len(rep))
    if hasattr(rep, "priorities"):
        p = _logical(rep.priorities, data) if sharded else rep.priorities
        out["prios"], out["max_priority"] = _np(p), _np(rep.max_priority)
    c = pool.carry
    for i, t in enumerate(c.env_state):
        out[f"carry/env_state{i}"] = _np(t)
    for k in ("obs", "ou", "ep_ret", "steps", "episodes", "ret_sum"):
        out[f"carry/{k}"] = _np(getattr(c, k))
    if learner.guard_enabled:
        for k in learner._guard._fields:
            out[f"guard/{k}"] = _np(getattr(learner._guard, k))
    return out


def run_beats(spec, job, group) -> dict:
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import state_tensors
    from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep
    from distributed_ddpg_tpu_torch.parallel.superstep import FusedSuperstep

    fused, sep = _stack(spec, job, group), _stack(spec, job, group)
    cfg, learner, pool, rep, data, sharded = fused
    _, l2, p2, r2, _, _ = sep
    k_env = pool.chunk_size
    out: dict = {}

    def separate(beta, idx, weights, draws):
        if cfg.prioritized:
            res = l2.run_sample_chunk_per(r2, beta, idx=idx, weights=weights)
        else:
            res = l2.run_sample_chunk(r2, idx=idx)
        p2.run_chunk(r2, draws=draws)
        return res

    def record(stage, res, metrics):
        v = _view(learner, pool, rep, data, sharded)
        v["metrics"] = np.array(metrics)
        v["td"] = _np(res.td_errors)
        if learner.guard_enabled:
            h = learner.poll_health()
            v["health"] = np.array([h[k] for k in ("total", "nonfinite", "spikes", "skipped",
                                                   "bad_rows")])
            v["first_bad_beat"] = np.int64(h.get("first_bad_beat", -2))
            l2.poll_health()
        mine = _view(l2, p2, r2, data, sharded)
        v["same_as_separate"] = np.bool_(all(
            np.array_equal(v[k], mine[k]) and v[k].dtype == mine[k].dtype
            for k in mine))
        held = state_tensors(learner.state)
        v["replicas"] = np.bool_(mesh.replicas_equal(held, learner.group,
                                                     sharded=learner.state_sharded()))
        out.update({f"{stage}/{k}": x for k, x in v.items()})

    betas = job["betas"]
    ms = FusedMegastep(cfg, learner, pool, rep)
    idx, w, dr = _numbers(job, "beat", 0, k_env)
    res = ms.run_beat(float(betas[0]) if cfg.prioritized else None, idx=idx, weights=w,
                      draws=dr)
    separate(float(betas[0]), idx, w, dr)
    record("beat", res, [float(res.metrics[k]) for k in METRIC_KEYS])

    B = int(spec["superstep"])
    ss = FusedSuperstep(cfg, learner, pool, rep, beats=B)
    nums = [_numbers(job, "super", b, k_env) for b in range(B)]
    res = ss.run_superstep(betas[1:1 + B] if cfg.prioritized else None,
                           idx=[n[0] for n in nums],
                           weights=[n[1] for n in nums] if cfg.prioritized else None,
                           draws=[n[2] for n in nums])
    for b, n in enumerate(nums):
        separate(float(betas[1 + b]), *n)
    record("super", res, ss.last_metrics)
    return out
