"""The sharded replay's jobs on one rank (tests/test_torch_replay_sharding.py),
run by tests/torch_mesh_child.py for `spec["kind"] == "shard_suite"`: one
launch of D gloo ranks runs every case below, so the ranks' start-up is
paid once. Never imports JAX; the test process makes the inputs and the
JAX side.

Each case writes its arrays under its own prefix:

- "jax/": a sharded learner (scan route) from the job's state on the
  job's rows, one chunk with the job's global indices `idx` (JAX's draw),
  with and without fused_update: end state, global td and metrics;
- "bitid<fu>/": the same config (fused_chunk='off', so both take the scan
  route) sharded and replicated, each with its own replay of the job's
  rows and its own draws, two uniform chunks: both end states' bytes and
  both td's;
- "draw/": the sharded PER draw on the job's logical priorities `prios`
  (each rank holding its slots) with the job's uniforms;
- "per/": one PER chunk sharded and replicated with the job's `pidx` and
  `pweights`: each one's logical priorities and max priority;
- "reward/": reward_sample of a sharded and a replicated ring;
- "gather/": the owner-masked gather of every row of a ring whose rows
  hold -0.0 entries, and the rows themselves;
- "clamp/": sharded draws on a ring of 57 live rows, several uniforms;
- "mass/": a sharded draw where logical row 37 holds most of the mass;
- "bytes/": the storage bytes this rank holds.
"""

from __future__ import annotations

import numpy as np


def _logical(local, group):
    """Every rank's local slots [capacity / D, ...] as the logical vector
    (logical p = rank p % D, slot p // D), on every rank."""
    from distributed_ddpg_tpu_torch.parallel import mesh

    stacked = mesh.all_gather(local.contiguous(), group)     # [D, sc, ...]
    return stacked.transpose(0, 1).reshape(-1, *local.shape[1:])


def run_suite(spec, job, group) -> dict:
    import torch

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import (
        DevicePrioritizedReplay,
        DeviceReplay,
        draw_sharded_per_indices,
    )
    from torch_mesh_child import state_arrays, state_from_arrays

    dev = spec.get("device", "cpu")
    obs, act, k, cap, block = spec["obs"], spec["act"], spec["k"], spec["capacity"], spec["block"]
    rows = job["rows"]
    out = {}

    def replay(cls, mode, data=rows, **kw):
        rep = cls(cap, obs, act, dev, block_size=block, replay_sharding=mode, group=group, **kw)
        rep.add_packed(data)
        rep.flush()
        return rep

    def learner(cfg, state=None):
        return ShardedLearner(cfg, obs, act, spec["scale"], spec["offset"], chunk_size=k,
                              state=state, group=group)

    # --- the sharded chunk against JAX's, with JAX's indices ---
    for fu in ((False, True) if "idx" in job else ()):
        cfg = DDPGConfig(device=dev, replay_sharding="sharded", fused_update=fu, **spec["config"])
        lrn = learner(cfg, train_state_from_numpy(state_from_arrays(job), dev))
        res = lrn.run_sample_chunk(replay(DeviceReplay, "sharded"),
                                   idx=torch.from_numpy(job["idx"]))
        pre = f"jax{int(fu)}/"
        out.update({pre + key: v for key, v in state_arrays(lrn.state).items()})
        out[pre + "td"] = res.td_errors.cpu().numpy()
        out[pre + "metrics"] = np.array([float(res.metrics[n]) for n in METRIC_KEYS])
        out[pre + "route"] = np.array(lrn.route())

    # --- sharded bit for bit the replicated, each with its own draws ---
    for fu in (False, True):
        got = {}
        for mode in ("replicated", "sharded"):
            # fused_chunk='off': the replicated learner takes the scan route
            # too (the oracle of JAX's parity test), not the mesh launch.
            cfg = DDPGConfig(device=dev, replay_sharding=mode, fused_update=fu,
                             fused_chunk="off", **spec["config"])
            lrn, rep = learner(cfg), replay(DeviceReplay, mode)
            tds = [lrn.run_sample_chunk(rep).td_errors for _ in range(2)]
            got[mode] = (torch.cat([t.reshape(-1).view(torch.uint8)
                                    for t in state_tensors(lrn.state)]).numpy(),
                         torch.stack(tds).numpy())
        pre = f"bitid{int(fu)}/"
        for mode, (state_bytes, td) in got.items():
            out[pre + mode + "_state"] = state_bytes
            out[pre + mode + "_td"] = td

    # --- the owner-masked gather keeps -0.0 (a sum with +0.0 would not) ---
    signed = rows.copy()
    signed[::3, :4] = -0.0
    cfg = DDPGConfig(device=dev, replay_sharding="sharded", **spec["config"])
    lrn, rep = learner(cfg), replay(DeviceReplay, "sharded", data=signed)
    gidx = torch.arange(len(signed)).reshape(1, -1)
    out["gather/rows"] = lrn._gather(rep, rep.storage, gidx)[0].numpy()
    out["gather/want"] = signed

    # --- the sharded PER draw with the job's uniforms ---
    per = replay(DevicePrioritizedReplay, "sharded")
    prios = job["prios"]
    n_live = int(job["n_live"])
    st = {"packed": rows[:n_live], "ptr": np.asarray(n_live % cap), "size": np.asarray(n_live),
          "priorities": prios[:n_live], "max_priority": np.asarray(2.0, np.float32)}
    per.load_state_dict(st)
    idx, w = draw_sharded_per_indices(per.priorities, per.size, job["uniform"].shape,
                                      spec["beta"], group,
                                      uniform=torch.from_numpy(job["uniform"]))
    out["draw/idx"], out["draw/weights"] = idx.numpy(), w.numpy()

    # --- a PER chunk, sharded and replicated, on the same draw ---
    for mode in ("replicated", "sharded"):
        cfg = DDPGConfig(device=dev, replay_sharding=mode, prioritized=True, **spec["config"])
        lrn, rep = learner(cfg), replay(DevicePrioritizedReplay, mode)
        rep.load_state_dict({**st, "packed": rows[:n_live]})
        res = lrn.run_sample_chunk_per(rep, spec["beta"], idx=torch.from_numpy(job["pidx"]),
                                       weights=torch.from_numpy(job["pweights"]))
        logical = _logical(rep.priorities, group) if mode == "sharded" else rep.priorities
        out[f"per/{mode}_prios"] = logical.numpy()
        out[f"per/{mode}_maxp"] = np.float32(rep.max_priority)
        out[f"per/{mode}_td"] = res.td_errors.numpy()
        out[f"per/{mode}_state"] = torch.cat([t.reshape(-1).view(torch.uint8)
                                              for t in state_tensors(lrn.state)]).numpy()

    # --- reward_sample across placements (a collective when sharded) ---
    for mode in ("replicated", "sharded"):
        rep = replay(DeviceReplay, mode)
        for max_n in (100_000, 37):
            r, d = rep.reward_sample(max_n)
            out[f"reward/{mode}_{max_n}"] = np.stack([r, d])

    # --- the draw stays on live rows, and follows the mass ---
    part = replay(DevicePrioritizedReplay, "sharded")
    part.load_state_dict({"packed": rows[:57], "ptr": np.asarray(0), "size": np.asarray(57),
                          "priorities": np.linspace(0.1, 5.0, 57).astype(np.float32),
                          "max_priority": np.asarray(5.0, np.float32)})
    gen = torch.Generator().manual_seed(7)
    out["clamp/idx"] = np.stack([draw_sharded_per_indices(
        part.priorities, part.size, (8, 64), 0.4, group, generator=gen)[0].numpy()
        for _ in range(6)])
    heavy = np.ones(192, np.float32)
    heavy[37] = 1e4
    part.load_state_dict({"packed": rows[:192], "ptr": np.asarray(192), "size": np.asarray(192),
                          "priorities": heavy, "max_priority": np.asarray(1e4, np.float32)})
    idx, w = draw_sharded_per_indices(part.priorities, part.size, (8, 64), 0.4, group,
                                      generator=gen)
    out["mass/idx"], out["mass/weights"] = idx.numpy(), w.numpy()
    out["bytes/storage"] = np.int64(part.storage.numel() * part.storage.element_size())
    out["bytes/prios"] = np.int64(part.priorities.numel() * part.priorities.element_size())
    return out
