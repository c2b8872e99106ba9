"""The host replay's chunks and the tensor-parallel serve apply on gloo
ranks (tests/test_torch_host_replay_ranks.py, tests/test_torch_serve_ranks.py):
the jobs `tests/torch_mesh_child.py` runs for the kinds "host_chunk" and
"serve_tp". Imports torch and the port, never JAX.

- "host_chunk": rank 0 builds the port's host replay (make_replay at the
  job's config) from the job's rows (and PER priorities), draws one chunk
  with its ChunkPrefetcher and places it (put_chunk); every rank gets it
  through ShardedLearner.share_chunk and runs it (run_chunk_async); under
  PER rank 0 then writes the td back (train.host_per_update). Writes this
  rank's columns of the shared chunk, the drawn indices, the logical end
  state, the global td, whether the replicas are bit-identical, and (rank
  0, PER) the replay's priorities, max priority and beta.
- "serve_tp": the ranks of one model group (model_axis = world) make the
  serve group (parallel/mesh.serve_group); rank 0 serves (InferenceServer
  with mesh=), the others follow (ServeFollower). Rank 0 refreshes the
  job's flat params and applies the job's observations; every rank writes
  the bytes of policy it holds. With `lose_follower` the follower's
  process kills itself after the first real apply, and rank 0 writes what
  its next applies raised and how long they took.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np

FIELDS = ("obs", "action", "reward", "discount", "next_obs")


def run_host_chunk(spec, job, group) -> dict:
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.parallel.prefetch import ChunkPrefetcher
    from distributed_ddpg_tpu_torch.replay import make_replay
    from distributed_ddpg_tpu_torch.train import host_per_update
    from torch_mesh_child import state_arrays, state_from_arrays

    cfg = DDPGConfig(device="cpu", **spec["config"])
    obs, act, k = spec["obs"], spec["act"], spec["k"]
    learner = ShardedLearner(cfg, obs, act, spec["scale"], spec["offset"], chunk_size=k,
                             state=train_state_from_numpy(state_from_arrays(job)), group=group)
    out, chunk, replay = {}, None, None
    if learner.group.lead:
        replay = make_replay(cfg, obs, act)
        replay.add_batch(*(job[f] for f in FIELDS))
        if "prio_idx" in job:
            replay.update_priorities(job["prio_idx"], job["prio_td"])
        drawn = ChunkPrefetcher(replay, learner.put_chunk, learner.global_batch, k)._sample_chunk()
        out["indices"] = drawn.pop("indices")
        chunk = learner.put_chunk(drawn)
    shared = learner.share_chunk(chunk)
    out["cols"] = learner._cols(shared.packed).numpy().copy()
    res = learner.run_chunk_async(shared)
    if replay is not None and cfg.prioritized:
        host_per_update(replay, threading.Lock(), out["indices"], res.td_errors, spec["beta"])
        sd = replay.state_dict()
        out.update(priorities=sd["priorities"], max_priority=sd["max_priority"],
                   beta=np.float64(replay.beta))
    out.update(state_arrays(learner.logical_state()))
    held = state_tensors(learner.state)
    flags = learner.state_sharded() + [False] * (len(held) - len(learner.state_sharded()))
    out.update(td=res.td_errors.numpy(), route=np.array(learner.route()),
               replicas=np.array(mesh.replicas_equal(held, learner.group, sharded=flags)))
    return out


def run_serve_tp(spec, job, group) -> dict:
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.serve import InferenceServer, ServeFollower, ServeGroupLost

    layout = tuple((tuple(w), tuple(b)) for w, b in spec["layout"])
    grid = mesh.make_grid(group, group.world_size)
    smesh = mesh.serve_group(grid, spec["timeout_s"])
    kw = dict(max_batch=spec["max_batch"], sac=spec["sac"], device="cpu")
    scale = np.asarray(spec["scale"], np.float32)
    if smesh.rank != 0:
        follower = ServeFollower(layout, scale, mesh=smesh, **kw).start()
        if spec.get("lose_follower"):
            while follower.applies < 2:     # the warm apply, then the first real one
                time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGKILL)
        assert follower.join(60.0), "the follower did not stop"
        assert follower.error is None, follower.error
        return dict(shard_bytes=np.int64(follower.shard_bytes),
                    applies=np.int64(follower.applies))
    server = InferenceServer(layout, scale, backend="jax", mesh=smesh, **kw)
    server.refresh(job["flat"])
    out = dict(actions=server._compute(job["obs"]), shard_bytes=np.int64(server.shard_bytes))
    if spec.get("lose_follower"):
        time.sleep(1.0)
        waits, kinds = [], []
        for _ in range(2):
            t0 = time.monotonic()
            try:
                server._compute(job["obs"])
                kinds.append("none")
            except ServeGroupLost:
                kinds.append("lost")
            waits.append(time.monotonic() - t0)
        # Through the batcher, as a worker's request: a typed failure.
        server.start()
        t0 = time.monotonic()
        try:
            server.client(timeout_s=30.0).act(job["obs"][0])
            kinds.append("none")
        except Exception as e:
            cause = e.__cause__
            kinds.append(f"{type(e).__name__}/{type(cause).__name__ if cause else None}")
        waits.append(time.monotonic() - t0)
        out.update(waits=np.array(waits), kinds=np.array(kinds))
    server.close()
    return out
