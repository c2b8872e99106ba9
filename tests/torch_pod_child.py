"""Child processes of the port's pod tests (tests/test_torch_multihost.py):
one rank of a gloo group on the CPU, with the node it belongs to in its
environment (GROUP_RANK, GROUP_WORLD_SIZE, LOCAL_RANK), as torchrun sets
it. Never imports JAX.

    python tests/torch_pod_child.py JOB.npz RANK WORLD INIT_METHOD
    python tests/torch_pod_child.py --train [TRAINER FLAGS]

With --train it is one node of tests/test_torch_pod.py's pods: the
trainer's CLI (train.main) under the test harness's two variables, as the
JAX package's test child reads its own: POD_FAULTS adds a fault plan to
--faults (tools.supervise --env-first sets it in generation 1 only), and
POD_EXIT_LINGER_S shortens node 0's linger before its exit 76.

JOB.npz holds a JSON spec:

- kind "beat": a DeviceReplay (or DevicePrioritizedReplay) on the pod;
  for each step of the schedule the node's lead stages that node's rows
  (node_rows, a seeded numpy draw), then every rank takes the step's beat:
  synchronous, background (sync_ship_begin on a TransferScheduler's
  lockstep lane, then the ticket waited) or forced. Saves the ring (with
  "sharding": "sharded", this rank's slots of it, and the scheduler's
  lockstep and shard_exchange item counts).
- kind "onenode": the group has one node: rank 0's rows reach every rank
  through mesh.share_rows, each rank stages and ships them (the one-node path),
  and a last flush pads the remainder. Saves the ring (sharded: this
  rank's slots) and the group's node fields.

Each rank writes JOB.rank<R>.npz.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

OBS, ACT = 3, 1
WIDTH = 2 * OBS + ACT + 3


def node_rows(seed: int, node: int, step: int, n: int) -> np.ndarray:
    """Node `node`'s rows for schedule step `step` (the same in every mode)."""
    rng = np.random.default_rng([seed, node, step])
    return rng.standard_normal((n, WIDTH)).astype(np.float32)


def run_beats(spec, group) -> dict:
    from distributed_ddpg_tpu_torch.parallel import multihost
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    multihost.use_group(group)
    multihost.configure_pod(30.0)
    bg = spec["mode"] == "background"
    sched = TransferScheduler(lockstep_timeout_s=30.0).start() if bg else None
    cls = DevicePrioritizedReplay if spec["per"] else DeviceReplay
    rep = cls(spec["capacity"], OBS, ACT, "cpu", block_size=spec["block_size"],
              max_coalesce=spec["max_coalesce"], scheduler=sched, background_sync=bg,
              pod=group, replay_sharding=spec.get("sharding", "replicated"), group=group)
    shipped = []
    counts_out = {}
    try:
        for step, (counts, force) in enumerate(spec["schedule"]):
            if group.node_lead and counts[group.process_index]:
                rep.add_packed(node_rows(spec["seed"], group.process_index, step,
                                         counts[group.process_index]))
            if bg and not force:
                # Two beats in flight on the lane, the second behind the
                # first: it ships what the first left.
                tickets = [rep.sync_ship_begin(), rep.sync_ship_begin()]
                shipped.append(sum(multihost.wait_beat_ticket(t) for t in tickets))
            else:
                shipped.append(rep.sync_ship(force=force))
        if sched is not None:
            snap = sched.snapshot()
            counts_out = {k: np.array(snap[f"transfer_{k}_items"])
                          for k in ("lockstep", "shard_exchange")}
    finally:
        if sched is not None:
            sched.close()
        multihost.configure_pod(0.0)
    out = dict(storage=rep.storage.numpy().copy(), ptr=np.array(rep.ptr),
               size=np.array(rep.size), shipped=np.array(shipped),
               pending=np.array(rep.pending_rows), node=np.array(group.process_index),
               node_lead=np.array(group.node_lead), lead_ranks=np.array(group.lead_ranks),
               local_fill=np.array(rep.local_fill), **counts_out)
    if spec["per"]:
        out["priorities"] = rep.priorities.numpy().copy()
    return out


def run_one_node(spec, group) -> dict:
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    rep = DeviceReplay(spec["capacity"], OBS, ACT, "cpu", block_size=spec["block_size"],
                       replay_sharding=spec.get("sharding", "replicated"), group=group)
    for step, n in enumerate(spec["counts"]):
        rows = node_rows(spec["seed"], 0, step, n) if group.lead else None
        rows = mesh.share_rows(rows, WIDTH, group)
        if rows is not None:
            rep.add_packed(rows)
    rep.flush()
    return dict(storage=rep.storage.numpy().copy(), ptr=np.array(rep.ptr),
                size=np.array(rep.size), process_count=np.array(group.process_count),
                pod=np.array(group.pod is not None), node_lead=np.array(group.node_lead))


def train_node(argv) -> None:
    import functools

    from distributed_ddpg_tpu_torch import train

    if os.environ.get("POD_FAULTS"):
        argv = [*argv, f"--faults={os.environ['POD_FAULTS']}"]
    if os.environ.get("POD_EXIT_LINGER_S"):
        train.pod_degraded_exit = functools.partial(
            train.pod_degraded_exit, float(os.environ["POD_EXIT_LINGER_S"]))
    train.main(argv)


def main(argv) -> int:
    import torch

    from distributed_ddpg_tpu_torch.parallel.mesh import init_data_group

    torch.set_num_threads(1)
    path, rank, world, init_method = argv[0], int(argv[1]), int(argv[2]), argv[3]
    spec = json.loads(str(np.load(path)["spec"]))
    group = init_data_group("gloo", "cpu", init_method=init_method, rank=rank,
                            world_size=world, timeout_s=60.0)
    out = run_beats(spec, group) if spec["kind"] == "beat" else run_one_node(spec, group)
    np.savez(path[:-len(".npz")] + f".rank{rank}.npz", **out)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train"]:
        train_node(sys.argv[2:])
    else:
        sys.exit(main(sys.argv[1:]))
