"""Fixture: the learner goes through the mesh's entry points, never a raw
collective; a raw one under dispatch_lock is two findings."""
import torch.distributed as dist

from parallel import mesh


def chunk(replay, t, group):
    mesh.all_reduce_mean_([t], group)
    with replay.dispatch_lock:
        dist.all_reduce(t)  # expect: collective-discipline, lock-discipline
        mesh.share([1.0], group)  # expect: lock-discipline
        torch_sync = t.sum()
    return torch_sync
