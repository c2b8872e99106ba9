"""Fixture: the rank grid may make every collective and group call; a
literal timedelta deadline is still an inline timeout."""
import datetime

import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


def grid(t, peers, timeout_s):
    dist.init_process_group("gloo", timeout=TIMEOUT)
    dist.new_group([0, 1], timeout=datetime.timedelta(seconds=float(timeout_s)))
    dist.new_group([0, 1], timeout=datetime.timedelta(seconds=30))  # expect: timeout-discipline
    dist.new_group([2, 3], timeout=datetime.timedelta(minutes=2))  # expect: timeout-discipline
    dist.new_group([2, 3], timeout=datetime.timedelta(seconds=0.5))
    dist.all_reduce(t)
    dist.broadcast(t, src=0)
    dist.all_gather(peers, t)
    dist.barrier()
