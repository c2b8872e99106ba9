"""Fixture: every torch spelling of a collective or group call outside
parallel/mesh.py and parallel/multihost.py is one finding; queries are
none. Each expected finding's line carries an `expect:` marker."""
import datetime

import torch
import torch.distributed
import torch.distributed as dist
from torch import distributed as tdist
from torch.distributed import all_gather as gather_all
from torch.distributed import broadcast


def step(t, group, peers):
    dist.all_reduce(t)  # expect: collective-discipline
    torch.distributed.all_reduce(t, group=group)  # expect: collective-discipline
    tdist.barrier()  # expect: collective-discipline
    gather_all(peers, t)  # expect: collective-discipline
    broadcast(t, src=0)  # expect: collective-discipline
    dist.all_gather_into_tensor(t, t)  # expect: collective-discipline
    dist.reduce_scatter_tensor(t, t)  # expect: collective-discipline
    dist.gather(t, peers, dst=0)  # expect: collective-discipline
    dist.scatter(t, peers, src=0)  # expect: collective-discipline
    dist.send(t, dst=1)  # expect: collective-discipline
    dist.recv(t, src=1)  # expect: collective-discipline
    dist.isend(t, dst=1)  # expect: collective-discipline
    dist.irecv(t, src=1)  # expect: collective-discipline
    dist.monitored_barrier(group)  # expect: collective-discipline
    dist.all_gather_object(peers, 1)  # expect: collective-discipline
    dist.broadcast_object_list(peers, src=0)  # expect: collective-discipline
    dist.new_group([0, 1])  # expect: collective-discipline
    dist.init_process_group("gloo", rank=0, world_size=1)  # expect: collective-discipline
    torch.distributed.distributed_c10d.all_reduce(t)  # expect: collective-discipline
    if dist.is_initialized() and dist.get_rank() == 0:
        dist.get_world_size()
    return datetime.timedelta(seconds=1)
