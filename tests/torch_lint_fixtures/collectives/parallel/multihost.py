"""Fixture: the pod's entry points may make collectives."""
import torch.distributed as dist


def beat(outs, t, group):
    dist.all_gather(outs, t, group=group)
    dist.barrier(group=group)
