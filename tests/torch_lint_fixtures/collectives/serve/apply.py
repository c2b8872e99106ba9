"""Fixture: serving goes through its serve group, never a raw call."""
from torch.distributed import all_reduce as ar


def apply(t):
    ar(t)  # expect: collective-discipline
