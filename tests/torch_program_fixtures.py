"""Deliberately broken programs for the port's program-contract analyzer
(distributed_ddpg_tpu_torch/analysis/programs.py), one registry per
failure mode, loadable by the CLI as `--specs
tests/torch_program_fixtures.py:<name>`. The `_v1` registry writes the
golden and its `_v2` twin (the same program name) breaks it:

- `collective_specs_v1/_v2` — all-reduce then broadcast, and the reverse.
- `read_specs_v1/_v2`       — one declared host read, then two.
- `undeclared_read_specs`   — a host read no reason declares.
- `moved_specs_v1/_v2`      — a leaf updated in place, then rebound.
- `clean_specs`             — a well-formed program (golden round trip,
                              the missing-golden and stale-golden cases).
- `broken_build_specs`      — a spec whose build raises.
- `beat_group_specs`        — two variants of one beat group that disagree.
"""

import torch

from distributed_ddpg_tpu_torch.analysis.programs import BuiltProgram, ProgramSpec, probe_group
from distributed_ddpg_tpu_torch.parallel import mesh

OWNER = "tests/torch_program_fixtures.py"


def _collectives(order: str):
    def build(device: str) -> BuiltProgram:
        group = probe_group(device)
        t = torch.zeros(4, device=device)

        def fn():
            if order == "sum-first":
                mesh.all_reduce_sum_([t], group)
                mesh._broadcast(t, group)
            else:
                mesh._broadcast(t, group)
                mesh.all_reduce_sum_([t], group)
        return BuiltProgram(fn, lambda: {"t": t})
    return build


def collective_specs_v1():
    return [ProgramSpec("fixture.collective.pair", OWNER, _collectives("sum-first"))]


def collective_specs_v2():
    return [ProgramSpec("fixture.collective.pair", OWNER, _collectives("bcast-first"))]


def _reads(n: int):
    def build(device: str) -> BuiltProgram:
        t = torch.ones(3, device=device)
        return BuiltProgram(lambda: [float(t.sum()) for _ in range(n)])
    return build


def read_specs_v1():
    return [ProgramSpec("fixture.read", OWNER, _reads(1), host_reads="a fixture's read")]


def read_specs_v2():
    return [ProgramSpec("fixture.read", OWNER, _reads(2), host_reads="a fixture's read")]


def undeclared_read_specs():
    return [ProgramSpec("fixture.read.undeclared", OWNER, _reads(1))]


def _moves(rebind: bool):
    def build(device: str) -> BuiltProgram:
        held = {"t": torch.zeros(3, device=device)}

        def fn():
            if rebind:
                held["t"] = held["t"] + 1.0
            else:
                held["t"].add_(1.0)
        return BuiltProgram(fn, lambda: dict(held))
    return build


def moved_specs_v1():
    return [ProgramSpec("fixture.moved", OWNER, _moves(False))]


def moved_specs_v2():
    return [ProgramSpec("fixture.moved", OWNER, _moves(True))]


def clean_specs():
    return [ProgramSpec("fixture.clean", OWNER, _collectives("sum-first"))]


def _broken(device: str) -> BuiltProgram:
    raise ValueError("this spec cannot build its program")


def broken_build_specs():
    return [ProgramSpec("fixture.broken", OWNER, _broken)]


def beat_group_specs():
    return [
        ProgramSpec("fixture.beat.a", OWNER, _collectives("sum-first"), beat_group="fixture-beat"),
        ProgramSpec("fixture.beat.b", OWNER, _collectives("bcast-first"), beat_group="fixture-beat"),
    ]
