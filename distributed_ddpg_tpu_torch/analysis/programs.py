"""The program-contract analyzer of the port: the counterpart of
distributed_ddpg_tpu/analysis/programs.py over the port's hot programs
(the catalog, distributed_ddpg_tpu_torch/docs/ANALYSIS.md, "Programs").

The JAX analyzer traces jaxprs without running them. A torch program can
only be seen by running it, so each spec builds its program at the JAX
probe sizes (8-wide batches, 16-wide hiddens, chunks of 2) and runs it
ONCE under a recording `TorchDispatchMode`, on a probe group of ranks
(`probe_group`). The recording sees every `c10d` collective the program
issues (`allreduce_`, `broadcast_`, `allgather_`, `barrier`, ...) and
every host read (`aten._local_scalar_dense`, which `.item()` and
`bool(t)` reach, and every copy from the card to the host). Four checks,
each the counterpart of one of JAX's:

1. **collective-order** — the ordered canonical sequence of c10d ops
   (op, group size, reduce op, dtype) against the goldens in
   tests/golden_programs_torch/. A reorder is a reviewed golden diff,
   never an accident: on ranks it is how replicas fork.
2. **beat-group** — variants in one beat group (the guarded and
   unguarded chunk, beat and superstep, dispatched at the same lockstep
   site) must issue identical collective sequences.
3. **host-read** — the counterpart of the host-callback leak. A host read
   inside a hot program is a finding unless its spec declares it with a
   reason; the golden pins the count, per device (the card's kernel route
   and the CPU's plain route read differently, and the golden says why).
4. **moved-storage** — the counterpart of donation aliasing. The golden
   records which state and replay leaves change their storage
   (`untyped_storage().data_ptr()`) across one call, one list for both
   devices; a change in it is a finding. A CUDA graph of a program needs
   this list.

The probe group is the `fake` backend (one process that plays rank 0 of
PROBE_WORLD ranks; every collective returns the rank's own values): the
analyzer starts it when no group is initialized and ends it after the
run, and refuses to run beside a group of another backend. A program
whose control flow reads a collective's result seeds its inputs so that
the result does not matter (each golden names its probe). The specs run
on the device the caller names (`--device`), never on another.

This module imports torch; the lint path (analysis/__init__.py) does
not load it.

    python -m distributed_ddpg_tpu_torch.tools.proganalyze            # check, on the card
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --device cpu
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --update-golden
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The fake default group's ranks: the (data=2, model=2) TP probe's. The
# 2-rank probe is the subgroup of ranks 0 and 1.
PROBE_WORLD = 4
PROBE_RANKS = 2
PROBE_KIND = "fake"

# Host reads: a scalar pulled to Python (.item(), bool(t), int(t)).
_SCALAR_READS = frozenset({"aten._local_scalar_dense.default"})
_COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})


class ProgramBuildError(RuntimeError):
    """A program spec failed to build or run its program (reported as a
    build-error finding: a spec that cannot build must gate)."""


@dataclasses.dataclass
class BuiltProgram:
    """One built program: `fn()` runs it once; `leaves()` names the state
    and replay tensors whose storage the moved-storage check watches (read
    before and after the call, so a program that rebinds an attribute is
    seen)."""

    fn: Callable[[], object]
    leaves: Callable[[], Dict[str, torch.Tensor]] = dict


@dataclasses.dataclass
class ProgramSpec:
    """Registry entry: a named factory for one hot program. `owner` is the
    package-relative module the program lives in; `beat_group` marks
    variants that must share their collective order; `host_reads` is the
    reason the program reads the host, when it does (None: it must not).
    `build(device)` builds it on that device."""

    name: str
    owner: str
    build: Callable[[str], BuiltProgram]
    beat_group: Optional[str] = None
    host_reads: Optional[str] = None


@dataclasses.dataclass
class ProgramFinding:
    program: str
    check: str    # collective-order | beat-group | host-read |
                  # moved-storage | build-error | stale-golden
    message: str

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.program} [{self.check}] {self.message}"


@dataclasses.dataclass
class ProgramReport:
    findings: List[ProgramFinding]
    programs: List[Dict[str, object]]
    updated: List[str]
    elapsed_s: float

    def to_json(self) -> Dict[str, object]:
        return {
            "version": 1,
            "counts": {
                "programs": len(self.programs),
                "findings": len(self.findings),
            },
            "elapsed_s": round(self.elapsed_s, 3),
            "updated": self.updated,
            "programs": self.programs,
            "findings": [f.to_json() for f in self.findings],
        }


# ---------------------------------------------------------------------------
# the probe environment (shared by every program_specs() hook)
# ---------------------------------------------------------------------------

_probe: Dict[str, object] = {"owned": False, "groups": {}}


def _fake_world() -> None:
    """The fake default group of PROBE_WORLD ranks, this process rank 0;
    started here (parallel/mesh.init_probe_world) when no group is
    initialized. A group of another backend is refused, never shared."""
    import torch.distributed as dist

    from distributed_ddpg_tpu_torch.parallel.mesh import init_probe_world

    if dist.is_initialized():
        if dist.get_backend() != PROBE_KIND or dist.get_world_size() != PROBE_WORLD:
            raise ProgramBuildError(
                f"a {dist.get_backend()} process group of {dist.get_world_size()} "
                f"rank(s) is initialized; the probe group is the {PROBE_KIND} "
                f"backend's {PROBE_WORLD}-rank group, started in a process of its own")
        return
    init_probe_world(PROBE_WORLD)
    _probe["owned"] = True


def end_probe() -> None:
    """End the fake group if the probe started it, so the process is left as
    the analyzer found it."""
    import torch.distributed as dist

    _probe["groups"] = {}
    if _probe["owned"] and dist.is_initialized():
        dist.destroy_process_group()
    _probe["owned"] = False


def probe_group(device: str, model_axis: int = 1):
    """Rank 0's view of the probe group: PROBE_RANKS data-parallel ranks
    (the JAX probe mesh's 2 devices), or with model_axis 2 the (2, 2) grid
    of the fake world's 4 ranks (the `.tp` variants). Cached a run, so
    make_grid's subgroups are made once."""
    from distributed_ddpg_tpu_torch.parallel.mesh import probe_subgroup

    key = (str(device), int(model_axis))
    groups = _probe["groups"]
    if key not in groups:
        _fake_world()
        groups[key] = probe_subgroup(PROBE_RANKS * model_axis, device)
    return groups[key]


def probe_config(device: str, **overrides):
    """Tiny-but-real DDPGConfig for spec builds (JAX's probe_config): every
    dimension shrunk, nothing else changed. The scan route's update is
    K2's (`fused_update=True`), so every scan-route program launches K2
    on the card; a spec that traces the chunk kernel's route sets it back."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig

    base = dict(
        env_id="Pendulum-v1",
        batch_size=8,
        actor_hidden=(16, 16),
        critic_hidden=(16, 16),
        replay_capacity=64,
        seed=0,
        device=device,
        fused_update=True,
    )
    base.update(overrides)
    return DDPGConfig(**base)


def probe_rows(n: int, width: int, seed: int = 0) -> np.ndarray:
    """n packed replay rows [obs | act | rew | next_obs | done | w]: finite,
    seeded, done 0 and weight 1 (the layout of types.pack_batch_np)."""
    rows = np.random.default_rng(seed).standard_normal((n, width)).astype(np.float32)
    rows[:, -2] = 0.0
    rows[:, -1] = 1.0
    return rows


def probe_replay(config, obs_dim: int, act_dim: int, group=None, sharded: bool = False,
                 capacity: int = 64, fill: int = 32, block_size: int = 8):
    """A device replay of the probe (capacity 64, blocks of 8, `fill` rows
    landed; sharded over `group`'s data ranks when `sharded`), uniform or
    PER as the config says."""
    from distributed_ddpg_tpu_torch.replay.device import (
        DevicePrioritizedReplay,
        DeviceReplay,
    )

    placement = (dict(replay_sharding="sharded", group=group.data)
                 if sharded and group is not None else {})
    if config.prioritized:
        replay = DevicePrioritizedReplay(capacity, obs_dim, act_dim, config.device,
                                         alpha=config.per_alpha, eps=config.per_eps,
                                         block_size=block_size, **placement)
    else:
        replay = DeviceReplay(capacity, obs_dim, act_dim, config.device,
                              block_size=block_size, **placement)
    if fill:
        replay.add_packed(probe_rows(fill, replay.width))
        replay.flush()
    return replay


def named_leaves(obj, prefix: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a state tree by its dotted path (NamedTuple fields,
    dict keys, list indices)."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out: Dict[str, torch.Tensor] = {}
    if hasattr(obj, "_fields"):
        items = ((f, getattr(obj, f)) for f in obj._fields)
    elif isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return out
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}.{k}"))
    return out


def replay_leaves(replay) -> Dict[str, torch.Tensor]:
    out = {"replay.storage": replay.storage}
    if hasattr(replay, "priorities"):
        out["replay.priorities"] = replay.priorities
        out["replay.max_priority"] = replay.max_priority
    return out


def learner_leaves(learner) -> Dict[str, torch.Tensor]:
    """The learner state's leaves by path, plus the guard's probe state
    when guarded."""
    out = named_leaves(learner.state, "state")
    if getattr(learner, "guard_enabled", False):
        out.update(named_leaves(learner._guard, "guard"))
    return out


def probe_beat_stack(device: str, guard: bool, per: bool, sharded: bool, tp: bool = False,
                     **overrides):
    """The fused beat's parts at the probe sizes (JAX's megastep and
    superstep specs: 4 probe envs x rollout chunk 2, learner chunk 2, a
    64-row ring) on the 2-rank probe group, or the (2, 2) grid for `tp`:
    (config, learner, pool, replay)."""
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

    config = probe_config(
        device,
        actor_backend="device",
        num_actors=0,
        device_actor_envs=4,
        device_actor_chunk=2,
        guardrails=guard,
        prioritized=per,
        replay_sharding="sharded" if sharded else "replicated",
        fused_chunk="off",
        fused_beat="on",
        model_axis=2 if tp else 1,
        **overrides,
    )
    group = probe_group(device, model_axis=2 if tp else 1)
    learner = ShardedLearner(config, 3, 1, np.full(1, 2.0, np.float32), chunk_size=2,
                             group=group)
    pool = DeviceActorPool(config, group=learner.group)
    pool.bind(lambda: learner.actor_params_logical)
    replay = probe_replay(config, pool.obs_dim, pool.act_dim, learner.group, sharded)
    return config, learner, pool, replay


# ---------------------------------------------------------------------------
# recording: collective order, host reads
# ---------------------------------------------------------------------------


def _reduce_name(obj) -> str:
    try:
        import torch.distributed as dist

        return dist.ReduceOp.RedOpType(obj.op()).name.lower()
    except Exception:
        return str(obj.op())


def _first_dtype(x) -> Optional[str]:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if isinstance(x, (list, tuple)):
        for y in x:
            d = _first_dtype(y)
            if d is not None:
                return d
    return None


def canonical_collective(func, args) -> str:
    """`op[group size,reduce op,dtype]` of one c10d op, e.g.
    `allreduce_[2,sum,float32]`, `broadcast_[2,float64]`, `barrier[2]`."""
    import torch.distributed as dist

    op = str(func).split(".")[1]
    fields: List[str] = []
    for a in args:
        if isinstance(a, torch.ScriptObject):
            kind = a._type().qualified_name()
            if kind.endswith("ProcessGroup"):
                fields.insert(0, str(dist.ProcessGroup.unbox(a).size()))
            elif kind.endswith("ReduceOp"):
                fields.append(_reduce_name(a))
    dtype = _first_dtype(args[0]) if args else None
    if dtype is not None and op != "barrier":
        fields.append(dtype)
    return f"{op}[{','.join(fields)}]"


def _is_host_read(name: str, args, kwargs) -> bool:
    if name in _SCALAR_READS:
        return True
    if name not in _COPY_OPS or not args or not isinstance(args[0], torch.Tensor):
        return False
    if name == "aten._to_copy.default":
        dst = kwargs.get("device")
        return (args[0].device.type != "cpu" and dst is not None
                and torch.device(dst).type == "cpu")
    src = args[1] if len(args) > 1 and isinstance(args[1], torch.Tensor) else None
    return src is not None and src.device.type != "cpu" and args[0].device.type == "cpu"


class Recorder(TorchDispatchMode):
    """Records, in dispatch order, every c10d op (canonical_collective) and
    counts the host reads of the ops run under it."""

    def __init__(self):
        super().__init__()
        self.collectives: List[str] = []
        self.host_reads = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        self.ops += 1
        if name.startswith("c10d."):
            self.collectives.append(canonical_collective(func, args))
        elif _is_host_read(name, args, kwargs):
            self.host_reads += 1
        return func(*args, **kwargs)


def run_program(built: BuiltProgram) -> Tuple[List[str], int, int, List[str]]:
    """(collectives, host reads, ops, moved leaves) of one run of the
    program. The leaves from before the call stay referenced until the
    comparison, so no new tensor can take a freed storage's address and
    pass for the old one."""
    before = dict(built.leaves())
    rec = Recorder()
    with rec:
        built.fn()
    after = built.leaves()

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else int(t.untyped_storage().data_ptr())

    moved = sorted(k for k in set(before) | set(after)
                   if ptr(before.get(k)) != ptr(after.get(k)))
    del before
    return rec.collectives, rec.host_reads, rec.ops, moved


def fingerprint(collectives: Sequence[str]) -> str:
    blob = "\n".join(collectives).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# golden fingerprints
# ---------------------------------------------------------------------------


def golden_path(golden_dir: Path, name: str) -> Path:
    return golden_dir / (name + ".json")


def load_golden(golden_dir: Path, name: str) -> Optional[Dict]:
    p = golden_path(golden_dir, name)
    if not p.is_file():
        return None
    try:
        return json.loads(p.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return {}


def write_golden(golden_dir: Path, name: str, collectives: Sequence[str], device: str,
                 host_reads: int, moved: Sequence[str],
                 prev: Optional[Dict] = None) -> None:
    """Write the golden of `name`: its collective order, its moved leaves
    and this device's host reads. Another device's host reads (and the
    note that says why they differ) are kept while the collective order is
    the same; a new order drops them."""
    keep = bool(prev) and prev.get("collectives") == list(collectives)
    reads = dict(prev.get("host_reads", {})) if keep else {}
    reads[device] = int(host_reads)
    out = {
        "program": name,
        "probe": PROBE_KIND,
        "collectives": list(collectives),
        "fingerprint": fingerprint(collectives),
        "host_reads": dict(sorted(reads.items())),
        "moved": list(moved),
    }
    if keep and prev.get("device_note"):
        out["device_note"] = prev["device_note"]
    golden_dir.mkdir(parents=True, exist_ok=True)
    golden_path(golden_dir, name).write_text(json.dumps(out, indent=1) + "\n",
                                             encoding="utf-8")


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


def analyze(
    specs: Sequence[ProgramSpec],
    golden_dir: Path,
    update_golden: bool = False,
    only: Optional[Sequence[str]] = None,
    sweep_stale: bool = True,
    device: str = "cuda",
) -> ProgramReport:
    """Run every check over `specs` on `device` (the card unless the
    caller names the CPU). `only` filters by program
    name (exact or fnmatch glob); a scoped run skips the stale-golden
    sweep. `sweep_stale=False` disables the sweep and the --update-golden
    prune even unscoped (an alternate registry covers none of the live
    programs)."""
    t0 = time.perf_counter()
    scoped = only is not None or not sweep_stale
    if only is not None:
        specs = [s for s in specs if any(fnmatch.fnmatch(s.name, pat) for pat in only)]
    dev = torch.device(device).type
    findings: List[ProgramFinding] = []
    programs: List[Dict[str, object]] = []
    updated: List[str] = []
    by_group: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}

    try:
        for spec in specs:
            try:
                built = spec.build(device)
                collectives, reads, n_ops, moved = run_program(built)
            except Exception as e:  # a spec that cannot build must gate
                findings.append(ProgramFinding(
                    spec.name, "build-error",
                    f"program spec failed to build/run: {e!r:.400}",
                ))
                continue
            programs.append({
                "name": spec.name,
                "owner": spec.owner,
                "beat_group": spec.beat_group,
                "device": dev,
                "collectives": collectives,
                "fingerprint": fingerprint(collectives),
                "ops": n_ops,
                "host_reads": reads,
                "moved": moved,
            })
            if spec.beat_group:
                by_group.setdefault(spec.beat_group, []).append(
                    (spec.name, tuple(collectives)))
            if reads and spec.host_reads is None:
                findings.append(ProgramFinding(
                    spec.name, "host-read",
                    f"{reads} host read(s) in the hot program and none declared — "
                    "a read inside a lockstep program couples every rank's beat to "
                    "one host's scheduler; hoist it out, or declare it on the spec "
                    "with its reason",
                ))
            if update_golden:
                prev = load_golden(golden_dir, spec.name)
                if not prev or prev.get("collectives") != collectives or \
                        prev.get("host_reads", {}).get(dev) != reads or \
                        prev.get("moved") != moved:
                    updated.append(spec.name)
                write_golden(golden_dir, spec.name, collectives, dev, reads, moved, prev)
                continue
            golden = load_golden(golden_dir, spec.name)
            if golden is None:
                findings.append(ProgramFinding(
                    spec.name, "collective-order",
                    "no golden fingerprint committed for this program — run "
                    "`python -m distributed_ddpg_tpu_torch.tools.proganalyze "
                    "--update-golden` and review/commit the golden diff",
                ))
                continue
            if golden.get("collectives") != collectives:
                findings.append(ProgramFinding(
                    spec.name, "collective-order",
                    "collective order diverged from the committed golden "
                    f"(golden: {golden.get('collectives')} -> run: {collectives}) — "
                    "on ranks this is exactly how replicas fork; if the reorder is "
                    "intentional, re-run with --update-golden and review the diff",
                ))
            pinned = golden.get("host_reads", {})
            if dev in pinned and pinned[dev] != reads:
                findings.append(ProgramFinding(
                    spec.name, "host-read",
                    f"{reads} host read(s) on {dev}, the golden pins {pinned[dev]} — "
                    "a new read inside a hot program waits for the device; if it "
                    "is intended, re-run with --update-golden and review the diff",
                ))
            held = golden.get("moved")
            if held is not None and held != moved:
                findings.append(ProgramFinding(
                    spec.name, "moved-storage",
                    f"leaves whose storage moved across one call on {dev}: "
                    f"{moved}, the golden holds {held} — a program that "
                    "reallocates state it used to update in place (or the "
                    "reverse) changes what a CUDA graph of it may capture",
                ))
    finally:
        end_probe()

    for group, members in sorted(by_group.items()):
        if len({seq for _, seq in members}) > 1:
            detail = "; ".join(
                f"{name}: [{', '.join(seq) or 'none'}]" for name, seq in members)
            findings.append(ProgramFinding(
                members[0][0], "beat-group",
                f"beat group '{group}' variants disagree on collective order "
                f"({detail}) — these programs dispatch at the SAME lockstep site, "
                "so ranks mixing them fork their collective order",
            ))

    if not scoped and golden_dir.is_dir():
        known = {s.name for s in specs}
        for p in sorted(golden_dir.glob("*.json")):
            if p.stem in known:
                continue
            if update_golden:
                p.unlink()
                updated.append(f"-{p.stem}")
            else:
                findings.append(ProgramFinding(
                    p.stem, "stale-golden",
                    f"golden file {p.name} matches no registered program spec — a "
                    "renamed/removed program must retire its golden (delete it, or "
                    "re-run --update-golden which prunes stale files)",
                ))

    return ProgramReport(findings=findings, programs=programs, updated=updated,
                         elapsed_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the default registry
# ---------------------------------------------------------------------------

# Modules exposing a program_specs() hook, in the JAX package's order;
# --changed-only scoping in the CLI keys on the owner paths they declare.
SPEC_MODULES = (
    "distributed_ddpg_tpu_torch.parallel.learner",
    "distributed_ddpg_tpu_torch.parallel.megastep",
    "distributed_ddpg_tpu_torch.parallel.superstep",
    "distributed_ddpg_tpu_torch.replay.device",
    "distributed_ddpg_tpu_torch.actors.device_pool",
    "distributed_ddpg_tpu_torch.serve.server",
    "distributed_ddpg_tpu_torch.ondevice",
)

# JAX program names the port has no program for, and why (the catalog's
# words; tests hold every JAX golden to a port golden or an entry here).
NO_PORT_PROGRAM: Dict[str, str] = {}


def default_specs() -> List[ProgramSpec]:
    """Every registered hot program of the port, name-deduplicated and
    order-stable."""
    import importlib

    specs: List[ProgramSpec] = []
    for modname in SPEC_MODULES:
        specs.extend(importlib.import_module(modname).program_specs())
    dupes = [n for n, c in Counter(s.name for s in specs).items() if c > 1]
    if dupes:
        raise ValueError(f"duplicate program spec names: {dupes}")
    return specs


def render_human(report: ProgramReport) -> str:
    out = [f.render() for f in report.findings]
    n = len(report.findings)
    if report.updated:
        out.append(f"updated goldens: {', '.join(report.updated)}")
    out.append(
        f"{len(report.programs)} programs, {n} finding"
        f"{'s' if n != 1 else ''} in {report.elapsed_s:.2f}s"
    )
    return "\n".join(out)


def write_report(report: ProgramReport, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report.to_json(), indent=1) + "\n", encoding="utf-8")
