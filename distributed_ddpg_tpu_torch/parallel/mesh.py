"""The rank grid of the port: D x M ranks over torch.distributed.

Counterpart of distributed_ddpg_tpu/parallel/mesh.py. Where the JAX
package builds a (data, model) device mesh in one process, the port runs
one process a rank, one card a rank, joined by a torch.distributed process
group. With model_axis M > 1 (tensor parallelism, parallel/partition.py)
the group's ranks form the JAX mesh's grid, `reshape(data_axis,
model_axis)`: rank r sits at data index r // M and model index r % M.
`make_grid` makes two subgroups a rank: its data group (the D ranks with
its model index: the gradient mean, the sharded replay's exchanges) and
its model group (the M ranks with its data index: the activation
exchanges of the Megatron-split apply, models/mlp.py). Each is a
DataGroup view of its own (`group.data`, `group.model`), whose `rank` is
the rank's index in it, so every collective below runs over a subgroup
as it runs over the world. With M = 1 the data group is the group itself
and the model group a group of one, and nothing changes.

- `DataGroup` is a rank's view of it: its rank, the group's size, its
  device and its control-plane group. The data plane (the learner's
  gradient and state averages, the TD gather) runs on the rank's device,
  over the default group (NCCL or gloo). The control plane (the
  trainer's rows, counts and decisions: `share`, `share_rows`) runs on
  CPU tensors over gloo, so that a control broadcast never waits in a card's stream behind
  a running chunk. Under gloo both planes are one group.
- `resolve_data_axis(config, world_size)` applies the JAX package's rule
  (make_mesh): model_axis must divide the group's size, data_axis -1 is
  the rest, any other value times model_axis must equal the size.
- `init_data_group(backend, device)` joins the group (from torchrun's
  environment, or from an address, rank and size the caller gives) with a
  timeout on every collective, so a rank that dies ends the others with an
  error instead of hanging them.
- `replicas_equal` holds every rank's tensors to rank 0's, bit for bit
  (a rank's shards to its data group's first rank's).
- `all_reduce_mean_` averages a list of tensors in place with one
  collective over one flat buffer (and can sum a second list, exactly, in
  the same collective). On CUDA tensors gloo offers only broadcast and
  all_reduce, so these are the only collectives the port uses on the card:
  a gather is a zero buffer in which each rank writes its own part, summed
  (x + 0 is exact).
- `all_reduce_sum_` sums tensors over the group in place, and
  `all_gather` stacks every rank's tensor, on the data plane (the sharded
  replay's row gather, its PER draw's shard totals and owner sums);
  `gather_env_blocks` joins a sharded rollout's blocks in JAX's global
  row order (step-major, then env: every rank's envs in rank order). The
  gather's buffer is -0.0 where a rank has nothing to say: x + (-0.0) is
  x for every float x, -0.0 and +0.0 included, so a gather or an
  owner-masked sum comes out bit for bit, in any summation order.
- `init_probe_world` and `probe_subgroup` make the program-contract
  analyzer's probe (analysis/programs.py): a `fake` group of ranks in one
  process, and rank 0's view of its first n ranks.

A DataGroup can be made without joining anything: with one rank its
collectives are identities; with more, it serves route decisions alone
(a ShardedLearner's route and batch split), and a collective on it needs
the joined default group.

The group knows its nodes (parallel/multihost.py's pod): the ranks that
torchrun starts under one --node_rank (GROUP_RANK) are a node, and the
node's rank with LOCAL_RANK 0 its lead. `process_index` is this rank's
node among the group's `process_count` nodes, `lead_ranks` each node's
lead, `node_lead` whether this rank leads its node. With more than one
node (GROUP_WORLD_SIZE > 1) init_data_group all-gathers every rank's
(GROUP_RANK, LOCAL_RANK) once to learn them, and makes the pod plane
`pod`: a gloo group of its own for the pod's collectives (the sync_ship
beats run on the transfer scheduler's thread beside the learner's
collectives on the default group). With one node, nothing of this runs:
`share`, `share_rows` and `replicas_equal` work as they do without nodes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Seconds a collective may wait for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class DataGroup:
    """A rank's place in a data-parallel group of `world_size` ranks."""

    rank: int
    world_size: int
    device: torch.device
    ctrl: Optional[object] = None    # control-plane gloo group (None: the default group)
    process_index: int = 0           # this rank's node among the group's nodes
    process_count: int = 1           # the group's nodes
    lead_ranks: Tuple[int, ...] = (0,)   # each node's lead, in node order
    rank_nodes: Tuple[int, ...] = ()     # each rank's node (empty: one node)
    pod: Optional[object] = None     # the pod plane's gloo group (more than one node)
    model_axis: int = 1              # M: the grid's model axis (tensor parallelism)
    pg: Optional[object] = None      # the data plane's process group (None: the default)
    ranks: Optional[Tuple[int, ...]] = None   # a view's global ranks (None: 0..world-1)
    data_view: Optional["DataGroup"] = None   # make_grid's subgroups
    model_view: Optional["DataGroup"] = None
    grids: dict = dataclasses.field(default_factory=dict, repr=False)   # make_grid's cache

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis, rank // M."""
        return self.rank // self.model_axis

    @property
    def model_index(self) -> int:
        """This rank's place on the model axis, rank % M."""
        return self.rank % self.model_axis

    @property
    def data(self) -> "DataGroup":
        """The data group: the ranks with this rank's model index (the
        group itself when M = 1)."""
        if self.model_axis == 1:
            return self
        if self.data_view is None:
            # lint: ok(typed-error): caller bug (a grid view read before
            # make_grid made it), not a failure any recovery path handles
            raise RuntimeError("model_axis > 1 but make_grid has not made the subgroups")
        return self.data_view

    @property
    def model(self) -> "DataGroup":
        """The model group: the ranks with this rank's data index (a group
        of one when M = 1)."""
        if self.model_view is not None:
            return self.model_view
        if self.model_axis > 1:
            # lint: ok(typed-error): caller bug (a grid view read before
            # make_grid made it), not a failure any recovery path handles
            raise RuntimeError("model_axis > 1 but make_grid has not made the subgroups")
        return DataGroup(rank=0, world_size=1, device=self.device, ranks=(self.rank,))

    @property
    def lead(self) -> bool:
        """Rank 0 runs the eval and the log, and decides; on one node it
        also runs the actors."""
        return self.rank == 0

    @property
    def node_lead(self) -> bool:
        """This rank leads its node (LOCAL_RANK 0): on a pod it runs the
        node's actors."""
        return self.rank == self.lead_ranks[self.process_index]

    @property
    def model_on_node(self) -> bool:
        """Every rank of this rank's model group is on this rank's node (a
        node's ranks live or go together: on a pod abort such a group can
        still gather its shards)."""
        if not self.rank_nodes:
            return True
        return all(self.rank_nodes[r] == self.process_index
                   for r in (self.model.ranks or (self.rank,)))

    @property
    def is_pod(self) -> bool:
        """More than one node: the pod layer is on (parallel/multihost.py)."""
        return self.process_count > 1


def resolve_data_axis(config, world_size: int) -> int:
    """The number of data-parallel ranks: config.data_axis, -1 meaning the
    whole group (over model_axis); any other value must equal the group's
    size (times model_axis: the JAX package's make_mesh raises the same
    way when the devices disagree)."""
    world_size = int(world_size)
    m = int(getattr(config, "model_axis", 1))
    if m > 1:
        if world_size % m:
            raise ValueError(f"model_axis={m} must divide device count {world_size}")
        data_axis = world_size // m if config.data_axis == -1 else config.data_axis
        if data_axis * m != world_size:
            raise ValueError(f"mesh {data_axis}x{m} != {world_size} devices")
        return data_axis
    if config.data_axis == -1:
        return world_size
    if config.data_axis != world_size:
        raise ValueError(
            f"data_axis={config.data_axis} but the torch.distributed group has "
            f"{world_size} rank(s): launch D processes (torchrun "
            f"--nproc_per_node=D) or pass data_axis=-1"
        )
    return world_size


def init_data_group(backend: str = "nccl", device=None, init_method: Optional[str] = None,
                    rank: Optional[int] = None, world_size: Optional[int] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """Join the data-parallel group and return this rank's DataGroup.

    Without `init_method`, the rank, size and rendezvous come from the
    environment torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT). Under NCCL the rank's device is cuda:{LOCAL_RANK}, and a
    request for more ranks on a host than it has cards raises; under gloo
    it is `device` (the CPU when none is named), so two gloo ranks may
    share one card. Every collective of the group raises after
    `timeout_s` seconds without its peers. With GROUP_WORLD_SIZE > 1 in
    the environment (a pod) the nodes are learned as the module's
    docstring says."""
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if backend == "nccl":
        if not torch.cuda.is_available():
            # lint: ok(typed-error): a launch configuration refused before
            # the group exists; nothing recovers from it, the trainer stops
            raise RuntimeError("backend='nccl' needs CUDA; torch.cuda.is_available() is False")
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            # lint: ok(typed-error): a launch configuration refused before
            # the group exists; nothing recovers from it, the trainer stops
            raise RuntimeError(
                f"NCCL rank {rank} (local rank {local_rank}) has no card of its "
                f"own: this host has {cards}; NCCL runs one rank a card (gloo can "
                f"share one)"
            )
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device if device is not None else "cpu")
        if device.type == "cuda" and not torch.cuda.is_available():
            # lint: ok(typed-error): a launch configuration refused before
            # the group exists; nothing recovers from it, the trainer stops
            raise RuntimeError(f"device {device} but torch.cuda.is_available() is False")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    ctrl = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
    group = DataGroup(rank=dist.get_rank(), world_size=dist.get_world_size(), device=device,
                      ctrl=ctrl)
    if int(os.environ.get("GROUP_WORLD_SIZE", "1")) > 1:
        _learn_nodes(group, int(os.environ.get("GROUP_RANK", "0")), local_rank, timeout)
    return group


def _learn_nodes(group: DataGroup, node_rank: int, local_rank: int, timeout) -> None:
    """Fill in the group's nodes from one all-gather of every rank's
    (GROUP_RANK, LOCAL_RANK) on the control plane, and make the pod plane
    when there is more than one node. Every node must have exactly one
    rank with LOCAL_RANK 0."""
    import torch.distributed as dist

    mine = torch.tensor([node_rank, local_rank], dtype=torch.int64)
    outs = [torch.empty_like(mine) for _ in range(group.world_size)]
    dist.all_gather(outs, mine, group=group.ctrl)
    pairs = [tuple(int(v) for v in t.tolist()) for t in outs]
    nodes = sorted({n for n, _ in pairs})
    leads = []
    for n in nodes:
        here = [r for r, (node, local) in enumerate(pairs) if node == n and local == 0]
        if len(here) != 1:
            # lint: ok(typed-error): a launch layout refused while the group
            # forms (torchrun's LOCAL_RANK per node), before any beat runs
            raise RuntimeError(f"node {n} has {len(here)} ranks with LOCAL_RANK 0 "
                               f"(ranks' (GROUP_RANK, LOCAL_RANK): {pairs})")
        leads.append(here[0])
    group.process_index = nodes.index(node_rank)
    group.process_count = len(nodes)
    group.lead_ranks = tuple(leads)
    group.rank_nodes = tuple(nodes.index(n) for n, _ in pairs)
    if group.process_count > 1:
        group.pod = dist.new_group(backend="gloo", timeout=timeout)


def make_grid(group: Optional[DataGroup], model_axis: int,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[DataGroup]:
    """`group`'s ranks laid out as the (data, model) grid of `model_axis`
    columns, with this rank's two subgroups (the module's docstring): a
    copy of the group, which is left as it is. A collective the first
    time for a given model_axis (the copy is kept on the group): every
    rank calls it, and each makes every subgroup, in one order
    (torch.distributed.new_group's rule). With model_axis 1, or no group,
    the group itself."""
    m = int(model_axis)
    if group is None or m == 1:
        return group
    if m in group.grids:
        return group.grids[m]
    n = group.world_size
    if n % m:
        raise ValueError(f"model_axis={m} must divide device count {n}")
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=float(timeout_s))
    d, r = n // m, group.rank
    views = {}
    for kind, sets in (("model", [tuple(i * m + j for j in range(m)) for i in range(d)]),
                       ("data", [tuple(i * m + j for i in range(d)) for j in range(m)])):
        for ranks in sets:
            pg = dist.new_group(list(ranks), timeout=timeout)
            if r in ranks:
                views[kind] = DataGroup(rank=ranks.index(r), world_size=len(ranks),
                                        device=group.device, ctrl=pg, pg=pg, ranks=ranks)
    grid = dataclasses.replace(group, model_axis=m, data_view=views["data"],
                               model_view=views["model"], grids={})
    group.grids[m] = grid
    return grid


def serve_group(group: Optional[DataGroup], timeout_s: float) -> Optional[DataGroup]:
    """The tensor-parallel serve apply's group (serve/server.py `mesh=`):
    this rank's model group (the same ranks, the model index 0 rank first,
    the source of its broadcasts) as a gloo group of its own, made for the
    apply alone, so that its collectives (on the server's thread and the
    followers') never interleave with the learner's on the model group;
    each of them raises after `timeout_s` seconds without its peers. A
    collective: every rank makes every model group's, in one order
    (torch.distributed.new_group's rule). None without a grid."""
    if group is None or group.model_axis == 1:
        return None
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=float(timeout_s))
    m, d = group.model_axis, group.world_size // group.model_axis
    mine = None
    for i in range(d):
        ranks = tuple(i * m + j for j in range(m))
        pg = dist.new_group(list(ranks), timeout=timeout, backend="gloo")
        if group.rank in ranks:
            mine = DataGroup(rank=ranks.index(group.rank), world_size=m, device=group.device,
                             ctrl=pg, pg=pg, ranks=ranks)
    return mine


def init_probe_world(world_size: int) -> None:
    """The default group of the program-contract analyzer's probe
    (analysis/programs.py): the `fake` backend's `world_size` ranks, of
    which this one process is rank 0. Its collectives return this rank's
    own values and wait for no peer, so it has no deadline."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg as fake_pg

    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0, world_size=world_size)


def probe_subgroup(n: int, device) -> DataGroup:
    """Rank 0's view of the first `n` ranks of the probe world
    (init_probe_world): the world itself, or a subgroup of its own."""
    import torch.distributed as dist

    device = torch.device(device)
    if n == dist.get_world_size():
        return DataGroup(rank=0, world_size=n, device=device)
    pg = dist.new_group(list(range(n)))
    return DataGroup(rank=0, world_size=n, device=device, ctrl=pg, pg=pg,
                     ranks=tuple(range(n)))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _scatter_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    pos = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[pos:pos + n].view(t.shape))
        pos += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Optional[DataGroup],
                     sums: Sequence[torch.Tensor] = ()) -> None:
    """In place: each of `tensors` becomes its mean over the group, and each
    of `sums` its sum, with one all_reduce over one flat f32 buffer (the
    sum, then the mean's part divided by D; the order of a sum is the
    backend's, the same on every rank). A group of one, or none, leaves
    them as they are."""
    if group is None or group.world_size == 1:
        return
    import torch.distributed as dist

    tensors, sums = list(tensors), list(sums)
    flat = _flat(tensors + sums)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
    n = sum(t.numel() for t in tensors)
    flat[:n].div_(group.world_size)
    _scatter_back(flat, tensors + sums)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: Optional[DataGroup]) -> None:
    """In place: each tensor becomes its sum over the group's ranks, on the
    data plane (one all_reduce a tensor, each in its own dtype). A group
    of one, or none, leaves them as they are."""
    if group is None or group.world_size == 1:
        return
    import torch.distributed as dist

    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)


def all_gather(tensor: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Every rank's `tensor` (the same shape and dtype on each) stacked in
    rank order, [world_size, *shape], on every rank, over the data plane:
    a buffer of -0.0 (0 for integers) with this rank's row written, summed.
    Without a group, tensor[None]."""
    if group is None or group.world_size == 1:
        return tensor.unsqueeze(0)
    out = torch.full((group.world_size, *tensor.shape),
                     -0.0 if tensor.dtype.is_floating_point else 0,
                     dtype=tensor.dtype, device=tensor.device)
    out[group.rank] = tensor
    all_reduce_sum_([out], group)
    return out


def gather_env_blocks(block: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """A sharded rollout's rows in the global order: every rank's
    [K, E/D, W] block (rank r steps envs r*E/D ... (r+1)*E/D - 1, the
    contiguous blocks JAX's P('data') gives the env axis) into the
    [K*E, W] step-major block on every rank, env e of step k at row
    k*E + e, as JAX's replicated rows have them. all_gather stacks
    rank-major ([D, K, E/D, W]); the steps go first, then the ranks.
    Bit for bit the ranks' rows (the gather adds -0.0). Without a group,
    or with one rank, the block flattened."""
    w = block.shape[-1]
    if group is None or group.world_size == 1:
        return block.reshape(-1, w)
    return all_gather(block, group).transpose(0, 1).reshape(-1, w)


def _broadcast(tensor: torch.Tensor, group: Optional[DataGroup], control: bool = False) -> None:
    """The group's first rank's `tensor` into every rank's, in place; over
    the control plane (CPU tensors, gloo) when `control`, else the data
    plane."""
    if group is None or group.world_size == 1:
        return
    import torch.distributed as dist

    src = group.ranks[0] if group.ranks else 0
    dist.broadcast(tensor, src=src, group=group.ctrl if control else group.pg)


def share(values: Sequence[float], group: Optional[DataGroup]) -> list:
    """Rank 0's numbers on every rank (the control plane; float64, so
    counts up to 2^53 and Python floats come across exactly). Without a
    group, or with one rank, the values themselves."""
    if group is None or group.world_size == 1:
        return list(values)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    _broadcast(t, group, control=True)
    return t.tolist()


def share_rows(rows: Optional[np.ndarray], width: int,
               group: Optional[DataGroup]) -> Optional[np.ndarray]:
    """Rank 0's packed f32 rows [n, width] (None: no rows) on every rank:
    first their count, then the rows, over the control plane. Without a
    group, or with one rank, `rows` itself."""
    if group is None or group.world_size == 1:
        return rows
    n = int(share([0 if rows is None else len(rows)], group)[0])
    if n == 0:
        return None
    buf = (torch.from_numpy(np.ascontiguousarray(rows, np.float32)) if group.lead
           else torch.empty((n, int(width)), dtype=torch.float32))
    _broadcast(buf, group, control=True)
    return buf.numpy()


def _differs(tensors: Sequence[torch.Tensor], group: DataGroup) -> bool:
    """Whether this rank's tensors differ, bit for bit, from the group's
    first rank's (which broadcasts their bytes on the data plane)."""
    if not tensors or group.world_size == 1:
        return False
    mine = torch.cat([t.detach().reshape(-1).contiguous().view(torch.uint8) for t in tensors])
    lead = mine.clone()
    _broadcast(lead, group)
    return not torch.equal(lead, mine)


def replicas_equal(tensors: Sequence[torch.Tensor], group: Optional[DataGroup],
                   sharded: Optional[Sequence[bool]] = None) -> bool:
    """True on every rank when every rank's tensors equal rank 0's bit for
    bit: rank 0 broadcasts their bytes on the data plane, each rank
    compares its own, and the verdicts are summed, so all ranks return the
    same answer. On a grid with model_axis > 1, `sharded` marks the
    tensors that are a rank's shards: those are held to the first rank of
    the rank's data group (the ranks with the same shards), the others to
    rank 0 of the whole group."""
    if group is None or group.world_size == 1:
        return True
    import torch.distributed as dist

    tensors = list(tensors)
    if sharded is None or group.model_axis == 1:
        differ = _differs(tensors, group)
    else:
        differ = (_differs([t for t, s in zip(tensors, sharded) if not s], group)
                  | _differs([t for t, s in zip(tensors, sharded) if s], group.data))
    device = tensors[0].device if tensors else group.device
    verdict = torch.tensor([1.0 if differ else 0.0], dtype=torch.float32, device=device)
    dist.all_reduce(verdict, op=dist.ReduceOp.SUM, group=group.pg)
    return float(verdict) == 0.0
