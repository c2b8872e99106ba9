"""Device-resident replay: the packed ring lives in device memory.

Counterpart of distributed_ddpg_tpu/replay/device.py (DeviceReplay and
DevicePrioritizedReplay, replicated or sharded over the ranks). The packed
[capacity, 2*obs+act+3] f32 ring sits on the learner's device; the learner
samples it there (one gather of K*B rows per chunk, parallel/learner.py),
so a chunk needs no host->device copy.

Ingest pipeline (the JAX package's, port of its `_IngestShipper`,
`dispatch_lock` and transfer-scheduler items):

- `add_packed` stages actor rows in a host ring (replay/staging.py, 16
  blocks) and returns; full blocks ship as COALESCED super-blocks: up to
  the coalesce cap (`max_coalesce`, or the adaptive controller's
  effective cap, transfer/adaptive.py) of staged blocks, a power of two,
  in one insert, at most the capacity, so no position is written twice
  in one insert;
- an insert is one H2D copy straight into the ring's slice (two when it
  wraps), on the learner's stream. With `host_pool` the rows are popped
  into a pooled staging buffer (transfer/hostbuf.py; pinned on the
  card), the copy is non-blocking, and the buffer is fenced on a CUDA
  event recorded right after the insert, so it is reused only once the
  copy has run. A pageable copy (no pool) makes CUDA wait for the
  running chunk before it starts, holding whichever thread shipped;
- with `async_ship` the ships run off the caller's thread: on the
  transfer scheduler's dispatch thread as ingest items when a
  `scheduler` is given (one item in flight, re-armed while full blocks
  remain), else on a private shipper thread. The producer blocks only
  when the staging ring is full (`ingest_stall_ms`). A failed ship
  restarts the shipper (or resubmits the item) up to 3 times, then the
  producer's next call raises IngestError. `close()` stops it; later
  inserts ship inline. `fault` (the plan's `shipper:ship` site,
  --faults='shipper:ship:crash@K') is ticked once a ship; each ship is an
  `ingest_ship` span (a padded flush `ingest_flush`), a restart a
  `shipper_restart` instant and a producer's wait on a full ring an
  `ingest_backpressure` span (trace.py);
- `dispatch_lock` (an RLock) serializes every sequence that reads or
  moves ptr/size with the device work it issues: each ship (pop, copy,
  PER stamp, ptr/size), each chunk's draw and gather (parallel/learner.py),
  reward_sample, state_dict and load_state_dict. So the stream order of
  inserts and chunks is the order the host saw ptr and size change in,
  whatever thread shipped: a chunk dispatched before an insert gathers
  the rows as they were, and one dispatched after sees the new rows;
- positions, `ptr`, `size` and the PER stamps are bit-identical to the
  serial block-at-a-time sequence (max_coalesce=1) for any cap sequence:
  rows land in FIFO order at consecutive positions mod capacity, and
  `flush` pads the remainder by repetition to one block, as the JAX
  package's does.

`ptr` and `size` are host integers: the host drives every insert, so it
knows them without reading the device.

The sharded placement (`replay_sharding='sharded'`, the JAX package's;
`group` is the data-parallel group, parallel/mesh.py) partitions the same
logical ring over the group's D ranks with strided ownership: logical
position p lives on rank p % D at local slot p // D, so each rank holds
capacity / D rows (and PER's priority vector the same slots). capacity
and block_size divide by D and every insert moves a multiple of D rows,
so ptr % D == 0 always and the rows of an insert at ptr land on rank r
at rows[r::D], one contiguous run of local slots from ptr // D. A ship
copies only those rows to the device: on one node from the rows
share_rows gives every rank, on a pod from the beat's gathered block
(which rides the scheduler's `shard_exchange` class). ptr, size, the
insert positions and every logical row are those of the replicated ring
(the parity the tests hold), so the learner's owner-masked gather
(parallel/learner.py) rebuilds the replicated minibatch bit for bit. A
rank is a process here, so the JAX package's multi-process rules hold on
D > 1 ranks: no single-writer state_dict (ReplayUsageError), and each
rank writes its own slice (slice_state_dict, checkpoint.
write_replay_slice); load_state_dict takes the merged logical state
(merge_slice_states) on every rank and keeps the rank's positions, so a
set written by any number of ranks loads on today's. One rank sharded is
one slice over the whole ring. The placement's figures (the replay_*
fields, metrics.ReplayShardStats) are measured on the rank: the bytes it
copied, its storage tensor's bytes, the rows it landed.

On a pod (`pod`, a parallel/mesh.DataGroup of more than one node;
parallel/multihost.py) the ring is replicated on every rank and rows
leave a node only through the sync_ship beat, the JAX package's
lockstep ingest:

- add_packed only stages (no ship, no shipper): each node's lead stages
  its own actors' rows; the node's other ranks stage nothing;
- `sync_ship(force)` is one beat, called by every rank at the same
  point of its loop: it all-gathers the nodes' staged counts (with the
  heartbeat word, multihost.beat_allgather), takes the common minimum m,
  and ships m // block_size full blocks from every node in power-of-two
  super-blocks of k blocks (at most the coalesce cap and the capacity
  over procs * block_size), each one gather of every node's k blocks
  (multihost.allgather_rows) landed at ptr + j*(procs*bs) + p*bs + r for
  node p's block j row r (`_ship_global`, the layout of the JAX replay's
  permuted all-gather insert); with `force` a remainder present on every
  node is padded by repetition to one block (warmup). The PER twin
  stamps every landed row with the max priority, as the JAX twin does;
- with `background_sync` and a scheduler the beat runs as a lockstep
  item (`sync_ship_begin` returns its ticket, which the caller waits
  before its next collective); even a synchronous sync_ship goes through
  the lane then, so the beats keep one order. Each beat reads its
  staged count when it runs on the lane, after every earlier beat;
- the pod fault site (`arm_pod_fault`, faults.FaultPlan.pod_site) is
  ticked once a beat before its collective; the beat is a `sync_ship`
  span, each landed super-block an `ingest_ship_global` span.

Device rows (the device actors, actors/device_pool.py, and the fused beat,
parallel/megastep.py): `insert_device_rows` lands an [M, D] block that is
already on the device as one wraparound scatter at (ptr + arange(M)) mod
capacity, on the learner's stream, under dispatch_lock: no staging ring,
no transfer-scheduler item, no IngestStats traffic (a device-actor-only
run ships nothing). The PER subclass stamps the landed run with the max
priority from the pre-insert pointer. `note_device_rows(m)` then advances
the host ptr/size and, under track_sources, stamps the landed positions
untracked (-1), so the source map stays aligned when host actors feed the
same ring.

Source attribution (`track_sources`, the guardrails' bad-row quarantine;
JAX :354-369, :560-605): add_packed tags its rows with an ingest source
(the actor slot), a FIFO of [source, rows] runs beside the staging ring
and is popped with it, under the same lock, and each ship that lands
stamps a host map of storage position -> source from the ptr it wrote at
(a padded flush's copies inherit their originals' tags). So tags survive
coalesced ships, the shipper and its bounded restart (a failed ship loses
its rows and their tags together). `sources_of(idx)` reads the map: -1
where no source is known (tracking off, restored rows, untagged rows).

DevicePrioritizedReplay adds proportional PER on the device, as the JAX
package's does: an f32 [capacity] priority vector and a 0-d max priority,
both device tensors; every insert stamps its rows with the max priority,
and the learner draws with `draw_per_indices` and writes the chunk's new
priorities back (parallel/learner.py run_sample_chunk_per). Neither reads
the device back.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.devices import require_device
from distributed_ddpg_tpu_torch.metrics import IngestStats, ReplayShardStats
from distributed_ddpg_tpu_torch.replay.staging import HostStagingRing
from distributed_ddpg_tpu_torch.transfer import AdaptiveCoalesce, HostBufferPool
from distributed_ddpg_tpu_torch.types import packed_width


SCAN_BLOCK = 256   # row length of the blocked scan (PERF.md: PER, the prefix sum)
SCAN_SERIAL = 64   # at most this many totals are scanned one after another


def fixed_order_cumsum(x: torch.Tensor, block: int = SCAN_BLOCK) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D f32 tensor whose addition order is
    fixed by its length alone, so it is bit-identical run to run on the
    card. The vector, zero-padded to m >= 2 rows of `block`, is scanned
    along each row (torch's innermost-dimension scan: one tree a row, no
    atomics); the m row totals are scanned the same way, recursively, down
    to at most SCAN_SERIAL of them, which are scanned down a [n, 2] column
    pair (torch's outer-dimension scan: one thread a column, in order);
    each row then adds the exclusive prefix of the totals before it. A
    1-D torch.cumsum on the card goes through CUB's decoupled look-back
    instead, whose order depends on timing; these 2-D shapes never reach
    it. Over 1M priorities: 3907 rows of 256, then their totals in 16
    rows, then those 16 totals in order."""
    n = x.numel()
    if n <= SCAN_SERIAL:
        return torch.cumsum(torch.stack([x, x], 1), 0)[:, 0]
    m = max(2, -(-n // block))
    rows = x.new_zeros(m * block)
    rows[:n] = x
    inner = torch.cumsum(rows.view(m, block), 1)
    running = fixed_order_cumsum(inner[:, -1].contiguous(), block)
    before = torch.cat([running.new_zeros(1), running[:-1]])
    return (inner + before[:, None]).view(-1)[:n]


def draw_per_indices(priorities: torch.Tensor, size: int, shape, beta: float,
                     generator: Optional[torch.Generator] = None,
                     uniform: Optional[torch.Tensor] = None):
    """Stratified proportional PER draw on the priorities' device, the JAX
    package's draw_per_indices step by step: one cumsum over the priority
    vector, u = (arange(B) + U[K, B]) / B * total, a searchsorted (side
    right) clamped to size - 1, and IS weights (size * p / total)^-beta
    divided by their max over each row of B. `uniform` ([K, B] in [0, 1))
    replaces the draw from `generator`. Returns (idx [K, B] int64,
    weights [K, B] f32); nothing is read back to the host.

    The cumsum's f32 summation order differs by device (and from XLA's),
    so two devices draw the same indices only where the running sums are
    exact (for example dyadic priorities with a small total). On the card
    the prefix sum is fixed_order_cumsum, so a draw is bit-identical run
    to run and on every replica of a data-parallel group (each rank draws
    the same global indices from the same priorities); on the CPU it is
    torch.cumsum (which sums in double)."""
    k, b = shape
    cum = (torch.cumsum(priorities, 0) if priorities.device.type == "cpu"
           else fixed_order_cumsum(priorities))
    total = cum[-1]
    if uniform is None:
        uniform = torch.rand((k, b), generator=generator, device=priorities.device)
    u = (torch.arange(b, dtype=torch.float32, device=priorities.device)[None, :]
         + uniform) / b * total
    idx = torch.searchsorted(cum, u.reshape(-1), right=True).reshape(k, b)
    idx = idx.clamp_max(max(int(size) - 1, 0))
    probs = priorities[idx] / total.clamp_min(1e-12)
    weights = (float(size) * probs.clamp_min(1e-12)) ** (-float(beta))
    return idx, weights / weights.amax(dim=-1, keepdim=True)


def scatter_last_wins(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """target[idx[i]] = vals[i] in place, in flat order: where an index
    occurs more than once, its last occurrence wins (XLA's scatter on the
    CPU does the same; the JAX package leaves it unspecified). A stable
    sort groups the duplicates in flat order and every member of a group
    writes the group's last value, so the result is the same on every
    device and run, with no host read."""
    sorted_idx, order = torch.sort(idx, stable=True)
    last = torch.searchsorted(sorted_idx, sorted_idx, right=True) - 1
    target[sorted_idx] = vals[order[last]]


def owner_scatter_last_wins(local: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                            n_shards: int, shard: int) -> None:
    """The sharded twin of scatter_last_wins (JAX parallel/learner.py
    scatter_prios): of the global logical indices `idx`, this rank writes
    only those it owns (idx % n_shards == shard) into its local slots
    idx // n_shards, the last occurrence in flat order winning, as in the
    replicated write. The others go to a scratch slot past the end, so
    nothing is read back to the host."""
    if n_shards == 1:
        scatter_last_wins(local, idx, vals)
        return
    sc = local.shape[0]
    loc = torch.where(idx % n_shards == shard, idx // n_shards, sc)
    buf = torch.cat([local, local.new_zeros(1)])
    scatter_last_wins(buf, loc, vals)
    local.copy_(buf[:sc])


def draw_sharded_per_indices(priorities: torch.Tensor, size: int, shape, beta: float,
                             group, generator: Optional[torch.Generator] = None,
                             uniform: Optional[torch.Tensor] = None):
    """The sharded counterpart of draw_per_indices (JAX
    make_sharded_per_draw): `priorities` is this rank's [capacity / D]
    slice of the strided vector (logical p at rank p % D, slot p // D).
    Each rank prefix-sums its own slots (fixed_order_cumsum on the card),
    the D shard totals are all-gathered and prefix-summed once, the same
    on every rank, into half-open mass intervals [lo, hi) with +inf as the
    last rank's upper bound; the stratified uniforms come from the
    learner's generator (the same on every rank; `uniform` replaces
    them); each u falls in one rank's interval, that rank searches its
    own prefix sum with u - lo, clamped to its live slots, and contributes
    the logical index and its priority; two sum all-reduces put both on
    every rank. The weights are draw_per_indices' formula. The
    distribution is the replicated draw's, the index stream is not (the
    prefix sums are partitioned). With one rank, draw_per_indices."""
    from distributed_ddpg_tpu_torch.parallel import mesh

    n = group.world_size if group is not None else 1
    if n == 1:
        return draw_per_indices(priorities, size, shape, beta, generator=generator,
                                uniform=uniform)
    k, b = shape
    s = group.rank
    dev = priorities.device
    sc = priorities.shape[0]
    cum = (torch.cumsum(priorities, 0) if dev.type == "cpu"
           else fixed_order_cumsum(priorities))
    totals = mesh.all_gather(cum[-1].reshape(1), group).reshape(-1)
    cumtot = torch.cumsum(torch.stack([totals, totals], 1), 0)[:, 0]
    total = cumtot[-1]
    lo = cumtot[s - 1] if s > 0 else total.new_zeros(())
    hi = cumtot[s] if s < n - 1 else total.new_full((), math.inf)
    if uniform is None:
        uniform = torch.rand((k, b), generator=generator, device=dev)
    u = (torch.arange(b, dtype=torch.float32, device=dev)[None, :] + uniform) / b * total
    mine = (u >= lo) & (u < hi)
    loc = torch.searchsorted(cum, (u - lo).reshape(-1), right=True).reshape(k, b)
    # Clamped to this rank's last live slot: a u rounded past lo + its
    # total must not select an empty, zero-priority slot (JAX's clamp).
    live = max((int(size) - s + n - 1) // n, 1)
    loc = loc.clamp_max(min(live - 1, sc - 1))
    idx = torch.where(mine, loc * n + s, torch.zeros_like(loc))
    prio = torch.where(mine, priorities[loc], torch.zeros_like(u))
    mesh.all_reduce_sum_([idx, prio], group)
    probs = prio / total.clamp_min(1e-12)
    weights = (float(size) * probs.clamp_min(1e-12)) ** (-float(beta))
    return idx, weights / weights.amax(dim=-1, keepdim=True)


def make_sharded_per_draw(group):
    """The sharded PER draw over `group` with draw_per_indices' signature
    (JAX make_sharded_per_draw(mesh))."""
    def draw(priorities, size, shape, beta, generator=None, uniform=None):
        return draw_sharded_per_indices(priorities, size, shape, beta, group,
                                        generator=generator, uniform=uniform)

    return draw


def merge_slice_states(slices):
    """A complete all-writer slice set (checkpoint.load_replay_slices, any
    order) as one logical-order state_dict, load_state_dict's format (JAX
    merge_slice_states, its checks and messages): the slices must agree on
    ptr, size and capacity, and their positions must tile [0, size)
    exactly once; a hole or an overlap means the set mixes worlds or
    writers."""
    if not slices:
        raise ReplayUsageError("merge_slice_states: empty slice set")
    size = int(slices[0]["size"])
    ptr = int(slices[0]["ptr"])
    cap = int(slices[0]["capacity"])
    for sl in slices:
        got = (int(sl["size"]), int(sl["ptr"]), int(sl["capacity"]))
        if got != (size, ptr, cap):
            raise ReplayUsageError(
                f"slice set disagrees on ring scalars: {got} != "
                f"{(size, ptr, cap)} (slices from different steps or runs)")
    width = int(np.asarray(slices[0]["rows"]).shape[-1])
    packed = np.zeros((size, width), np.float32)
    covered = np.zeros(size, bool)
    has_prio = any("priorities" in sl for sl in slices)
    prios = np.zeros(size, np.float32) if has_prio else None
    maxp = 1.0
    for sl in slices:
        pos = np.asarray(sl["positions"], np.int64)
        if pos.size == 0:
            continue
        if pos.min() < 0 or pos.max() >= size:
            raise ReplayUsageError(
                f"slice positions out of range [0, {size}): [{pos.min()}, {pos.max()}]")
        if covered[pos].any():
            raise ReplayUsageError(
                "overlapping slice positions (two writers claim the same "
                "ring rows — mixed slice sets)")
        packed[pos] = np.asarray(sl["rows"], np.float32)
        covered[pos] = True
        if has_prio:
            prios[pos] = np.asarray(sl["priorities"], np.float32)
            maxp = max(maxp, float(sl["max_priority"]))
    if not covered.all():
        raise ReplayUsageError(
            f"slice set does not cover the ring: {int((~covered).sum())} "
            f"of {size} positions missing")
    out = {"packed": packed, "ptr": np.asarray(ptr), "size": np.asarray(size)}
    if has_prio:
        out["priorities"] = prios
        out["max_priority"] = np.asarray(maxp, np.float32)
    return out


def split_slice_state(state, nslices: int, capacity: int):
    """A logical state_dict as `nslices` position-strided slices (position
    p to slice p % nslices, what a sharded group of that many ranks
    writes): merge_slice_states' inverse (JAX split_slice_state)."""
    n = int(state["size"])
    out = []
    for k in range(nslices):
        pos = np.arange(k, n, nslices, dtype=np.int64)
        sl = {
            "positions": pos,
            "rows": np.asarray(state["packed"], np.float32)[pos],
            "ptr": np.asarray(int(state["ptr"]), np.int64),
            "size": np.asarray(n, np.int64),
            "capacity": np.asarray(int(capacity), np.int64),
        }
        if "priorities" in state:
            sl["priorities"] = np.asarray(state["priorities"], np.float32)[pos]
            sl["max_priority"] = np.asarray(state["max_priority"], np.float32)
        out.append(sl)
    return out


def _placement(capacity: int, block_size: int, replay_sharding: str, group):
    """(sharded, shards, this rank's shard) with the JAX replay's checks."""
    if replay_sharding not in ("replicated", "sharded"):
        raise ValueError(f"replay_sharding must be 'replicated' or 'sharded', got "
                         f"{replay_sharding!r}")
    if replay_sharding == "replicated":
        return False, 1, 0
    n = group.world_size if group is not None else 1
    if capacity % n:
        raise ValueError(
            f"replay_capacity {capacity} must divide evenly over {n} shards "
            "(mod-capacity wraparound must preserve the position's owner residue)")
    if block_size % n:
        raise ValueError(
            f"block_size {block_size} must divide evenly over {n} shards (each "
            "ship lands rows on every owner in exactly even groups)")
    return True, n, (group.rank if group is not None else 0)


class ReplayUsageError(RuntimeError):
    """A device-replay entry point used outside the mode it supports (a
    single-writer checkpoint of a ring sharded over ranks, an unaligned
    sharded insert, an empty slice set). Nothing died: unlike
    IngestError, the call itself is wrong."""


class IngestError(RuntimeError):
    """The background ingest shipper (or the scheduler's ingest work)
    died past its restart budget; the original exception rides along as
    __cause__."""


class _IngestShipper:
    """The private background shipper (async_ship without a scheduler):
    moves staged full blocks to the device off the producer's thread. The
    staging ring is its bounded buffer: a full ring blocks producers in
    add_packed."""

    def __init__(self, replay: "DeviceReplay"):
        self._replay = replay
        self._stop = threading.Event()
        self.exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="ingest-ship")

    def start(self) -> "_IngestShipper":
        self._thread.start()
        return self

    def _run(self) -> None:
        r = self._replay
        try:
            while not self._stop.is_set():
                with r._staging:
                    while len(r._ring) < r.block_size and not self._stop.is_set():
                        r._staging.wait(0.1)
                if self._stop.is_set():
                    return
                r._drain_ring()
        except Exception as e:   # surfaces in the producer's next call
            self.exc = e
            with r._staging:
                r._staging.notify_all()   # unblock backpressure waiters

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._replay._staging:
            self._replay._staging.notify_all()
        self._thread.join(timeout=timeout)


class DeviceReplay:
    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device="cuda",
                 block_size: int = 4096, staging_blocks: int = 16,
                 async_ship: bool = False, max_coalesce: int = 8, scheduler=None,
                 adaptive_coalesce: bool = False, host_pool: bool = False,
                 track_sources: bool = False, fault=None, pod=None,
                 background_sync: bool = False, pod_fault=None,
                 replay_sharding: str = "replicated", group=None):
        self.capacity = int(capacity)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.block_size = int(block_size)
        self.width = packed_width(obs_dim, act_dim)
        self.device = require_device(device)
        # The placement (module docstring): `group` is the data-parallel
        # group whose ranks share the ring when it is sharded.
        self.sharded, self.n_shards, self.shard = _placement(
            self.capacity, self.block_size, replay_sharding, group)
        self._group = group
        self.shard_capacity = self.capacity // self.n_shards
        self.storage = torch.zeros(
            (self.shard_capacity, self.width), dtype=torch.float32, device=self.device
        )
        self.ptr = 0
        self.size = 0
        self.local_fill = 0   # the rows this rank's storage holds (measured)
        self._shard_stats = ReplayShardStats()
        on_card = self.device.type == "cuda"
        # The learner's stream (the constructing thread's current one): a
        # shipping thread enters it, since torch's current stream is per
        # thread.
        self._stream = torch.cuda.current_stream(self.device) if on_card else None

        self._max_coalesce = max(1, int(max_coalesce))
        self._ring = HostStagingRing(
            self.width, max(1, int(staging_blocks)) * self.block_size
        )
        # Producers push under the staging condition, ships pop under it,
        # and backpressure waits on it.
        self._staging = threading.Condition()
        self.dispatch_lock = threading.RLock()
        self._stats = IngestStats()
        # Ingest-source attribution (see the module docstring): off, no
        # bookkeeping and sources_of reports -1.
        self._track_sources = bool(track_sources)
        self._source_map = (np.full(self.capacity, -1, np.int32)
                            if self._track_sources else None)
        self._src_fifo: deque = deque()   # mutable [source, rows] run-lengths
        self._shipper_restarts = 0
        self._max_shipper_restarts = 3
        self._fault = fault   # a faults.FaultSite ticked once a ship
        # The pod (module docstring): rows leave a node only by sync_ship.
        self._procs = pod.process_count if pod is not None else 1
        self._proc_idx = pod.process_index if pod is not None else 0
        self._pod_lead = pod.node_lead if pod is not None else True
        self._pod_fault = pod_fault   # ticked once a beat (arm_pod_fault)
        self._beat = 0
        if self._procs > 1:
            async_ship = False
            if self.capacity < self._procs * self.block_size:
                raise ValueError(f"capacity {self.capacity} holds less than one beat's "
                                 f"{self._procs} x {self.block_size} rows")

        self._sched = scheduler
        self._adaptive = (
            AdaptiveCoalesce(hi=self._max_coalesce, block_size=self.block_size)
            if adaptive_coalesce and self._max_coalesce > 1 else None
        )
        self._pool = HostBufferPool(self.width, pin=on_card) if host_pool else None
        self._ingest_inflight = False
        self._ingest_ticket = None
        self._ingest_exc: Optional[BaseException] = None
        self._async = bool(async_ship)
        self._sched_ingest = self._async and self._sched is not None
        self._shipper = (
            _IngestShipper(self).start() if self._async and not self._sched_ingest else None
        )
        self._bg_sync = bool(background_sync) and scheduler is not None and self._procs > 1

    def __len__(self) -> int:
        return self.size

    @property
    def pending_rows(self) -> int:
        """Rows staged on the host and not yet shipped."""
        with self._staging:
            return len(self._ring)

    def ingest_snapshot(self) -> dict:
        """The interval's ingest_* fields (metrics.IngestStats) and the
        shipper's cumulative restart count."""
        out = self._stats.snapshot(pending_rows=self.pending_rows)
        out["ingest_shipper_restarts"] = self._shipper_restarts
        return out

    def shard_snapshot(self, fills=None) -> dict:
        """The interval's replay_* fields (metrics.ReplayShardStats): the
        landed bytes and their tails, this rank's storage bytes (its
        tensor's), and the fill of the emptiest and the fullest shard from
        `fills`, every rank's local_fill (train.py gathers them); without
        it this rank's own fill stands for both."""
        fills = [self.local_fill] if fills is None else [int(f) for f in fills]
        return self._shard_stats.snapshot(
            n_shards=self.n_shards,
            device_storage_bytes=self.storage.numel() * self.storage.element_size(),
            fill_min=min(fills), fill_max=max(fills))

    def transfer_snapshot(self) -> dict:
        """The replay's transfer_* fields: the adaptive cap's trajectory
        and the host pool's gauges (the scheduler's own counters are its
        snapshot; train.py merges both)."""
        out = {}
        if self._adaptive is not None:
            out.update(self._adaptive.snapshot())
        if self._pool is not None:
            out.update(self._pool.snapshot())
        return out

    def arm_pod_fault(self, site) -> None:
        """Attach the pod fault site (faults.FaultPlan.pod_site), ticked once
        a beat. Armed at the warmup's end, a point every node reaches at
        the same beat, so `@K` counts steady-state beats (the warmup's
        number of beats depends on how fast the actors start)."""
        self._pod_fault = site

    def close(self) -> None:
        """Stop the background shipper, if any, and detach from the
        scheduler; later add_packed calls ship inline, so teardown
        stragglers still land."""
        if self._shipper is not None:
            self._shipper.stop()
            self._shipper = None
            self._async = False
        if self._sched_ingest:
            self._sched_ingest = False
            self._async = False

    # --- host -> device ---

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    def _check_shipper(self) -> None:
        """Surface, or recover from, a dead shipper. Staged rows stay in
        the ring until a ship pops them, so a crash loses at most the one
        super-block in flight, and a bounded number of restarts is safe;
        past the budget the failure is structural and raises."""
        s = self._shipper
        if s is not None and s.exc is not None:
            if self._shipper_restarts < self._max_shipper_restarts:
                self._shipper_restarts += 1
                exc, s.exc = s.exc, None
                trace.instant("shipper_restart", n=self._shipper_restarts)
                print(f"[ingest] shipper thread died ({exc!r}); restarting "
                      f"({self._shipper_restarts}/{self._max_shipper_restarts})",
                      file=sys.stderr, flush=True)
                self._shipper = _IngestShipper(self).start()
                return
            raise IngestError("ingest shipper thread died") from s.exc
        # The scheduler's equivalent: a failed ingest item (its own
        # exception, or the scheduler's death failing its ticket) takes
        # the same budget, resubmitted until it is spent.
        t = self._ingest_ticket
        if t is not None and t.done() and t.exception is not None:
            with self._staging:
                self._ingest_inflight = False
            self._ingest_exc = self._ingest_exc or t.exception
            self._ingest_ticket = None
        exc = self._ingest_exc
        if exc is not None:
            self._ingest_exc = None
            if self._shipper_restarts < self._max_shipper_restarts:
                self._shipper_restarts += 1
                trace.instant("shipper_restart", n=self._shipper_restarts)
                print(f"[ingest] transfer ingest work died ({exc!r}); resubmitting "
                      f"({self._shipper_restarts}/{self._max_shipper_restarts})",
                      file=sys.stderr, flush=True)
                if self._sched_ingest:
                    with self._staging:
                        self._submit_ingest_locked()
                return
            raise IngestError("ingest shipper thread died") from exc

    # --- ingest-source attribution ---

    def _pop_sources_locked(self, n: int) -> Optional[np.ndarray]:
        """Take n rows' worth of source tags off the FIFO (the caller holds
        _staging and pops n rows off the ring with it); rows without a tag
        report -1."""
        if not self._track_sources:
            return None
        out = np.full(n, -1, np.int32)
        i = 0
        while i < n and self._src_fifo:
            entry = self._src_fifo[0]
            take = min(entry[1], n - i)
            out[i:i + take] = entry[0]
            entry[1] -= take
            if entry[1] == 0:
                self._src_fifo.popleft()
            i += take
        return out

    def _note_shipped(self, srcs: Optional[np.ndarray], start: int,
                      offsets: Optional[np.ndarray] = None, advance: int = 0) -> None:
        """Stamp the positions a ship that landed wrote, from `start` (the
        ptr it wrote at), with their rows' tags. A beat's ship (`offsets`,
        `advance`) stamps this node's rows at start + offsets and marks the
        rest of the `advance` rows it landed untracked (-1): the other
        nodes' rows, whose actors this node cannot quarantine."""
        if srcs is None:
            return
        if offsets is None:
            self._source_map[(start + np.arange(len(srcs))) % self.capacity] = srcs
            return
        self._source_map[(start + np.arange(advance)) % self.capacity] = -1
        self._source_map[(start + offsets) % self.capacity] = srcs

    def sources_of(self, idx) -> np.ndarray:
        """The actor slots that produced the rows at replay positions `idx`
        (-1 = untracked: tracking off, restored rows, untagged rows). The
        map is stamped after each ship without a reader lock: attribution
        feeds a repeat-offender threshold, not an exact count."""
        idx = np.asarray(idx, np.int64)
        if self._source_map is None:
            return np.full(idx.shape, -1, np.int32)
        return self._source_map[idx % self.capacity]

    def _coalesce_k(self, n_blocks: int, cap_blocks: int, cap: Optional[int] = None) -> int:
        """Blocks to fold into the next ship: the largest power of two <=
        min(staged, the coalesce cap, the capacity in blocks). Capped by
        the capacity, so every position within one insert is distinct."""
        k = min(n_blocks, cap or self._max_coalesce, max(1, cap_blocks))
        if k <= 0:
            return 0
        return 1 << (k.bit_length() - 1)

    def _effective_coalesce(self) -> int:
        return self._adaptive.cap() if self._adaptive is not None else self._max_coalesce

    def _fence(self):
        """A CUDA event recorded on the learner's stream after the last
        insert (None on the CPU, where the copy has already run)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _drain_step(self) -> int:
        """Ship ONE coalesced super-block if a full block is staged;
        returns rows shipped. Pop and ship happen under the dispatch lock,
        so the device order is the ring's FIFO order whichever thread
        ships (inline, the shipper, the scheduler)."""
        cap_blocks = self.capacity // self.block_size
        with self.dispatch_lock:
            with self._staging:
                k = self._coalesce_k(len(self._ring) // self.block_size, cap_blocks,
                                     cap=self._effective_coalesce())
            if k == 0:
                return 0
            n = k * self.block_size
            # Acquire outside the staging condition (it may wait on a
            # fence), pop into it under the condition. The ring can only
            # grow in between (every popper holds dispatch_lock).
            buf = self._pool.acquire(n) if self._pool is not None else None
            with self._staging:
                rows = self._ring.pop_into(n, buf) if buf is not None else self._ring.pop(n)
                srcs = self._pop_sources_locked(n)
                self._staging.notify_all()
            start = self.ptr
            t0 = time.perf_counter()
            try:
                with trace.span("ingest_ship", rows=n, blocks=k):
                    self._ship(rows)
            except BaseException:
                if buf is not None:
                    # Not consumed: back unfenced, so a resubmit does not
                    # find the pool drained.
                    self._pool.commit(buf, None)
                raise
            dt = time.perf_counter() - t0
            self._stats.record_ship(n, k, dt)
            # Stamped only once the ship landed, as ptr moves.
            self._note_shipped(srcs, start)
            if buf is not None:
                self._pool.commit(buf, self._fence())
            if self._adaptive is not None:
                with self._staging:
                    queue_rows = len(self._ring)
                self._adaptive.observe_ship(k, dt, queue_rows)
        return n

    def _drain_ring(self) -> int:
        """Ship every full block staged now, coalesced. Returns rows shipped."""
        shipped = 0
        while True:
            n = self._drain_step()
            if n == 0:
                return shipped
            shipped += n

    def _submit_ingest_locked(self) -> None:
        """Queue one ingest item on the scheduler if a full block is staged
        and none is in flight. The caller holds _staging."""
        if (not self._sched_ingest or self._ingest_inflight
                or len(self._ring) < self.block_size):
            return
        self._ingest_inflight = True
        try:
            self._ingest_ticket = self._sched.submit(
                "ingest", self._scheduled_drain_step, label="ingest_ship")
        except Exception as e:
            # A dead or closed scheduler surfaces through _check_shipper,
            # not as a TransferError from whoever staged rows.
            self._ingest_inflight = False
            self._ingest_exc = self._ingest_exc or e

    def _scheduled_drain_step(self) -> int:
        """One scheduler-dispatched ship, re-armed while full blocks remain
        (one item in flight, so the fair queue can interleave other
        classes between super-blocks). Returns bytes moved."""
        try:
            shipped = self._drain_step()
        except Exception as e:
            with self._staging:
                self._ingest_inflight = False
                self._ingest_exc = e
                self._staging.notify_all()
            return 0
        with self._staging:
            self._ingest_inflight = False
            self._submit_ingest_locked()
        return shipped * self.width * 4

    def add_packed(self, block: np.ndarray, source: int = -1) -> None:
        """Stage packed [M, D] rows; ship the full blocks (inline, or on the
        shipper with async_ship, where a full staging ring blocks here:
        backpressure, counted in ingest_stall_ms). `source` tags the rows'
        ingest source (the actor slot) when track_sources is on; -1 =
        untracked."""
        self._check_shipper()
        rows = np.asarray(block, np.float32)
        stall = 0.0
        with self._staging:
            if self._async:
                t0 = time.perf_counter()
                while (len(self._ring) + len(rows) > self._ring.capacity
                       and len(self._ring) >= self.block_size):
                    self._staging.wait(0.05)
                    self._check_shipper()
                    if not self._async:
                        break   # close() raced us: push (the ring grows), ship inline
                stall = time.perf_counter() - t0
                if stall > 0.001:
                    # The producer's wait on a full ring, as a span.
                    trace.complete("ingest_backpressure", t0, stall, rows=len(rows))
            self._ring.push(rows)
            if self._track_sources and len(rows):
                self._src_fifo.append([int(source), len(rows)])
            self._stats.record_push(len(rows), stall)
            self._staging.notify_all()
            self._submit_ingest_locked()
        if self._async or self._procs > 1:
            return   # the shipper ships, or on a pod the beat
        self._drain_ring()

    def drain_pending(self) -> int:
        """Ship every staged full block and wait until the inserts have run
        on the device: the barrier before reading storage."""
        self._check_shipper()
        moved = self._drain_ring()
        with self.dispatch_lock:
            if self._stream is not None:
                self._stream.synchronize()
        return moved

    def flush(self, min_rows: int = 1) -> None:
        """Force pending rows out, padded by repetition to the block shape
        (warmup and shutdown only, as in the JAX package)."""
        self._check_shipper()
        self._drain_ring()
        with self.dispatch_lock:
            with self._staging:
                n = len(self._ring)
                rows = self._ring.pop(n) if (n >= min_rows and n > 0) else None
                srcs = self._pop_sources_locked(n) if rows is not None else None
                if rows is not None:
                    self._staging.notify_all()
            if rows is not None:
                reps = -(-self.block_size // n)
                m = min(self.block_size, self.capacity)
                start = self.ptr
                t0 = time.perf_counter()
                with trace.span("ingest_flush", rows=n):
                    self._ship(np.tile(rows, (reps, 1))[:m])
                self._stats.record_ship(n, 1, time.perf_counter() - t0)
                if srcs is not None:
                    # The padding repeats real rows: the copies inherit the
                    # originals' tags.
                    self._note_shipped(np.tile(srcs, reps)[:m], start)

    # --- the pod's beat (module docstring) ---

    def sync_ship(self, force: bool = False) -> int:
        """One lockstep ingest beat (JAX sync_ship): every rank of the pod
        calls it at the same point of its loop. Returns this rank's real
        (unpadded) rows shipped. Under background_sync it goes through the
        scheduler's lane and waits there (multihost.wait_beat_ticket), so
        its collective keeps its place among the queued beats. On one
        process there is no beat: it degrades to the add_packed/flush fast
        path (JAX :897-903), every full block shipped and, with `force`,
        the remainder flushed padded, and returns the rows moved."""
        if self._procs == 1:
            self._check_shipper()
            moved = self._drain_ring()
            if force and self.pending_rows:
                moved += self.pending_rows
                self.flush()
            return moved
        if self._bg_sync:
            from distributed_ddpg_tpu_torch.parallel import multihost

            return multihost.wait_beat_ticket(self.sync_ship_begin(force=force))
        return self._sync_ship_collective(force)

    def sync_ship_begin(self, force: bool = False):
        """Issue one beat on the scheduler's lockstep lane and return its
        TransferTicket without waiting (background_sync). Every rank issues
        its beats at the same points in the same order, and waits the
        ticket before its next collective; the beat reads its staged count
        when it runs, after every earlier beat (FIFO), so no row is claimed
        twice."""
        if not self._bg_sync:
            raise ReplayUsageError("sync_ship_begin() needs background_sync=True, an "
                                   "attached TransferScheduler, and a multi-process mesh")
        self._beat += 1
        # A sharded ring's beats ride the shard_exchange class: the same
        # ordered lane and deadline, their own transfer_shard_exchange_*
        # counters (JAX :943-948).
        return self._sched.submit("shard_exchange" if self.sharded else "lockstep",
                                  lambda: self._sync_ship_collective(force),
                                  label=f"sync_ship_beat_{self._beat}")

    def _sync_ship_collective(self, force: bool) -> int:
        """The beat itself (see sync_ship and the module docstring)."""
        from distributed_ddpg_tpu_torch.parallel import multihost

        # The count now: rows staged later belong to a later beat.
        count = self.pending_rows if self._pod_lead else 0
        # The pod fault fires before the collective, so a kill or a hang
        # leaves the peers blocked in this beat's gather: the failure the
        # pod deadline is there to see.
        if self._pod_fault is not None:
            self._pod_fault.tick()
        bs, procs, p = self.block_size, self._procs, self._proc_idx
        with trace.span("sync_ship", beat=self._beat):
            counts = multihost.beat_allgather(count)
            m = int(counts.min())
            moved = 0
            cap_blocks = self.capacity // (procs * bs)
            remaining = m // bs
            with self.dispatch_lock:
                while remaining:
                    k = self._coalesce_k(remaining, cap_blocks)
                    rows, srcs = self._pop_local(k * bs)
                    t0 = time.perf_counter()
                    with trace.span("ingest_ship_global", rows=k * bs, blocks=k):
                        start = self._ship_global(rows, k)
                    self._stats.record_ship(k * bs, k, time.perf_counter() - t0)
                    # This node's k blocks land at j*(procs*bs) + p*bs + r.
                    offsets = (np.arange(k)[:, None] * (procs * bs) + p * bs
                               + np.arange(bs)[None, :]).reshape(-1)
                    self._note_shipped(srcs, start, offsets, procs * k * bs)
                    moved += k * bs
                    remaining -= k
                if force and m % bs:
                    # The remainder as counted (rows staged since belong to a
                    # later beat), padded by repetition to one block.
                    take = min(count - moved, bs) if self._pod_lead else 0
                    rows, srcs = self._pop_local(take)
                    reps = -(-bs // max(take, 1))
                    block = (np.tile(rows, (reps, 1))[:bs] if take
                             else np.zeros((bs, self.width), np.float32))
                    t0 = time.perf_counter()
                    start = self._ship_global(block, 1)
                    self._stats.record_ship(take, 1, time.perf_counter() - t0)
                    if srcs is not None and take:
                        self._note_shipped(np.tile(srcs, reps)[:bs], start,
                                           p * bs + np.arange(bs), procs * bs)
                    moved += take
        return moved

    def _pop_local(self, n: int):
        """n staged rows and their tags off this node's ring (a rank that is
        not its node's lead stages nothing and sends zeros)."""
        if not self._pod_lead or n == 0:
            return np.zeros((n, self.width), np.float32), None
        with self._staging:
            rows = self._ring.pop(n)
            srcs = self._pop_sources_locked(n)
            self._staging.notify_all()
        return rows, srcs

    def _ship_global(self, local_rows: np.ndarray, k: int = 1) -> int:
        """Gather every node's k blocks (multihost.allgather_rows) and land
        them at ptr in the JAX package's interleave: node p's block j, row
        r at ptr + j*(procs*bs) + p*bs + r (a sharded ring lands only the
        rows this rank owns, _ship). Returns the ptr it wrote at. The
        caller holds dispatch_lock."""
        from distributed_ddpg_tpu_torch.parallel import multihost

        bs, procs = self.block_size, self._procs
        gathered = multihost.allgather_rows(local_rows)        # [procs, k*bs, W]
        block = np.ascontiguousarray(
            gathered.reshape(procs, k, bs, self.width).transpose(1, 0, 2, 3)
            .reshape(k * procs * bs, self.width))
        start = self.ptr
        self._ship(block)
        return start

    def _ship(self, rows: np.ndarray) -> None:
        """Write rows at ptr, ptr+1, ... mod capacity (len(rows) <=
        capacity): one H2D copy into the ring's slice, two when it wraps,
        on the learner's stream; non-blocking from pinned memory. A
        sharded ring copies only this rank's rows, rows[shard::D], into its
        local slots from ptr // D. The caller holds dispatch_lock."""
        if self._fault is not None:
            self._fault.tick()
        t0 = time.perf_counter()
        m = len(rows)
        n = self.n_shards
        if m % n:
            raise ReplayUsageError(
                f"an insert of {m} rows does not divide over {n} shards (every "
                "insert moves a multiple of the shard count; flush pads to a block)")
        mine = rows if n == 1 else np.ascontiguousarray(rows[self.shard::n])
        src = torch.from_numpy(mine)
        pinned = self._stream is not None and src.is_pinned()
        lm, lptr, sc = len(mine), self.ptr // n, self.shard_capacity
        first = min(lm, sc - lptr)
        with self._on_stream():
            self.storage[lptr:lptr + first].copy_(src[:first], non_blocking=pinned)
            if lm > first:
                self.storage[:lm - first].copy_(src[first:], non_blocking=pinned)
        self.ptr = (self.ptr + m) % self.capacity
        self.size = min(self.size + m, self.capacity)
        self.local_fill = min(self.local_fill + lm, sc)
        self._shard_stats.record_ship(m, src.numel() * src.element_size(),
                                      time.perf_counter() - t0)

    # --- device rows (the device actors, the fused beat) ---

    def _device_positions(self, m: int) -> torch.Tensor:
        """This rank's local slots of an m-row insert at ptr on the
        storage's device: (ptr + arange(m)) mod capacity, or sharded
        (ptr // D + arange(m // D)) mod capacity / D."""
        n = self.n_shards
        return torch.remainder(
            torch.arange(m // n, dtype=torch.int64, device=self.device) + self.ptr // n,
            self.shard_capacity)

    def insert_device_rows(self, rows: torch.Tensor) -> int:
        """Land an [M, D] block already on the device (JAX
        insert_device_rows): one scatter at (ptr + arange(M)) mod capacity,
        the PER stamp, then note_device_rows, all under dispatch_lock and
        on the learner's stream; no host read. M <= capacity (the config
        checks a rollout's rows against it), so no position is written
        twice. Returns M."""
        m = int(rows.shape[0])
        if m == 0:
            return 0
        if m > self.capacity:
            raise ValueError(f"insert_device_rows: {m} rows exceed the capacity "
                             f"{self.capacity}; positions would be written twice")
        n = self.n_shards
        if m % n:
            # JAX :806-812.
            raise ValueError(
                f"insert_device_rows: {m} rows do not divide over {n} shards — "
                "sharded mode requires every insert to move a multiple of the shard "
                "count (keeps ptr N-aligned; config.py validates the device-actor "
                "chunk shape when data_axis is explicit)")
        with self.dispatch_lock:
            with self._on_stream():
                idx = self._device_positions(m)
                self.storage.index_copy_(0, idx, rows if n == 1 else rows[self.shard::n])
                self._stamp_device_rows(idx)
            self.note_device_rows(m)
        return m

    def _stamp_device_rows(self, idx: torch.Tensor) -> None:
        """The PER subclass stamps the landed positions; uniform: nothing."""

    def note_device_rows(self, m: int) -> None:
        """Advance the host ptr/size past m device rows landed at ptr, and
        stamp their positions untracked (-1) in the source map (JAX
        note_device_rows). The caller holds dispatch_lock."""
        if self._source_map is not None:
            self._source_map[(self.ptr + np.arange(m)) % self.capacity] = -1
        self.ptr = (self.ptr + m) % self.capacity
        self.size = min(self.size + m, self.capacity)
        self.local_fill = min(self.local_fill + m // self.n_shards, self.shard_capacity)

    def reward_sample(self, max_n: int = 100_000):
        """(reward, discount) columns of up to max_n filled rows, pulled to
        the host, then (one node) the staged rows not yet shipped (up to
        max_n more):
        what the C51 auto support is sized from (ops/support_auto.py;
        discount == 0 marks the terminal rows). A ring fuller than max_n is
        read at an even stride over its live rows, not as a stale prefix.
        A ring sharded over D > 1 ranks reads the same logical rows with an
        owner-masked gather summed over the group (a collective: every
        rank calls it), so every placement samples the same rows."""
        col = self.obs_dim + self.act_dim
        with self.dispatch_lock:
            n = min(self.size, int(max_n))
            if self.n_shards > 1:
                cols = self._gather_logical(
                    np.arange(n) if n == self.size
                    else np.linspace(0, self.size - 1, n).astype(np.int64), col, 2)
            elif n == self.size:
                cols = self.storage[:n, col:col + 2]
            else:
                idx = torch.from_numpy(np.linspace(0, self.size - 1, n).astype(np.int64))
                cols = self.storage[idx.to(self.device), col:col + 2]
            cols = cols.cpu().numpy()
            # Still under the lock: no ship moves rows between the two reads.
            # On a pod only the shipped rows: every rank must size the same
            # support from the same (replicated) rows.
            with self._staging:
                pend = (self._ring.peek_cols(col, 2, int(max_n)) if self._procs == 1
                        else cols[:0])
        if len(pend):
            cols = np.concatenate([cols, pend])
        return cols[:, 0], cols[:, 1]

    def _gather_logical(self, idx: np.ndarray, col: int, ncols: int) -> torch.Tensor:
        """Columns [col, col + ncols) of the logical rows `idx` of a ring
        sharded over D > 1 ranks, on every rank: each rank writes the rows
        it owns into a buffer of -0.0, and a sum over the group fills it
        (mesh.all_gather's exactness). A collective."""
        from distributed_ddpg_tpu_torch.parallel import mesh

        n = self.n_shards
        idx = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        out = torch.full((len(idx), ncols), -0.0, dtype=torch.float32, device=self.device)
        mine = idx % n == self.shard
        out[mine] = self.storage[idx[mine] // n, col:col + ncols]
        mesh.all_reduce_sum_([out], self._group)
        return out

    def device_state(self):
        """(storage on the device, size) for the sampler: [capacity, D], or
        sharded this rank's [capacity / D, D] slots; the caller holds
        dispatch_lock from here to its gather."""
        return self.storage, self.size

    def _multi_writer(self) -> bool:
        """Sharded over more than one rank: no rank holds the whole ring."""
        return self.sharded and self.n_shards > 1

    def _local_count(self, size: int) -> int:
        """The live local slots of this rank at ring size `size`: the
        logical positions shard, shard + D, ... below it."""
        n, s = self.n_shards, self.shard
        return (size - s + n - 1) // n if size > s else 0

    def state_dict(self):
        """The ring in logical order (the checkpoint's format, the JAX
        package's). Raises ReplayUsageError on a ring sharded over D > 1
        ranks: no rank can write it alone (slice_state_dict)."""
        with self.dispatch_lock:
            if self._multi_writer():
                raise ReplayUsageError(
                    "sharded replay contents span processes and have no "
                    "single-writer snapshot; each process checkpoints its "
                    "own slice instead (slice_state_dict + "
                    "checkpoint.write_replay_slice)")
            return {
                "packed": self.storage[: self.size].cpu().numpy().copy(),
                "ptr": np.asarray(self.ptr),
                "size": np.asarray(self.size),
            }

    def slice_state_dict(self):
        """This rank's slice of the logical ring, the all-writer
        checkpoint's payload (JAX slice_state_dict; checkpoint.
        write_replay_slice): `positions`, the logical indices in [0, size)
        this rank owns, ascending; `rows`, the packed rows there; the ring
        scalars and the capacity; under PER the priorities and the max
        priority. One rank (replicated, or sharded alone) is one slice over
        the whole ring."""
        with self.dispatch_lock:
            if not self._multi_writer():
                st = self.state_dict()
                n = int(st["size"])
                out = {"positions": np.arange(n, dtype=np.int64),
                       "rows": np.asarray(st["packed"], np.float32)}
                extra = {k: st[k] for k in ("priorities", "max_priority") if k in st}
            else:
                n = self.size
                cnt = self._local_count(n)
                out = {"positions": self.shard + np.arange(cnt, dtype=np.int64) * self.n_shards,
                       "rows": self.storage[:cnt].cpu().numpy().copy()}
                extra = self._slice_extra(cnt)
            out.update(ptr=np.asarray(self.ptr, np.int64), size=np.asarray(n, np.int64),
                       capacity=np.asarray(self.capacity, np.int64))
            for k, v in extra.items():
                out[k] = np.asarray(v, np.float32)
            return out

    def _slice_extra(self, cnt: int) -> dict:
        """The PER subclass adds this rank's priorities; uniform: none."""
        return {}

    def load_state_dict(self, state) -> None:
        """Restore a logical-order state_dict (a checkpoint's, or
        merge_slice_states' of a slice set written by any number of
        ranks). Sharded over D > 1 ranks, every rank is given the same
        whole state and keeps its own positions (the N -> M reshard, JAX
        _load_state_multihost)."""
        n = int(state["size"])
        if n > self.capacity:
            raise ValueError(f"checkpointed size {n} exceeds capacity {self.capacity}")
        with self.dispatch_lock:
            packed = np.asarray(state["packed"], np.float32)
            if self._multi_writer():
                packed = packed[self.shard::self.n_shards]
                self.storage.zero_()
            self.storage[:len(packed)] = torch.as_tensor(
                np.ascontiguousarray(packed), device=self.device)
            self.ptr = int(state["ptr"]) % self.capacity
            self.size = n
            self.local_fill = len(packed)
            if self._track_sources:
                # Restored rows carry no tag. The FIFO stays: it pairs with
                # the staged rows, which a restore leaves in the ring.
                self._source_map.fill(-1)


class DevicePrioritizedReplay(DeviceReplay):
    """Proportional PER with the priorities in device memory (counterpart
    of the JAX package's DevicePrioritizedReplay). Sharded, the priority
    vector is this rank's [capacity / D] slots, the storage's placement: the
    stamp writes the local run an insert lands, the learner draws with
    draw_sharded_per_indices and writes back with owner_scatter_last_wins.

    - `priorities`: f32 [capacity], zero for empty slots, so a draw never
      reaches them; `max_priority`: a 0-d f32 device tensor, initially 1.
    - Every insert of m rows stamps positions (old ptr + arange(m)) mod
      capacity with max_priority, a padded flush included (JAX stamps the
      shipped rows, padding and all).
    - The learner draws (draw_per_indices) and writes (|td| + eps)^alpha of
      the chunk's rows back with scatter_last_wins, then raises
      max_priority to the chunk's largest, in place on the device
      (parallel/learner.py run_sample_chunk_per). The stamp and the
      chunk's write are issued under dispatch_lock, from whichever
      thread, and run on the learner's stream in that order, so an insert
      made while a chunk runs stamps that chunk's new max priority, as
      the JAX package's dispatch lock ensures.
    """

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device="cuda",
                 block_size: int = 4096, staging_blocks: int = 16,
                 alpha: float = 0.6, eps: float = 1e-6, **pipeline):
        device = require_device(device)
        # The priorities exist before the base class can start a shipper.
        _, n, _ = _placement(int(capacity), int(block_size),
                             pipeline.get("replay_sharding", "replicated"),
                             pipeline.get("group"))
        self.priorities = torch.zeros(int(capacity) // n, dtype=torch.float32, device=device)
        self.max_priority = torch.ones((), dtype=torch.float32, device=device)
        self.alpha = float(alpha)
        self.eps = float(eps)
        super().__init__(capacity, obs_dim, act_dim, device, block_size, staging_blocks,
                         **pipeline)

    def _ship(self, rows: np.ndarray) -> None:
        """The insert, then its stamp: positions (old ptr + arange(m)) mod
        capacity take the max priority, on the same stream, so a coalesced
        ship stamps exactly what k serial ships would."""
        n = self.n_shards
        old_lptr, lm = self.ptr // n, len(rows) // n
        super()._ship(rows)
        first = min(lm, self.shard_capacity - old_lptr)
        with self._on_stream():
            self.priorities[old_lptr:old_lptr + first].fill_(self.max_priority)
            if lm > first:
                self.priorities[:lm - first].fill_(self.max_priority)

    def _stamp_device_rows(self, idx: torch.Tensor) -> None:
        """Device rows take the max priority, as every insert's rows do (JAX
        pure_stamp_fn from the pre-insert pointer); no host read."""
        self.priorities.index_put_((idx,), self.max_priority.expand(idx.shape[0]))

    def per_state(self):
        """(storage, size, priorities, max_priority) for the learner's draw."""
        return self.storage, self.size, self.priorities, self.max_priority

    def set_per_state(self, priorities: torch.Tensor, max_priority: torch.Tensor) -> None:
        """Install a priority vector and max priority (the learner updates
        the installed ones in place)."""
        with self.dispatch_lock:
            self.priorities = priorities
            self.max_priority = max_priority

    def state_dict(self):
        with self.dispatch_lock:
            state = super().state_dict()
            state["priorities"] = self.priorities[: self.size].cpu().numpy().copy()
            state["max_priority"] = np.asarray(float(self.max_priority))
            return state

    def _slice_extra(self, cnt: int) -> dict:
        return {"priorities": self.priorities[:cnt].cpu().numpy().copy(),
                "max_priority": float(self.max_priority)}

    def load_state_dict(self, state) -> None:
        """The rows, ptr and size, then the priorities (zero past size) and
        the max priority, written into the tensors this replay already
        holds: whatever read them before (per_state) reads the restored
        values, in stream order."""
        with self.dispatch_lock:
            super().load_state_dict(state)
            if "priorities" not in state:
                return
            prios = np.asarray(state["priorities"], np.float32)
            if self._multi_writer():
                prios = prios[self.shard::self.n_shards]
            self.priorities.zero_()
            self.priorities[:len(prios)] = torch.as_tensor(
                np.ascontiguousarray(prios), device=self.device)
            self.max_priority.fill_(float(state["max_priority"]))


# ---------------------------------------------------------------------------
# program-contract analyzer hook (analysis/programs.py)
# ---------------------------------------------------------------------------


def program_specs():
    """The ring's insert, stamp and reshard programs over tiny rings
    (capacity 64, blocks of 8), replicated on one rank and sharded on the
    2-rank probe group: the host block's insert (`_ship`), the device rows'
    insert, the PER stamp of a device insert's positions, and the elastic
    restore's reshard (load_state_dict of a logical ring onto a sharded
    one). The pod's global inserts (the all-gathering beats) need a real
    multi-process pod and are drilled by the pod tests instead."""
    from distributed_ddpg_tpu_torch.analysis.programs import (
        BuiltProgram,
        ProgramSpec,
        probe_group,
        probe_rows,
        replay_leaves,
    )

    OWNER = "replay/device.py"
    M = 8  # rows per probe ship (one block)

    def replay(device: str, sharded: bool = False, per: bool = False) -> DeviceReplay:
        kw = (dict(replay_sharding="sharded", group=probe_group(device))
              if sharded else {})
        cls = DevicePrioritizedReplay if per else DeviceReplay
        return cls(64, 3, 1, device, block_size=M, **kw)

    def built(r: DeviceReplay, fn) -> BuiltProgram:
        def locked():
            with r.dispatch_lock:
                return fn()
        return BuiltProgram(locked, lambda: replay_leaves(r))

    def insert(sharded: bool):
        def build(device: str) -> BuiltProgram:
            r = replay(device, sharded)
            block = probe_rows(M, r.width)
            return built(r, lambda: r._ship(block))
        return build

    def insert_devrows_sharded(device: str) -> BuiltProgram:
        r = replay(device, sharded=True)
        rows = torch.from_numpy(probe_rows(M, r.width)).to(device)
        return built(r, lambda: r.insert_device_rows(rows))

    def stamp(sharded: bool):
        def build(device: str) -> BuiltProgram:
            r = replay(device, sharded, per=True)
            return built(r, lambda: r._stamp_device_rows(r._device_positions(M)))
        return build

    def reshard(per: bool):
        def build(device: str) -> BuiltProgram:
            r = replay(device, sharded=True, per=per)
            state = {"packed": probe_rows(64, r.width), "ptr": np.asarray(0),
                     "size": np.asarray(64)}
            if per:
                state["priorities"] = np.linspace(0.5, 1.5, 64, dtype=np.float32)
                state["max_priority"] = np.asarray(1.5, np.float32)
            return built(r, lambda: r.load_state_dict(state))
        return build

    return [
        ProgramSpec("replay.insert", OWNER, insert(False)),
        ProgramSpec("replay.insert.sharded", OWNER, insert(True)),
        ProgramSpec("replay.insert.devrows.sharded", OWNER, insert_devrows_sharded),
        ProgramSpec("replay.stamp", OWNER, stamp(False)),
        ProgramSpec("replay.stamp.sharded", OWNER, stamp(True)),
        ProgramSpec("replay.reshard.sharded", OWNER, reshard(False)),
        ProgramSpec("replay.per.reshard.sharded", OWNER, reshard(True)),
    ]
