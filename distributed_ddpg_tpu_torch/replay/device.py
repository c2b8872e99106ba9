"""Device-resident replay: the packed ring lives in device memory.

Counterpart of distributed_ddpg_tpu/replay/device.py (DeviceReplay and
DevicePrioritizedReplay, one process, replicated storage). The packed
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
  inserts ship inline;
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
knows them without reading the device. The JAX package's multi-host
sync_ship and sharded placement are later work.

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
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.devices import require_device
from distributed_ddpg_tpu_torch.metrics import IngestStats
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
                 track_sources: bool = False):
        self.capacity = int(capacity)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.block_size = int(block_size)
        self.width = packed_width(obs_dim, act_dim)
        self.device = require_device(device)
        self.storage = torch.zeros(
            (self.capacity, self.width), dtype=torch.float32, device=self.device
        )
        self.ptr = 0
        self.size = 0
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

    def _note_shipped(self, srcs: Optional[np.ndarray], start: int) -> None:
        """Stamp the positions a ship that landed wrote, from `start` (the
        ptr it wrote at), with their rows' tags."""
        if srcs is not None:
            self._source_map[(start + np.arange(len(srcs))) % self.capacity] = srcs

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
            self._ring.push(rows)
            if self._track_sources and len(rows):
                self._src_fifo.append([int(source), len(rows)])
            self._stats.record_push(len(rows), stall)
            self._staging.notify_all()
            self._submit_ingest_locked()
        if self._async:
            return
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
                self._ship(np.tile(rows, (reps, 1))[:m])
                self._stats.record_ship(n, 1, time.perf_counter() - t0)
                if srcs is not None:
                    # The padding repeats real rows: the copies inherit the
                    # originals' tags.
                    self._note_shipped(np.tile(srcs, reps)[:m], start)

    def _ship(self, rows: np.ndarray) -> None:
        """Write rows at ptr, ptr+1, ... mod capacity (len(rows) <=
        capacity): one H2D copy into the ring's slice, two when it wraps,
        on the learner's stream; non-blocking from pinned memory. The
        caller holds dispatch_lock."""
        m = len(rows)
        src = torch.from_numpy(rows)
        pinned = self._stream is not None and src.is_pinned()
        first = min(m, self.capacity - self.ptr)
        with self._on_stream():
            self.storage[self.ptr:self.ptr + first].copy_(src[:first], non_blocking=pinned)
            if m > first:
                self.storage[:m - first].copy_(src[first:], non_blocking=pinned)
        self.ptr = (self.ptr + m) % self.capacity
        self.size = min(self.size + m, self.capacity)

    # --- device rows (the device actors, the fused beat) ---

    def _device_positions(self, m: int) -> torch.Tensor:
        """(ptr + arange(m)) mod capacity on the storage's device."""
        return torch.remainder(
            torch.arange(m, dtype=torch.int64, device=self.device) + self.ptr, self.capacity)

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
        with self.dispatch_lock:
            with self._on_stream():
                idx = self._device_positions(m)
                self.storage.index_copy_(0, idx, rows)
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

    def reward_sample(self, max_n: int = 100_000):
        """(reward, discount) columns of up to max_n filled rows, pulled to
        the host, then the staged rows not yet shipped (up to max_n more):
        what the C51 auto support is sized from (ops/support_auto.py;
        discount == 0 marks the terminal rows). A ring fuller than max_n is
        read at an even stride over its live rows, not as a stale prefix."""
        col = self.obs_dim + self.act_dim
        with self.dispatch_lock:
            n = min(self.size, int(max_n))
            if n == self.size:
                cols = self.storage[:n, col:col + 2]
            else:
                idx = torch.from_numpy(np.linspace(0, self.size - 1, n).astype(np.int64))
                cols = self.storage[idx.to(self.device), col:col + 2]
            cols = cols.cpu().numpy()
            # Still under the lock: no ship moves rows between the two reads.
            with self._staging:
                pend = self._ring.peek_cols(col, 2, int(max_n))
        if len(pend):
            cols = np.concatenate([cols, pend])
        return cols[:, 0], cols[:, 1]

    def device_state(self):
        """(storage [capacity, D] on the device, size) for the sampler; the
        caller holds dispatch_lock from here to its gather."""
        return self.storage, self.size

    def state_dict(self):
        with self.dispatch_lock:
            return {
                "packed": self.storage[: self.size].cpu().numpy().copy(),
                "ptr": np.asarray(self.ptr),
                "size": np.asarray(self.size),
            }

    def load_state_dict(self, state) -> None:
        n = int(state["size"])
        if n > self.capacity:
            raise ValueError(f"checkpointed size {n} exceeds capacity {self.capacity}")
        with self.dispatch_lock:
            self.storage[:n] = torch.as_tensor(
                np.asarray(state["packed"], np.float32), device=self.device
            )
            self.ptr = int(state["ptr"]) % self.capacity
            self.size = n
            if self._track_sources:
                # Restored rows carry no tag. The FIFO stays: it pairs with
                # the staged rows, which a restore leaves in the ring.
                self._source_map.fill(-1)


class DevicePrioritizedReplay(DeviceReplay):
    """Proportional PER with the priorities in device memory (counterpart
    of the JAX package's DevicePrioritizedReplay, one process, unsharded).

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
        self.priorities = torch.zeros(int(capacity), dtype=torch.float32, device=device)
        self.max_priority = torch.ones((), dtype=torch.float32, device=device)
        self.alpha = float(alpha)
        self.eps = float(eps)
        super().__init__(capacity, obs_dim, act_dim, device, block_size, staging_blocks,
                         **pipeline)

    def _ship(self, rows: np.ndarray) -> None:
        """The insert, then its stamp: positions (old ptr + arange(m)) mod
        capacity take the max priority, on the same stream, so a coalesced
        ship stamps exactly what k serial ships would."""
        old_ptr, m = self.ptr, len(rows)
        super()._ship(rows)
        first = min(m, self.capacity - old_ptr)
        with self._on_stream():
            self.priorities[old_ptr:old_ptr + first].fill_(self.max_priority)
            if m > first:
                self.priorities[:m - first].fill_(self.max_priority)

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

    def load_state_dict(self, state) -> None:
        """The rows, ptr and size, then the priorities (zero past size) and
        the max priority, written into the tensors this replay already
        holds: whatever read them before (per_state) reads the restored
        values, in stream order."""
        with self.dispatch_lock:
            super().load_state_dict(state)
            if "priorities" not in state:
                return
            n = int(state["size"])
            self.priorities.zero_()
            self.priorities[:n] = torch.as_tensor(
                np.asarray(state["priorities"], np.float32), device=self.device)
            self.max_priority.fill_(float(state["max_priority"]))
