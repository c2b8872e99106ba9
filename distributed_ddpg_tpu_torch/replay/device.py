"""Device-resident uniform replay: the packed ring lives in device memory.

Counterpart of distributed_ddpg_tpu/replay/device.py (DeviceReplay,
uniform, one process). The packed [capacity, 2*obs+act+3] f32 ring sits on
the learner's device; the learner samples it there (one gather of K*B rows
per chunk, parallel/learner.py), so a chunk needs no host->device copy.

Ingest: `add_packed` stages actor rows in a host ring (replay/staging.py)
and, synchronously, ships every full block as ONE coalesced wrap-around
insert (two slice copies when it wraps). The trainer ingests between
chunks, so inserts land at chunk boundaries. Positions, `ptr` and `size`
follow exactly the JAX package's block-at-a-time sequence: an insert never
exceeds the capacity, so no position is written twice in one copy. The
JAX package's background shipper, transfer scheduler, multi-host and
sharded modes are later work.

`ptr` and `size` are host integers: the host drives every insert, so it
knows them without reading the device.

DevicePrioritizedReplay adds proportional PER on the device, as the JAX
package's does: an f32 [capacity] priority vector and a 0-d max priority,
both device tensors; every insert stamps its rows with the max priority,
and the learner draws with `draw_per_indices` and writes the chunk's new
priorities back (parallel/learner.py run_sample_chunk_per). Neither reads
the device back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch.replay.staging import HostStagingRing
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


class DeviceReplay:
    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device="cpu",
                 block_size: int = 4096, staging_blocks: int = 16):
        self.capacity = int(capacity)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.block_size = int(block_size)
        self.width = packed_width(obs_dim, act_dim)
        self.device = torch.device(device)
        self.storage = torch.zeros(
            (self.capacity, self.width), dtype=torch.float32, device=self.device
        )
        self.ptr = 0
        self.size = 0
        self._ring = HostStagingRing(
            self.width, max(1, int(staging_blocks)) * self.block_size
        )

    def __len__(self) -> int:
        return self.size

    @property
    def pending_rows(self) -> int:
        return len(self._ring)

    def _insert(self, rows: np.ndarray) -> None:
        """Write rows at ptr, ptr+1, ... mod capacity (len(rows) <= capacity)."""
        m = len(rows)
        block = torch.from_numpy(rows).to(self.device)
        first = min(m, self.capacity - self.ptr)
        self.storage[self.ptr:self.ptr + first] = block[:first]
        if m > first:
            self.storage[:m - first] = block[first:]
        self.ptr = (self.ptr + m) % self.capacity
        self.size = min(self.size + m, self.capacity)

    def _drain_ring(self) -> int:
        """Ship every staged full block, as few inserts as the capacity
        allows. Returns rows shipped."""
        cap_blocks = max(1, self.capacity // self.block_size)
        shipped = 0
        while len(self._ring) >= self.block_size:
            k = min(len(self._ring) // self.block_size, cap_blocks)
            self._insert(self._ring.pop(k * self.block_size))
            shipped += k * self.block_size
        return shipped

    def add_packed(self, block: np.ndarray) -> None:
        """Stage packed [M, D] rows; ship whatever full blocks are staged."""
        self._ring.push(np.asarray(block, np.float32))
        self._drain_ring()

    def flush(self) -> None:
        """Force pending rows out, padded by repetition to the block shape
        (warmup and shutdown only, as in the JAX package)."""
        self._drain_ring()
        n = len(self._ring)
        if n > 0:
            rows = self._ring.pop(n)
            reps = -(-self.block_size // n)
            self._insert(np.tile(rows, (reps, 1))[: min(self.block_size, self.capacity)])

    def reward_sample(self, max_n: int = 100_000):
        """(reward, discount) columns of up to max_n filled rows, pulled to
        the host, then the staged rows not yet shipped (up to max_n more):
        what the C51 auto support is sized from (ops/support_auto.py;
        discount == 0 marks the terminal rows). A ring fuller than max_n is
        read at an even stride over its live rows, not as a stale prefix."""
        col = self.obs_dim + self.act_dim
        n = min(self.size, int(max_n))
        if n == self.size:
            cols = self.storage[:n, col:col + 2]
        else:
            idx = torch.from_numpy(np.linspace(0, self.size - 1, n).astype(np.int64))
            cols = self.storage[idx.to(self.device), col:col + 2]
        pend = self._ring.peek(min(len(self._ring), int(max_n)))[:, col:col + 2]
        cols = np.concatenate([cols.cpu().numpy(), pend])
        return cols[:, 0], cols[:, 1]

    def device_state(self):
        """(storage [capacity, D] on the device, size) for the sampler."""
        return self.storage, self.size

    def state_dict(self):
        return {
            "packed": self.storage[: self.size].cpu().numpy().copy(),
            "ptr": np.asarray(self.ptr),
            "size": np.asarray(self.size),
        }

    def load_state_dict(self, state) -> None:
        n = int(state["size"])
        if n > self.capacity:
            raise ValueError(f"checkpointed size {n} exceeds capacity {self.capacity}")
        self.storage[:n] = torch.as_tensor(
            np.asarray(state["packed"], np.float32), device=self.device
        )
        self.ptr = int(state["ptr"]) % self.capacity
        self.size = n


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
      chunk's write run on one CUDA stream in the order they were
      issued, so an insert made while a chunk runs stamps that chunk's
      new max priority, as the JAX package's dispatch lock ensures.
    """

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device="cpu",
                 block_size: int = 4096, staging_blocks: int = 16,
                 alpha: float = 0.6, eps: float = 1e-6):
        super().__init__(capacity, obs_dim, act_dim, device, block_size, staging_blocks)
        self.alpha = float(alpha)
        self.eps = float(eps)
        self.priorities = torch.zeros(self.capacity, dtype=torch.float32, device=self.device)
        self.max_priority = torch.ones((), dtype=torch.float32, device=self.device)

    def _insert(self, rows: np.ndarray) -> None:
        old_ptr, m = self.ptr, len(rows)
        super()._insert(rows)
        first = min(m, self.capacity - old_ptr)
        self.priorities[old_ptr:old_ptr + first].fill_(self.max_priority)
        if m > first:
            self.priorities[:m - first].fill_(self.max_priority)

    def per_state(self):
        """(storage, size, priorities, max_priority) for the learner's draw."""
        return self.storage, self.size, self.priorities, self.max_priority

    def set_per_state(self, priorities: torch.Tensor, max_priority: torch.Tensor) -> None:
        """Install a priority vector and max priority (the learner updates
        the installed ones in place)."""
        self.priorities = priorities
        self.max_priority = max_priority

    def state_dict(self):
        state = super().state_dict()
        state["priorities"] = self.priorities[: self.size].cpu().numpy().copy()
        state["max_priority"] = np.asarray(float(self.max_priority))
        return state

    def load_state_dict(self, state) -> None:
        """The rows, ptr and size, then the priorities (zero past size) and
        the max priority, written into the tensors this replay already
        holds: whatever read them before (per_state) reads the restored
        values, in stream order."""
        super().load_state_dict(state)
        if "priorities" not in state:
            return
        n = int(state["size"])
        self.priorities.zero_()
        self.priorities[:n] = torch.as_tensor(
            np.asarray(state["priorities"], np.float32), device=self.device)
        self.max_priority.fill_(float(state["max_priority"]))
