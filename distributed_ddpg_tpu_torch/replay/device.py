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
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_ddpg_tpu_torch.replay.staging import HostStagingRing
from distributed_ddpg_tpu_torch.types import packed_width


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
