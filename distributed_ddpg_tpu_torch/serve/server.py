"""InferenceServer: one policy, many callers.

The port of distributed_ddpg_tpu/serve/server.py. The server owns the
policy params, a dynamic `Batcher` collects client observations, and each
collected batch is applied in ONE policy evaluation. Two backends, under
the JAX package's flag values so its command lines run unchanged:

  numpy  (default) The parity oracle: each batch row goes through the SAME
         NumpyPolicy `(1, obs_dim)` call the per-worker act() path runs, so
         served actions are bit-identical to local ones for the same
         params. Row-wise on purpose: a batched GEMM is not row-wise
         bit-stable against the single-row product.
  jax    The device backend (the JAX package's name for it): the params
         stay resident on `device` (the card unless the caller asks for the
         CPU), every batch is padded to the ONE (max_batch, obs_dim) shape
         and applied with the port's models/mlp.actor_apply (SAC:
         actor_gaussian_apply). On the card the apply runs on a stream of
         its own (high priority), from a pinned padded input buffer into a pinned output
         buffer, and the batcher's thread waits on the apply's own event,
         never on the whole device. Actions match the numpy oracle to float
         tolerance, not bitwise, like the learner itself. The first apply
         (cuBLAS's start-up, the allocator) runs when the server is built,
         before any client's deadline is running.

Param refresh rides the pool's broadcast buffer: the server holds the same
shared flat array and seqlock version the workers poll (actors/pool.py
`broadcast`) and re-reads it at most once a batch dispatch; a torn
snapshot is discarded as a worker discards it. On the device backend the
new params are copied into the resident tensors under the param lock, on
the serve stream, after the last apply has finished (each apply waits for
its event before it returns, under the same lock).

With a TransferScheduler attached, every batch apply is submitted as a
`serve` work item, so serving and ingest share the host <-> device bus
under one accounting. On the card the item only enqueues the batch (copy
in, apply, copy out, its event) and the batcher's thread waits on the
event after the item returns: the scheduler has one dispatch thread, and
an apply held back by a running learner chunk would otherwise hold every
ingest ship queued behind it for that chunk too.

SAC's head: the batch apply returns [mean | log_std] rows (the learner's
soft clamp), and `sample()` squashes and samples each request with a key
of its own, sha256(seed, tenant, request_id), drawn with numpy: the same
request samples the same action on any backend and in any process.

The tensor-parallel apply (`mesh=`, the JAX server's mesh under
model_axis > 1): in the port a model group is M processes, so `mesh` is a
group of the M ranks of the server's model group (parallel/mesh.serve_group:
a gloo group made for the apply alone, every collective under its
deadline), the server at its index 0 and a `ServeFollower` thread on each
other rank. Each rank keeps only its shards of the policy, cut by the
learner's rule table (parallel/partition.net_pspec, shard_tree). A refresh
broadcasts the flat params from the server and every rank keeps its
shards; a dispatch broadcasts the padded (max_batch, obs_dim) block and
every rank runs its shards' chain (models/mlp._chain with the group's
NetTP), the actions coming back whole on every rank. The JAX server
replicates the apply over the mesh's data axis too; here only the
server's model group computes it (the same actions). A collective that
fails (a lost follower, a deadline passed) fails that dispatch with
ServeGroupLost, so the workers take their local act() (serve_fallbacks),
and every later one at once: the group is never used again, and the
apply never gives way to a single-device one.

`program_specs()` is the hook of the program-contract analyzer
(analysis/programs.py): the device apply, whole and tensor-parallel.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Optional, Tuple

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, layout_size, seqlock_snapshot
from distributed_ddpg_tpu_torch.metrics import ServeStats
from distributed_ddpg_tpu_torch.serve.batcher import Batcher

# One serve dispatch is bounded by the scheduler's worst-case backlog
# (ingest super-blocks ahead of it), not by compute.
_SCHED_TIMEOUT_S = 60.0


class InferenceServer:
    def __init__(
        self,
        layout,
        action_scale,
        action_offset=0.0,
        *,
        max_batch: int = 32,
        max_latency_s: float = 0.005,
        max_queue: int = 1024,
        backend: str = "numpy",
        param_source: Optional[Tuple] = None,  # (shared f32 array, version)
        scheduler=None,
        stats: Optional[ServeStats] = None,
        seed: int = 0,
        fault_batcher=None,
        fault_dispatch=None,
        mesh=None,
        sac: bool = False,
        log_std_min: float = -5.0,
        log_std_max: float = 2.0,
        device: str = "cuda",
    ):
        if backend not in ("numpy", "jax"):
            raise ValueError(f"serve backend must be 'numpy' or 'jax', got {backend!r}")
        if mesh is not None and backend != "jax":
            # The JAX server's message.
            raise ValueError(
                "mesh= shards the jitted serve apply; the numpy backend "
                "is the single-threaded bit-parity oracle — use "
                "backend='jax' or drop the mesh"
            )
        if mesh is not None and mesh.rank != 0:
            raise ValueError("the server is its mesh's rank 0; the other ranks follow "
                             "(ServeFollower)")
        self.backend = backend
        self._mesh = mesh
        self._tp = None
        self.layout = layout
        self.obs_dim = int(layout[0][0][0])  # the first layer's w is (obs, hidden)
        self.head_dim = int(layout[-1][0][1])
        self.sac = bool(sac)
        if self.sac and self.head_dim % 2:
            raise ValueError(
                "SAC head layout must be [mean | log_std] (even width); "
                f"got final-layer width {self.head_dim} — build the "
                "layout with actor_head_dim(act_dim, sac=True)"
            )
        self.act_dim = self.head_dim // 2 if self.sac else self.head_dim
        self.log_std_min = float(log_std_min)
        self.log_std_max = float(log_std_max)
        self._sample_seed = int(seed)
        self._policy = NumpyPolicy(layout, action_scale, action_offset)
        self._param_lock = threading.Lock()
        self._param_source = param_source
        self._seen_version = -1
        self._scratch = np.empty(layout_size(layout), np.float32)
        self.scheduler = scheduler
        self.stats = stats or ServeStats(seed=seed, max_batch=max_batch)
        self.max_batch = int(max_batch)
        self.device = None
        if backend == "jax":
            self._build_device_apply(device)
        self.batcher = Batcher(
            self._apply_batch,
            max_batch=max_batch,
            max_latency_s=max_latency_s,
            max_queue=max_queue,
            stats=self.stats,
            fault_batcher=fault_batcher,
            fault_dispatch=fault_dispatch,
        )

    # --- lifecycle ---

    def start(self) -> "InferenceServer":
        self.batcher.start()
        return self

    def overloaded(self, frac: float = 0.9) -> bool:
        """Live degraded-condition probe: True while the bounded request
        queue sits past `frac` of its capacity, where new requests are
        about to shed. Reads the queue as it is now."""
        return self.batcher.depth() >= frac * self.batcher.max_queue

    def close(self, timeout: float = 30.0) -> None:
        """Flush on shutdown: the batcher drains every accepted request
        before its thread exits; then the followers of a tensor-parallel
        apply are told to stop."""
        self.batcher.close(timeout=timeout)
        if self._tp is not None:
            with self._param_lock:
                try:
                    self._tp.step(_TPApply.STOP)
                except ServeGroupLost:
                    pass   # the followers are gone or leave at their deadline

    def client(self, timeout_s: float = 1.0):
        from distributed_ddpg_tpu_torch.serve.client import ServeClient

        return ServeClient(self, timeout_s=timeout_s)

    # --- params ---

    def refresh(self, flat: np.ndarray) -> None:
        """Install params from a flat f32 vector (serve_bench, the front's
        engines, tests; the pool path goes through _maybe_refresh)."""
        flat = np.asarray(flat, np.float32)
        with self._param_lock:
            self._policy.load_flat(flat)
            if self.device is not None:
                self._ship_device_params(flat)
        self.stats.record_refresh()

    def _maybe_refresh(self) -> None:
        """One seqlock read of the pool's broadcast buffer, at most once a
        batch dispatch: an int compare when nothing changed."""
        if self._param_source is None:
            return
        shared, version = self._param_source
        v = seqlock_snapshot(shared, version, self._scratch, self._seen_version)
        if v is not None:
            with self._param_lock:
                self._policy.load_flat(self._scratch)
                if self.device is not None:
                    self._ship_device_params(self._scratch)
            self._seen_version = v
            self.stats.record_refresh()

    # --- compute ---

    def _apply_batch(self, obs: np.ndarray) -> np.ndarray:
        """The Batcher's apply_fn: refresh params, then run the batch,
        through the transfer scheduler's `serve` class when attached."""
        self._maybe_refresh()
        out_dim = self.head_dim if self.sac else self.act_dim
        nbytes = obs.nbytes + obs.shape[0] * out_dim * 4
        if self.scheduler is None:
            return self._compute(obs)

        def submit(fn):
            return self.scheduler.submit(
                "serve", fn, nbytes=nbytes, label=f"serve_batch_{obs.shape[0]}",
            ).result(timeout=_SCHED_TIMEOUT_S)

        if self.device is None or self._tp is not None:
            # The tensor-parallel apply's exchanges run inside the item.
            return submit(lambda: self._compute(obs))
        # The item enqueues; this thread waits on the apply's event.
        with self._param_lock:
            submit(lambda: self._enqueue_device(obs))
            return self._collect_device(obs.shape[0])

    def _compute(self, obs: np.ndarray) -> np.ndarray:
        with self._param_lock:
            if self.device is not None:
                return self._compute_device(obs)
            # Row-wise (1, obs_dim) evaluation: bit-identical to act().
            if self.sac:
                return np.concatenate([self._head_row(row) for row in obs], axis=0)
            return np.concatenate([self._policy(row) for row in obs], axis=0)

    def _head_row(self, row: np.ndarray) -> np.ndarray:
        """SAC's batch output: [mean | log_std] with the learner's soft
        clamp (models/mlp.actor_gaussian_apply), so both backends agree on
        the distribution `sample()` draws from."""
        raw = self._policy.head(row)
        mean, log_std_raw = np.split(raw, 2, axis=-1)
        log_std = self.log_std_min + 0.5 * (self.log_std_max - self.log_std_min) * (
            np.tanh(log_std_raw) + 1.0)
        return np.concatenate([mean, log_std], axis=-1).astype(np.float32, copy=False)

    def sample(self, head, tenant: str, request_id: int, explore: bool = True) -> np.ndarray:
        """One SAC head row [mean | log_std] -> an action row. The
        exploration key is sha256(seed, tenant, request_id): stable across
        processes and replayable, so the same request always samples the
        same action and no two clients share a stream. explore=False is
        the deterministic tanh(mean) squash."""
        if not self.sac:
            # lint: ok(typed-error): caller bug (sampling a deterministic
            # head), not a runtime failure any recovery path handles
            raise RuntimeError("sample() is the SAC serve head's API")
        head = np.asarray(head, np.float32).reshape(-1)
        mean, log_std = head[: self.act_dim], head[self.act_dim:]
        if explore:
            digest = hashlib.sha256(
                f"{self._sample_seed}:{tenant}:{request_id}".encode()).digest()
            rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
            eps = rng.standard_normal(mean.shape).astype(np.float32)
            u = mean + np.exp(log_std) * eps
        else:
            u = mean
        return (np.tanh(u) * self._policy.scale + self._policy.offset).astype(np.float32)

    # --- the device backend ---

    def _build_device_apply(self, device) -> None:
        import torch

        from distributed_ddpg_tpu_torch.devices import require_device

        dev = require_device(device)
        self._torch = torch
        self.device = dev
        if self._mesh is not None:
            self._tp = _TPApply(self.layout, self._mesh, dev, self.max_batch,
                                self._policy.scale, self._policy.offset, self.sac,
                                self.log_std_min, self.log_std_max)
            # The followers' first shards, then the warm apply, every rank's.
            self._ship_device_params(np.zeros(layout_size(self.layout), np.float32))
            self._compute_device(np.zeros((1, self.obs_dim), np.float32))
            return
        on_card = dev.type == "cuda"
        b, out_dim = self.max_batch, self.head_dim
        # Host buffers are pinned on the card, so every copy is an
        # asynchronous one on the serve stream.
        self._flat_host = torch.zeros(layout_size(self.layout), dtype=torch.float32,
                                      pin_memory=on_card)
        self._in_host = torch.zeros((b, self.obs_dim), dtype=torch.float32, pin_memory=on_card)
        self._out_host = torch.zeros((b, out_dim), dtype=torch.float32, pin_memory=on_card)
        self._flat_dev = torch.zeros(layout_size(self.layout), dtype=torch.float32, device=dev)
        self._in_dev = torch.zeros((b, self.obs_dim), dtype=torch.float32, device=dev)
        # The resident params: views into one flat device tensor, in the
        # pool's flat layout (w then b, layer order).
        params, i = [], 0
        for w_shape, b_shape in self.layout:
            nw, nb = int(np.prod(w_shape)), int(np.prod(b_shape))
            params.append({"w": self._flat_dev[i:i + nw].view(*w_shape),
                           "b": self._flat_dev[i + nw:i + nw + nb].view(*b_shape)})
            i += nw + nb
        self._params = tuple(params)
        self._scale = torch.from_numpy(self._policy.scale).to(dev)
        self._offset = torch.from_numpy(self._policy.offset).to(dev)
        # A stream of its own at high priority: a learner chunk (K1, a
        # persistent launch that holds every SM) blocks the apply until it
        # ends; at that boundary the apply's kernels, already queued here,
        # go ahead of the next chunk's blocks.
        self._stream = torch.cuda.Stream(device=dev, priority=-1) if on_card else None
        self._done = torch.cuda.Event() if on_card else None
        # The warm apply: cuBLAS's handle and workspace, the allocator's
        # blocks for the activations, before any deadline runs.
        self._compute_device(np.zeros((1, self.obs_dim), np.float32))

    def _on_serve_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return self._torch.cuda.stream(self._stream)

    def _wait_done(self) -> None:
        """Wait for the serve stream's work so far: its own event, never a
        device-wide synchronize (a learner chunk may be running)."""
        if self._done is not None:
            self._done.record(self._stream)
            self._done.synchronize()

    def _ship_device_params(self, flat: np.ndarray) -> None:
        """Copy new params into the resident tensors (caller holds the
        param lock, so no apply is running: the last one waited for its
        event); under `mesh` every rank of the group keeps its shards."""
        if self._tp is not None:
            self._tp.flat.numpy()[:] = flat
            self._tp.step(_TPApply.PARAMS)
            return
        self._flat_host.numpy()[:] = flat
        with self._on_serve_stream():
            self._flat_dev.copy_(self._flat_host, non_blocking=self._stream is not None)
            self._wait_done()

    def _forward(self, obs):
        return policy_forward(self._params, obs, self._scale, self._offset, self.sac,
                              self.log_std_min, self.log_std_max)

    def _compute_device(self, obs: np.ndarray) -> np.ndarray:
        """Pad the batch to the one (max_batch, obs_dim) shape (the padded
        rows are zeros; their outputs are computed and sliced away), apply,
        and return the first n rows."""
        if self._tp is not None:
            n = obs.shape[0]
            padded = self._tp.obs.numpy()
            padded[:n] = obs
            padded[n:] = 0.0
            _, out = self._tp.step(_TPApply.APPLY)
            return out[:n].cpu().numpy()
        self._enqueue_device(obs)
        return self._collect_device(obs.shape[0])

    def _enqueue_device(self, obs: np.ndarray) -> None:
        """Fill the pinned padded input and queue the copy in, the apply,
        the copy out and the apply's event on the serve stream; nothing
        waits. The caller holds the param lock until _collect_device, so
        the buffers are free (the last apply was waited for)."""
        n = obs.shape[0]
        padded = self._in_host.numpy()
        padded[:n] = obs
        padded[n:] = 0.0
        on_card = self._stream is not None
        with self._on_serve_stream():
            self._in_dev.copy_(self._in_host, non_blocking=on_card)
            self._out_host.copy_(self._forward(self._in_dev), non_blocking=on_card)
            if on_card:
                self._done.record(self._stream)

    def _collect_device(self, n: int) -> np.ndarray:
        """Wait on the apply's own event; the first n rows of the output."""
        if self._done is not None:
            self._done.synchronize()
        return self._out_host.numpy()[:n].copy()

    @property
    def shard_bytes(self) -> int:
        """Bytes of policy params this rank holds on its device: its shards
        under `mesh`, else the whole policy (0 on the numpy backend)."""
        if self._tp is not None:
            return self._tp.shard_bytes
        return 4 * layout_size(self.layout) if self.device is not None else 0

    # --- observability ---

    def snapshot(self) -> dict:
        """The serve_* family (metrics.ServeStats) with the live queue
        depth as a gauge."""
        return self.stats.snapshot(queue_depth=self.batcher.depth())


class ServeGroupLost(RuntimeError):
    """A collective of the tensor-parallel serve apply failed (a lost
    follower or server, or its deadline passed): the dispatch fails, and
    so does every later one, at once (the group is not used again). The
    original error rides along as __cause__."""


def policy_forward(params, obs, scale, offset, sac: bool, log_std_min: float,
                   log_std_max: float, tp=None):
    """The served policy's batch apply: actions (the actor's tanh onto the
    box), or SAC's [mean | log_std] head rows; on a rank's shards with `tp`
    (a models/mlp.NetTP), the output whole on every rank."""
    import torch

    from distributed_ddpg_tpu_torch.models.mlp import actor_apply, actor_gaussian_apply

    with torch.no_grad():
        if sac:
            mean, log_std = actor_gaussian_apply(params, obs, log_std_min, log_std_max, tp=tp)
            return torch.cat([mean, log_std], dim=-1)
        return actor_apply(params, obs, scale, offset, tp=tp)


class _TPApply:
    """One rank's part of the tensor-parallel serve apply over `mesh` (a
    parallel/mesh.DataGroup of the model group's ranks, the server at its
    index 0): its shards of the policy on `device` and the buffers the
    server broadcasts. `step` is one exchange, the same on every rank: the
    server's op (STOP, PARAMS or APPLY), then for PARAMS the flat params
    (every rank keeps its shards) and for APPLY the padded observation
    block (every rank runs its shards' chain; the output is whole)."""

    STOP, PARAMS, APPLY = 0, 1, 2

    def __init__(self, layout, mesh, device, max_batch: int, scale, offset, sac: bool,
                 log_std_min: float, log_std_max: float):
        import torch

        from distributed_ddpg_tpu_torch.models.mlp import NetTP
        from distributed_ddpg_tpu_torch.parallel.partition import layer_kinds, net_pspec

        self.layout, self.mesh, self.device = layout, mesh, device
        shapes = tuple({"w": torch.empty(w, device="meta"), "b": torch.empty(b, device="meta")}
                       for w, b in layout)
        self.specs = net_pspec(shapes, mesh.world_size)
        self.tp = NetTP(layer_kinds(self.specs), mesh)
        self.op = torch.zeros(1, dtype=torch.int64)
        self.flat = torch.zeros(layout_size(layout), dtype=torch.float32)
        self.obs = torch.zeros((int(max_batch), int(layout[0][0][0])), dtype=torch.float32)
        self._scale = torch.as_tensor(scale, device=device)
        self._offset = torch.as_tensor(offset, device=device)
        self._head = (bool(sac), float(log_std_min), float(log_std_max))
        self.params = None
        self.shard_bytes = 0
        self._broken: Optional[BaseException] = None
        # On the card the apply runs on a stream of its own, beside the
        # rank's learner chunks.
        self._stream = (torch.cuda.Stream(device=device, priority=-1)
                        if device.type == "cuda" else None)

    def step(self, op: Optional[int] = None):
        """One exchange; the server passes its op, a follower None.
        Returns (op, output): the whole [max_batch, out] output for APPLY,
        else None."""
        import torch

        from distributed_ddpg_tpu_torch.parallel.mesh import _broadcast

        if self._broken is not None:
            raise ServeGroupLost("the tensor-parallel serve group failed earlier") \
                from self._broken
        try:
            if op is not None:
                self.op[0] = op
            _broadcast(self.op, self.mesh, control=True)
            op = int(self.op[0])
            if op == self.PARAMS:
                _broadcast(self.flat, self.mesh, control=True)
                self._load()
            elif op == self.APPLY:
                _broadcast(self.obs, self.mesh, control=True)
                ctx = (torch.cuda.stream(self._stream) if self._stream is not None
                       else contextlib.nullcontext())
                with ctx:
                    out = policy_forward(self.params, self.obs.to(self.device), self._scale,
                                         self._offset, *self._head, tp=self.tp)
                    if self._stream is not None:
                        self._stream.synchronize()
                return op, out
            return op, None
        except Exception as e:
            self._broken = e
            raise ServeGroupLost(f"tensor-parallel serve exchange failed on model rank "
                                 f"{self.mesh.rank} of {self.mesh.world_size}: {e!r}") from e

    def _load(self) -> None:
        """This rank's shards of the flat params, on the device."""
        from distributed_ddpg_tpu_torch.parallel.partition import shard_tree

        flat, tree, i = self.flat.numpy(), [], 0
        for w_shape, b_shape in self.layout:
            nw, nb = int(np.prod(w_shape)), int(np.prod(b_shape))
            tree.append({"w": flat[i:i + nw].reshape(w_shape),
                         "b": flat[i + nw:i + nw + nb].reshape(b_shape)})
            i += nw + nb
        shards = shard_tree(tuple(tree), self.specs, self.mesh.rank, self.mesh.world_size)
        self.params = tuple({k: self._torch_of(v) for k, v in layer.items()} for layer in shards)
        self.shard_bytes = sum(t.numel() * 4 for layer in self.params for t in layer.values())

    def _torch_of(self, a: np.ndarray):
        import torch

        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)


class ServeFollower:
    """A model rank's side of the tensor-parallel serve apply (the module's
    docstring): a thread that takes part in every exchange the server on
    the group's rank 0 starts, holding this rank's shards, until the
    server's STOP or a failed exchange (`error`)."""

    def __init__(self, layout, action_scale, action_offset=0.0, *, mesh, max_batch: int = 32,
                 sac: bool = False, log_std_min: float = -5.0, log_std_max: float = 2.0,
                 device: str = "cuda"):
        from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy
        from distributed_ddpg_tpu_torch.devices import require_device

        if mesh.rank == 0:
            raise ValueError("rank 0 of the serve mesh is the server")
        policy = NumpyPolicy(layout, action_scale, action_offset)   # the box, as the server's
        self._tp = _TPApply(layout, mesh, require_device(device), max_batch, policy.scale,
                            policy.offset, sac, log_std_min, log_std_max)
        self.applies = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve_follower")

    def start(self) -> "ServeFollower":
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                op, _ = self._tp.step()
            except ServeGroupLost as e:
                self.error = e
                return
            if op == _TPApply.STOP:
                return
            if op == _TPApply.APPLY:
                self.applies += 1

    @property
    def shard_bytes(self) -> int:
        return self._tp.shard_bytes

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the thread's end; False if it is still running."""
        self._thread.join(timeout)
        return not self._thread.is_alive()


# ---------------------------------------------------------------------------
# program-contract analyzer hook (analysis/programs.py)
# ---------------------------------------------------------------------------


def program_specs():
    """The device serve apply: one padded (max_batch, obs_dim) batch through
    the resident params, and its tensor-parallel form over the (2, 2)
    grid's model group (`mesh=`; the followers' side of each broadcast is
    the fake group's). Serving runs outside the learner's lockstep, so its
    one-device apply stages no collective; its read of the output rows back
    to the host is the request's answer."""
    from distributed_ddpg_tpu_torch.actors.policy import param_layout
    from distributed_ddpg_tpu_torch.analysis.programs import (
        BuiltProgram,
        ProgramSpec,
        probe_group,
    )
    from distributed_ddpg_tpu_torch.parallel.mesh import make_grid

    READS = "the apply's output rows copied back to the host: the requests' answer"

    def build(tp: bool = False):
        def _build(device: str) -> BuiltProgram:
            mesh = make_grid(probe_group(device, 2), 2).model if tp else None
            server = InferenceServer(param_layout(3, 1, (16, 16)), np.ones(1, np.float32),
                                     backend="jax", max_batch=8, mesh=mesh, device=device)
            obs = np.zeros((8, 3), np.float32)
            return BuiltProgram(lambda: server._compute(obs))
        return _build

    return [
        ProgramSpec("serve.apply.jax", "serve/server.py", build(), host_reads=READS),
        ProgramSpec("serve.apply.jax.tp", "serve/server.py", build(tp=True),
                    host_reads=READS),
    ]
