"""Rollout worker process: the per-worker episode loop.

A copy of distributed_ddpg_tpu/actors/worker.py. Each worker owns one
env, one OU noise process (reset per episode; zeroed under SAC, whose
workers sample the Gaussian policy instead), one n-step accumulator, and a
numpy policy refreshed from the shared-memory param buffer. Its first
`warmup_uniform` env steps take uniform-random actions from the box (SAC's
start_steps). It streams n-step transitions back in batches and stamps a
heartbeat every loop so the pool's monitor can respawn it if it dies or
goes silent. Two transports:

- shm (`ring_buf` given): rows packed [obs, action, reward, discount,
  next_obs, version] (the version of the params that acted, which the pool
  turns into staleness) are pushed into the worker's SPSC ring
  (native.ShmRing); rows the ring has no room for are carried to the next
  flush, which first waits, stamping the heartbeat and with the orphan
  guard, until the learner drains the ring (backpressure: env stepping
  slows, no row is dropped). Finished episodes go over the worker's
  bounded queue when it has room;
- queue: each batch, with the episodes finished since the last and the
  params' version, over the worker's bounded mp.Queue.

`fault_specs` is this worker's slice of the run's FaultPlan (config.faults,
faults.py): (kind, at_step, duration_s) tuples applied inline after each
env step: `crash` raises (the pool respawns the dead worker), `hang`
freezes without heartbeats (the silent timeout), `stall` keeps
heartbeating and produces nothing (the pool's zero-rows detector,
actor_no_progress_s), `slow` sleeps each step for SLOW_FAULT_STEPS steps.
`throttle_s` (config.actor_throttle_s) sleeps before each step. With
`trace_dir` the worker keeps its own flight recorder (trace.py: an
`actor_flush` span a flush, an `episode` instant an episode) and writes
trace_actor<id>.json there when it exits.

Served acting (config.serve_actors; the JAX worker's `served_mu`): mu(s)
comes from the learner process's InferenceServer over the pool's shared
request queue and this worker's response queue, each request bounded by
serve_timeout_s. The local policy mirror stays loaded as the fallback: a
full request queue, a timeout or a request the server could not serve
sends the worker to its local act() for serve_fallback_s, counted in the
pool's serve_fallbacks (serve_client_fallbacks). A stalled or dead serving
stack costs latency, never a deadlock.

Workers never import torch (policy.py, trace.py and faults.py are numpy or
stdlib), so they never touch CUDA.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time

import numpy as np


def run_worker(
    worker_id: int,
    env_id: str,
    seed: int,
    layout,
    action_scale,
    action_offset,
    action_low,
    action_high,
    shared_params,          # mp.Array('f'), flat actor params
    param_version,          # mp.Value('l'), seqlock version
    transition_queue,       # this worker's mp.Queue (batches, or episodes only on shm)
    heartbeat,              # mp.Array('d', num_workers)
    stop_flag,              # mp.Value('b')
    ou_theta: float,
    ou_sigma: float,
    ou_dt: float,
    n_step: int,
    gamma: float,
    send_every: int = 32,
    parent_pid: int = 0,    # pool process pid, captured at spawn time
    gaussian_policy: bool = False,   # SAC: sample the policy, no OU noise
    log_std_min: float = -5.0,
    log_std_max: float = 2.0,
    warmup_uniform: int = 0,         # uniform-random actions for the first N steps
    ring_buf=None,                   # mp.Array('B') of this slot's ShmRing, or None
    ring_rows: int = 0,
    serve_request_queue=None,        # served acting: the pool's shared request queue
    serve_response_queue=None,       # and this worker's own response queue
    serve_fallbacks=None,            # mp.Array('l'): local-act fallbacks a worker
    serve_timeout_s: float = 1.0,
    serve_fallback_s: float = 5.0,
    fault_specs=(),                  # (kind, at_step, duration_s), faults.for_worker
    throttle_s: float = 0.0,         # config.actor_throttle_s
    trace_dir: str = "",             # this worker's trace export dir ("" = off)
) -> None:
    from distributed_ddpg_tpu_torch import trace
    from distributed_ddpg_tpu_torch.actors.policy import (
        NumpyPolicy,
        encode_version,
        seqlock_snapshot,
    )
    from distributed_ddpg_tpu_torch.envs import make
    from distributed_ddpg_tpu_torch.ops.noise import OUNoise
    from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator

    # A worker is its own interpreter: its own ring, its own file.
    if trace_dir:
        trace.configure(capacity=8192)

    env = make(env_id, seed=seed)
    act_dim = len(np.atleast_1d(action_low))
    policy = NumpyPolicy(layout, action_scale, action_offset, gaussian=gaussian_policy,
                         stochastic=gaussian_policy, seed=seed, log_std_min=log_std_min,
                         log_std_max=log_std_max)
    noise = OUNoise((act_dim,), theta=ou_theta, sigma=0.0 if gaussian_policy else ou_sigma,
                    dt=ou_dt, seed=seed)
    nstep = NStepAccumulator(n_step, gamma)
    warmup_rng = np.random.default_rng(seed + 7919)   # uniform-warmup draws
    flat_scratch = np.empty_like(np.frombuffer(shared_params, dtype=np.float32))
    seen_version = -1
    pending: list = []
    episodes: list = []     # (return, length) finished since the last send
    # shm: attach to the slot's ring (the pool ran ring_init and built the
    # library, so this is a dlopen). A respawned worker attaches to the
    # same ring and goes on where the last one stopped.
    ring = None
    carry = None            # rows the ring had no room for at the last flush
    if ring_buf is not None:
        from distributed_ddpg_tpu_torch.native import ShmRing

        obs_dim = layout[0][0][0]   # first layer w is (obs_dim, hidden)
        ring = ShmRing(ring_buf, ring_rows, 2 * obs_dim + act_dim + 3)

    def maybe_refresh():
        nonlocal seen_version
        v = seqlock_snapshot(shared_params, param_version, flat_scratch, seen_version)
        if v is not None:
            policy.load_flat(flat_scratch)
            seen_version = v

    def send_episodes():
        """shm: the finished episodes over the queue, if it has room (else
        they wait for the next flush)."""
        if episodes:
            try:
                transition_queue.put_nowait((worker_id, None, list(episodes), seen_version))
                episodes.clear()
            except queue_mod.Full:
                pass

    def flush_ring():
        nonlocal carry
        if pending:
            n = len(pending)
            o = pending[0][0].shape[-1]
            rows = np.empty((n, ring.width), np.float32)
            rows[:, :o] = np.stack([p[0] for p in pending])
            rows[:, o:o + act_dim] = np.stack([p[1] for p in pending])
            rows[:, o + act_dim] = [p[2] for p in pending]
            rows[:, o + act_dim + 1] = [p[3] for p in pending]
            rows[:, o + act_dim + 2:2 * o + act_dim + 2] = np.stack([p[4] for p in pending])
            rows[:, -1] = encode_version(seen_version)
            pending.clear()
            carry = rows if carry is None else np.concatenate([carry, rows])
        send_episodes()
        # Backpressure as a full queue gives it: wait (stamping the
        # heartbeat, so the monitor does not respawn a throttled worker)
        # until the learner drains the ring.
        while carry is not None and not stop_flag.value:
            if parent_pid and os.getppid() != parent_pid:
                return   # orphaned: the drainer is gone
            accepted = ring.push(carry)
            carry = carry[accepted:] if accepted < carry.shape[0] else None
            if carry is not None:
                heartbeat[worker_id] = time.time()
                time.sleep(0.001)

    def flush():
        # A long actor_flush span is the learner's backpressure.
        with trace.span("actor_flush", rows=len(pending)):
            flush_impl()

    def flush_impl():
        if ring is not None:
            flush_ring()
            return
        if not pending:
            return
        batch = {
            "obs": np.stack([p[0] for p in pending]),
            "action": np.stack([p[1] for p in pending]),
            "reward": np.asarray([p[2] for p in pending], np.float32),
            "discount": np.asarray([p[3] for p in pending], np.float32),
            "next_obs": np.stack([p[4] for p in pending]),
        }
        msg = (worker_id, batch, list(episodes), seen_version)
        # Bounded waits with the orphan guard between them: a blocking put
        # on a full queue whose drainer died would hang forever.
        while not stop_flag.value:
            if parent_pid and os.getppid() != parent_pid:
                return
            try:
                transition_queue.put(msg, timeout=0.1)
                break
            except queue_mod.Full:
                heartbeat[worker_id] = time.time()
        else:
            try:  # clean shutdown: deliver the tail if there is room
                transition_queue.put_nowait(msg)
            except queue_mod.Full:
                pass
        pending.clear()
        episodes.clear()

    # Request ids start at a random 48-bit offset each incarnation, and
    # replies already in the response queue are drained: the pool reuses a
    # slot's response queue across respawns, so a late reply to a dead
    # incarnation must never match a fresh one's request id.
    serve_rid = int.from_bytes(os.urandom(6), "little")
    serve_down_until = 0.0
    if serve_response_queue is not None:
        while True:
            try:
                serve_response_queue.get_nowait()
            except Exception:
                break

    def serve_degrade() -> None:
        nonlocal serve_down_until
        serve_down_until = time.time() + serve_fallback_s
        if serve_fallbacks is not None:
            serve_fallbacks[worker_id] += 1

    def served_mu(o: np.ndarray) -> np.ndarray:
        """One served action request, bounded by serve_timeout_s; the local
        mirror answers whenever the served path cannot."""
        nonlocal serve_rid
        if time.time() < serve_down_until:
            return policy(o)[0]
        serve_rid += 1
        try:
            serve_request_queue.put_nowait((worker_id, serve_rid, np.asarray(o, np.float32)))
        except queue_mod.Full:
            serve_degrade()
            return policy(o)[0]
        deadline = time.time() + serve_timeout_s
        while time.time() < deadline and not stop_flag.value:
            if parent_pid and os.getppid() != parent_pid:
                return policy(o)[0]   # orphaned: the server is gone
            try:
                rid, action = serve_response_queue.get(timeout=0.05)
            except queue_mod.Empty:
                # A bounded served wait is healthy, not a silent worker.
                heartbeat[worker_id] = time.time()
                continue
            if rid != serve_rid:
                continue   # a stale reply to a request given up on
            if action is None:
                serve_degrade()   # the server shed or failed this request
                return policy(o)[0]
            return np.asarray(action, np.float32)
        serve_degrade()
        return policy(o)[0]

    # --- scripted faults (faults.py; see the module docstring) ---
    faults = sorted(fault_specs, key=lambda t: t[1])
    fault_i = 0
    slow_until, slow_sleep = 0, 0.0

    def freeze(stamp_heartbeat: bool) -> None:
        """An injected hang or stall: park until the pool terminates this
        process (the recovery under test), or a clean stop or orphaning
        ends the run. `hang` parks without heartbeats, `stall` keeps
        stamping them while producing nothing."""
        while not stop_flag.value:
            if parent_pid and os.getppid() != parent_pid:
                return
            if stamp_heartbeat:
                heartbeat[worker_id] = time.time()
            time.sleep(0.05)

    def apply_faults(step: int) -> bool:
        """Fire the faults due at `step`; True when the worker must exit
        (it was hung or stalled and then released)."""
        nonlocal fault_i, slow_until, slow_sleep
        while fault_i < len(faults) and faults[fault_i][1] <= step:
            kind, _, dur = faults[fault_i]
            fault_i += 1
            if kind == "crash":
                from distributed_ddpg_tpu_torch.faults import InjectedFault

                raise InjectedFault(f"injected crash in worker {worker_id} at step {step}")
            if kind in ("hang", "stall"):
                freeze(stamp_heartbeat=(kind == "stall"))
                return True
            if kind == "slow":
                from distributed_ddpg_tpu_torch.faults import SLOW_FAULT_STEPS

                slow_until = step + SLOW_FAULT_STEPS
                slow_sleep = dur
        if step < slow_until and slow_sleep > 0.0:
            time.sleep(slow_sleep)
        return False

    maybe_refresh()
    obs, _ = env.reset(seed=seed)
    noise.reset()
    ep_return, ep_len, total_steps = 0.0, 0, 0
    orphaned = hung = False
    while not stop_flag.value:
        if parent_pid and os.getppid() != parent_pid:
            orphaned = True
            break
        heartbeat[worker_id] = time.time()
        maybe_refresh()
        if throttle_s > 0.0:
            # Before the step, so the heartbeat above keeps the monitor quiet.
            time.sleep(throttle_s)
        if total_steps < warmup_uniform:
            action = warmup_rng.uniform(action_low, action_high).astype(np.float32)
        else:
            mu = served_mu(obs) if serve_request_queue is not None else policy(obs)[0]
            action = mu + noise() * np.asarray(action_scale, np.float32)
        action = np.clip(action, action_low, action_high).astype(np.float32)
        next_obs, reward, terminated, truncated, _ = env.step(action)
        pending.extend(
            nstep.push(obs[None], action[None], [reward], [terminated], next_obs[None])
        )
        ep_return += reward
        ep_len += 1
        total_steps += 1
        obs = next_obs
        if apply_faults(total_steps):
            hung = True   # parked by an injected hang or stall, then released
            break
        if terminated or truncated:
            # Truncation bootstraps: flush the partial windows with a
            # nonzero discount, then reset per-episode state.
            if truncated and not terminated:
                pending.extend(_flush_truncated(nstep, next_obs))
            trace.instant("episode", ret=round(float(ep_return), 3), length=ep_len)
            episodes.append((ep_return, ep_len))
            obs, _ = env.reset()
            noise.reset()
            nstep.reset()
            ep_return, ep_len = 0.0, 0
        if len(pending) >= send_every:
            flush()
    # An orphan skips the last flush (its backpressure would wait forever
    # on the gone drainer), and so does a worker released from an injected
    # hang or stall (its rows in flight are the loss the fault simulates);
    # both still write their trace.
    if not orphaned and not hung:
        flush()
    if trace_dir:
        try:
            trace.export(os.path.join(trace_dir, f"trace_actor{worker_id}.json"))
        except Exception:
            pass   # diagnostics never fail a clean worker exit


def _flush_truncated(nstep, bootstrap_obs):
    """Emit the pending partial windows of a TRUNCATED episode, keeping a
    nonzero bootstrap discount (the episode did not end; time ran out)."""
    out = []
    for pend in nstep._pending:
        while pend:
            out.append(nstep._emit(pend, bootstrap_obs, terminal=False, length=len(pend)))
            pend.popleft()
    return out
