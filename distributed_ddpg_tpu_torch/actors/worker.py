"""Rollout worker process: the per-worker episode loop.

A trimmed copy of distributed_ddpg_tpu/actors/worker.py (queue transport;
the shm ring, served acting, fault injection and tracing are not in the
port yet). Each worker owns one env, one OU noise process (reset per
episode; zeroed under SAC, whose workers sample the Gaussian policy
instead), one n-step accumulator, and a numpy policy refreshed from the
shared-memory param buffer. Its first `warmup_uniform` env steps take
uniform-random actions from the box (SAC's start_steps). It streams
n-step transitions back in batches over a bounded mp.Queue of its own and
stamps a heartbeat every loop so the pool's monitor can respawn it if it
dies or goes silent.

Workers never import torch (policy.py), so they never touch CUDA.
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
    transition_queue,       # this worker's mp.Queue
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
) -> None:
    from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, seqlock_snapshot
    from distributed_ddpg_tpu_torch.envs import make
    from distributed_ddpg_tpu_torch.ops.noise import OUNoise
    from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator

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

    def maybe_refresh():
        nonlocal seen_version
        v = seqlock_snapshot(shared_params, param_version, flat_scratch, seen_version)
        if v is not None:
            policy.load_flat(flat_scratch)
            seen_version = v

    def flush():
        if not pending:
            return
        batch = {
            "obs": np.stack([p[0] for p in pending]),
            "action": np.stack([p[1] for p in pending]),
            "reward": np.asarray([p[2] for p in pending], np.float32),
            "discount": np.asarray([p[3] for p in pending], np.float32),
            "next_obs": np.stack([p[4] for p in pending]),
        }
        msg = (worker_id, batch, list(episodes))
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

    maybe_refresh()
    obs, _ = env.reset(seed=seed)
    noise.reset()
    ep_return, ep_len, total_steps = 0.0, 0, 0
    orphaned = False
    while not stop_flag.value:
        if parent_pid and os.getppid() != parent_pid:
            orphaned = True
            break
        heartbeat[worker_id] = time.time()
        maybe_refresh()
        if total_steps < warmup_uniform:
            action = warmup_rng.uniform(action_low, action_high).astype(np.float32)
        else:
            mu = policy(obs)[0]
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
        if terminated or truncated:
            # Truncation bootstraps: flush the partial windows with a
            # nonzero discount, then reset per-episode state.
            if truncated and not terminated:
                pending.extend(_flush_truncated(nstep, next_obs))
            episodes.append((ep_return, ep_len))
            obs, _ = env.reset()
            noise.reset()
            nstep.reset()
            ep_return, ep_len = 0.0, 0
        if len(pending) >= send_every:
            flush()
    if not orphaned:
        flush()


def _flush_truncated(nstep, bootstrap_obs):
    """Emit the pending partial windows of a TRUNCATED episode, keeping a
    nonzero bootstrap discount (the episode did not end; time ran out)."""
    out = []
    for pend in nstep._pending:
        while pend:
            out.append(nstep._emit(pend, bootstrap_obs, terminal=False, length=len(pend)))
            pend.popleft()
    return out
