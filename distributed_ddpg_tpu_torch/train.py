"""Training entry point + CLI of the port: one learner process, N actor processes.

A lean single-process counterpart of distributed_ddpg_tpu/train.py's
_train_jax_impl (the default path: uniform device replay, host actor pool,
K learner steps per dispatch). It covers:

- the actor pool's start and the ingest of its rows into DeviceReplay;
- the replay_min_size warmup;
- chunk dispatch through ShardedLearner.run_sample_chunk (on the card,
  one launch of the hand-written kernel per chunk);
- the param broadcast (param_refresh_every learner steps, with the
  param_refresh_interval_s wall-clock floor);
- the max_learn_ratio learner-rate cap;
- D4PG's auto support (--v_min=auto --v_max=auto): sized from the warmup
  replay's rewards before the first chunk, then widened on the 50-chunk
  cadence when mean_q nears an edge and the replay's rewards corroborate
  it (ops/support_auto.py);
- a numpy eval of the deterministic policy;
- JSONL records under the JAX trainer's names: the six learner metrics,
  eval_return, env_steps_per_sec, learner_steps_per_sec, final_return,
  and under D4PG v_min, v_max and support_refusals.

Checkpoint and resume are later work (so are the checkpointed bounds).

Usage:
    python -m distributed_ddpg_tpu_torch.train --total_env_steps=100000
    python -m distributed_ddpg_tpu_torch.train --distributional=true --n_step=5 \
        --v_min=auto --v_max=auto                                  # D4PG
    python -m distributed_ddpg_tpu_torch.train --device=cpu ...   # plain versions
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, param_layout
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of
from distributed_ddpg_tpu_torch.ops import support_auto
from distributed_ddpg_tpu_torch.types import pack_batch_np


class JsonlLog:
    """One JSON object per line to stdout and, when given, a file."""

    def __init__(self, path: str = "", echo: bool = True):
        self._file = open(path, "a", buffering=1) if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, kind: str, step: int, **fields: Any) -> Dict[str, Any]:
        rec = {"kind": kind, "step": int(step),
               "wall_time": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
        if self._echo:
            print(line, flush=True)
        return rec

    def close(self) -> None:
        if self._file:
            self._file.close()


class Timer:
    """Running rate meter on the monotonic clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t = time.monotonic()
        self._n = 0

    def tick(self, n: int = 1) -> None:
        self._n += n

    def rate(self) -> float:
        dt = time.monotonic() - self._t
        return self._n / dt if dt > 0 else 0.0

    def exclude(self, seconds: float) -> None:
        """Drop off-path work (an inline eval) from the measured window."""
        self._t += seconds


def _eval_numpy(policy, config: DDPGConfig, spec, episodes: Optional[int] = None) -> float:
    env = make(config.env_id, seed=config.seed + 777)
    returns = []
    for ep in range(episodes or config.eval_episodes):
        obs, _ = env.reset(seed=config.seed + 777 + ep)
        done, total = False, 0.0
        while not done:
            action = np.clip(policy(obs)[0], spec.action_low, spec.action_high)
            obs, r, terminated, truncated, _ = env.step(action)
            total += r
            done = terminated or truncated
        returns.append(total)
    return float(np.mean(returns))


def train(config: DDPGConfig, echo: bool = True) -> Dict[str, Any]:
    # torch loads here, not at import: spawned actor workers re-import the
    # main module (this one, under `python -m`) and must stay torch-free.
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.parallel.learner import (
        ShardedLearner,
        resolve_device,
        resolve_learner_chunk,
    )
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    device = resolve_device(config)
    env = make(config.env_id, seed=config.seed)
    spec = spec_of(env)
    chunk = resolve_learner_chunk(config)
    min_fill = max(config.replay_min_size, config.batch_size)
    learner = ShardedLearner(
        config, spec.obs_dim, spec.act_dim, spec.action_scale,
        spec.action_offset, chunk_size=chunk,
    )
    replay = DeviceReplay(
        config.replay_capacity, spec.obs_dim, spec.act_dim, device, block_size=1024,
    )
    eval_policy = NumpyPolicy(
        param_layout(spec.obs_dim, spec.act_dim, tuple(config.actor_hidden)),
        spec.action_scale, spec.action_offset,
    )
    log = JsonlLog(config.log_path, echo=echo)
    env_timer, learn_timer = Timer(), Timer()
    learn_steps = chunks = 0
    support_controller = support_auto.SupportController()

    def support_fields() -> Dict[str, Any]:
        if not config.distributional:
            return {}
        return dict(v_min=learner.config.v_min, v_max=learner.config.v_max,
                    support_refusals=support_controller.refusals)

    def data_bounds():
        return support_auto.replay_data_bounds(replay, config.gamma, config.n_step)

    pool = ActorPool(config, spec).start(learner.actor_params_to_host())

    def env_steps() -> int:
        return pool.steps_received

    def ingest() -> int:
        moved = 0
        for batch in pool.drain_batches():
            replay.add_packed(pack_batch_np(batch))
            moved += len(batch["reward"])
        env_timer.tick(moved)
        return moved

    def evaluate(at_step: int) -> float:
        t0 = time.monotonic()
        eval_policy.load_flat(learner.actor_params_to_host())
        ret = _eval_numpy(eval_policy, config, spec)
        learn_timer.exclude(time.monotonic() - t0)
        log.log("eval", at_step, eval_return=ret)
        return ret

    try:
        # --- warmup: fill replay to the learning threshold ---
        last_monitor_t = time.monotonic()
        while len(replay) < min_fill:
            moved = ingest()
            if len(replay) + replay.pending_rows >= min_fill:
                replay.flush()
            if time.monotonic() - last_monitor_t >= 1.0:
                last_monitor_t = time.monotonic()
                pool.monitor()
            if not moved:
                time.sleep(0.01)

        if config.distributional and learner.config.v_support_auto:
            # C51 auto support: [v_min, v_max] from the warmup replay's
            # (n-step) reward statistics, before the first chunk.
            learner.set_value_bounds(*data_bounds())
            log.log("support", env_steps(), reason="warmup", **support_fields())

        learn_timer.reset()
        env_timer.reset()
        next_refresh = 0
        last_refresh_t = last_log_t = 0.0
        last_eval = 0
        out = None
        while True:
            if time.monotonic() - last_monitor_t >= 1.0:
                last_monitor_t = time.monotonic()
                pool.monitor()
            if env_steps() >= config.total_env_steps and learn_steps > 0:
                break
            if config.max_learn_ratio > 0.0 and learn_steps > 0 and (
                learn_steps + chunk > min_fill + config.max_learn_ratio * env_steps()
            ):
                # Learner-rate cap: ingest instead of dispatching until env
                # steps catch up with the allowance.
                if not ingest():
                    time.sleep(0.002)
                continue
            out = learner.run_sample_chunk(replay)
            chunks += 1
            learn_steps += chunk
            learn_timer.tick(chunk)
            # Ingest while the chunk runs. Without this wait the loop would
            # queue chunks far ahead of the card, then block on all of them
            # at its next device read while the actors' bounded queue sits
            # full and undrained.
            while True:
                done = learner.chunk_done()
                if not ingest() and not done:
                    time.sleep(0.0005)
                if done:
                    break

            now = time.perf_counter()
            if learn_steps >= next_refresh and (
                now - last_refresh_t >= config.param_refresh_interval_s
            ):
                pool.broadcast(learner.actor_params_to_host())
                next_refresh = learn_steps + config.param_refresh_every
                last_refresh_t = time.perf_counter()

            if config.distributional and config.v_support_auto and chunks % 50 == 0:
                # Running expansion: mean_q near an edge of the support, and
                # the replay's current rewards corroborate a wider one.
                mean_q = learner.metrics_to_host(out)["mean_q"]
                grown = support_controller.check(
                    learner.config.v_min, learner.config.v_max, mean_q, learn_steps,
                    data_bounds_fn=data_bounds,
                )
                if grown is not None:
                    learner.set_value_bounds(*grown)
                    log.log("support", env_steps(), reason="expanded", mean_q=mean_q,
                            **support_fields())

            on_cadence = chunks == 1 or chunks % 50 == 0
            if on_cadence and now - last_log_t >= 1.0:
                last_log_t = now
                episodes = pool.episode_stats()
                metrics = learner.metrics_to_host(out)
                log.log(
                    "train", env_steps(),
                    learner_steps=learn_steps,
                    learner_steps_per_sec=learn_timer.rate(),
                    env_steps_per_sec=env_timer.rate(),
                    buffer_fill=len(replay),
                    episode_return=(
                        float(np.mean([e[1] for e in episodes])) if episodes else None
                    ),
                    **metrics,
                    **support_fields(),
                )
            if config.eval_every and env_steps() - last_eval >= config.eval_every:
                last_eval = env_steps()
                evaluate(last_eval)
    finally:
        pool.stop()

    metrics = learner.metrics_to_host(out) if out is not None else {}
    rate = learn_timer.rate()
    env_rate = env_timer.rate()
    eval_policy.load_flat(learner.actor_params_to_host())
    final_return = _eval_numpy(eval_policy, config, spec)
    log.log(
        "final", env_steps(),
        learner_steps=learn_steps,
        learner_steps_per_sec=rate,
        env_steps_per_sec=env_rate,
        final_return=final_return,
        chunks=chunks,
        **metrics,
        **support_fields(),
    )
    log.close()
    return {
        "learner_steps_per_sec": rate,
        "env_steps_per_sec": env_rate,
        "learner_steps": learn_steps,
        "chunks": chunks,
        "chunk_size": chunk,
        "env_steps": env_steps(),
        "final_return": final_return,
        **{k: metrics[k] for k in METRIC_KEYS if k in metrics},
        **support_fields(),
    }


def main(argv=None) -> None:
    config = DDPGConfig.from_flags(argv if argv is not None else sys.argv[1:])
    summary = train(config)
    print({k: round(v, 3) if isinstance(v, float) else v for k, v in summary.items()})


if __name__ == "__main__":
    main()
