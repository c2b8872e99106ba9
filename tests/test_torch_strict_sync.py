"""The port's --strict_sync lockstep mode against the JAX package's, on the CPU.

- SyncActorPool (actors/sync_pool.py) against the JAX package's on the
  same flat params: the same rows (obs, action, n-step reward, discount,
  next_obs), bit for bit, through a sequence of ingest budgets with a
  broadcast between them, the same finished episodes and the same
  steps_received; DDPG (OU noise, 3-step returns) and SAC (the uniform
  warmup, then the Gaussian policy's samples). The envs are the JAX
  registry's resolution in both (gymnasium's Pendulum where it imports).
- Two strict-sync runs of one config through the port's CLI in child
  processes (2 actors, 16-wide, 2-step returns, batch 32, 192 warmup
  rows, 1000 env steps, both ratios 1; tests/test_strict_sync.py's
  config) give bit-identical records once the wall-clock fields are
  stripped: the JAX test's list, the port's env_steps_per_sec (the JAX
  records call it actor_steps_per_sec) and every t_* field. On the
  kernel route (K1's plain version here) and on the scan route with the
  fused update (K2's plain version here).
- The strict_sync refusals, with the JAX package's messages.
"""

import json

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.actors.sync_pool import SyncActorPool as JaxSyncPool
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs import spec_of as jax_spec_of
from distributed_ddpg_tpu.envs import make as jax_make
from distributed_ddpg_tpu_torch.actors.policy import (
    actor_head_dim,
    flatten_params,
    param_layout,
)
from distributed_ddpg_tpu_torch.actors.sync_pool import SyncActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of
from test_torch_slice import train_in_subprocess

torch.set_num_threads(1)

# tests/test_strict_sync.py's wall-clock fields, the port's name for the
# actors' rate, and the header record's pid (each run here is a process of
# its own; t_unix_base goes with the t_* fields).
TIME_KEYS = (
    "wall_time", "learner_steps_per_sec", "actor_steps_per_sec",
    "ingest_rows_per_sec", "ingest_stall_ms", "ingest_ship_ms",
    "replay_exchange_ms_p50", "replay_exchange_ms_p95",
    "env_steps_per_sec", "pid",
)

POOL_CASES = {
    "ddpg": dict(n_step=3),
    "sac": dict(sac=True, warmup_uniform_steps=60, n_step=2),
}


def _strip(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in TIME_KEYS and not k.startswith("t_")}


def _params(layout, seed):
    rng = np.random.default_rng(seed)
    return tuple({"w": (0.3 * rng.standard_normal(w)).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                 for w, b in layout)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_sync_pool_rollouts_match_jax(case):
    over = dict(num_actors=2, actor_hidden=(16, 16), seed=3, **POOL_CASES[case])
    cfg, jcfg = DDPGConfig(device="cpu", **over), JaxConfig(**over)
    spec = spec_of(make(cfg.env_id, seed=0))
    assert spec == jax_spec_of(jax_make(jcfg.env_id, seed=0))
    layout = param_layout(spec.obs_dim, actor_head_dim(spec.act_dim, cfg.sac),
                          tuple(cfg.actor_hidden))
    ours = SyncActorPool(cfg, spec).start(flatten_params(_params(layout, 0)))
    theirs = JaxSyncPool(jcfg, spec).start(_params(layout, 0))
    assert ours.transport == "inline"
    for i, budget in enumerate((50, 0, 137, 300, 1)):
        if i == 3:
            ours.broadcast(flatten_params(_params(layout, 1)))
            theirs.broadcast(_params(layout, 1))
        a = ours.drain_batches(max_rows=budget, with_sources=True)
        b = theirs.drain_batches(max_rows=budget, with_sources=True)
        assert len(a) == len(b) == (1 if budget else 0)
        for (wa, ba), (wb, bb) in zip(a, b):
            assert wa == wb == -1
            assert set(ba) == set(bb)
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k], f"drain {i} {k}")
                assert ba[k].dtype == bb[k].dtype
    assert ours.steps_received == theirs.steps_received > 400
    assert ours.episode_stats() == theirs.episode_stats()
    assert ours.recovery_counters()["actor_respawns"] == 0
    assert not ours.quarantine_source(0)
    ours.stop()
    theirs.stop()


def test_sync_pool_drain_into_a_host_replay():
    from distributed_ddpg_tpu_torch.replay import UniformReplay

    cfg = DDPGConfig(device="cpu", num_actors=3, actor_hidden=(8,))
    spec = spec_of(make(cfg.env_id, seed=0))
    layout = param_layout(spec.obs_dim, spec.act_dim, (8,))
    pool = SyncActorPool(cfg, spec).start(flatten_params(_params(layout, 2)))
    rep = UniformReplay(1000, spec.obs_dim, spec.act_dim)
    assert pool.drain_into(rep, max_rows=90) == 90 == len(rep)
    assert pool.drain_into(rep) == 0              # no budget, no steps
    pool.stop()


ROUTES = {"kernel": [], "scan": ["--fused_update=true"]}


@pytest.mark.parametrize("route", list(ROUTES))
def test_two_strict_sync_runs_are_bit_identical(tmp_path, route):
    flags = ["--strict_sync=true", "--num_actors=2", "--actor_hidden=16,16",
             "--critic_hidden=16,16", "--n_step=2", "--batch_size=32",
             "--replay_min_size=192", "--total_env_steps=1000", "--max_learn_ratio=1.0",
             "--max_ingest_ratio=1.0", "--eval_every=400", "--eval_episodes=1",
             "--learner_chunk=8", *ROUTES[route]]
    a = train_in_subprocess(flags, tmp_path / "a.jsonl")
    b = train_in_subprocess(flags, tmp_path / "b.jsonl")
    assert len(a) == len(b)
    assert any(r["kind"] == "train" for r in a) and any(r["kind"] == "eval" for r in a)
    for ra, rb in zip(a, b):
        assert _strip(ra) == _strip(rb), json.dumps([ra, rb])
    final = a[-1]
    assert final["transport"] == "inline" and final["ingest_async_active"] is False
    assert not any(k.startswith("transfer_") for k in final)   # no scheduler
    assert final["learner_steps"] > 0 and np.isfinite(final["final_return"])


@pytest.mark.parametrize("over, match", [
    (dict(strict_sync=True), "ratio"),
    (dict(strict_sync=True, backend="native", max_learn_ratio=1.0, max_ingest_ratio=1.0),
     "native"),
    (dict(strict_sync=True, host_replay=True, max_learn_ratio=1.0, max_ingest_ratio=1.0),
     "device replay"),
])
def test_strict_sync_refusals_match_jax(over, match):
    with pytest.raises(ValueError, match=match) as ours:
        DDPGConfig(**over)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxConfig(**over)
    assert str(ours.value) == str(theirs.value)
