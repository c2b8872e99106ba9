"""The port's on-device monolith (ondevice.py, train.train_ondevice) against
the JAX package's, on the CPU at tiny widths (E = 4 envs, nets 16x16,
batch 8, K = 16 iterations a chunk, a 64-row ring that wraps).

- Two chunks of OnDeviceDDPG against the JAX OnDeviceDDPG on a one-device
  mesh, from its converted state, with JAX's draws and indices passed in
  (its key schedule replayed here: each iteration's four-way split, then
  a sample key once the ring holds replay_min_size rows): the ring, ptr,
  size, the state, each chunk's metrics, its learner steps, dones and
  episode returns at tests/test_torch_scan.py's tolerances (rtol 2e-5,
  atol 1e-6, metrics 5e-5). DDPG, and DDPG with a uniform warmup of the
  first two iterations (the gate on the ring's fill).
- Termination: MountainCar envs placed at the goal store their terminal
  rows at discount 0 (reward +100), the others at gamma.
- The constructor's refusals (PER, n_step, train_every, a warmup of the
  whole ring) with JAX's messages.
- finalize_stats against JAX's on stacked superstep rows (the learned
  counts' weighting, the episodes across the rows), and a superstep equal
  to B chunks bit for bit.
- The ring's state_dict round trip; `--backend=jax_ondevice` through the
  CLI with a checkpoint, and again resumed from it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs.jax_envs import JaxPendulum
from distributed_ddpg_tpu.ondevice import ChunkStats as JaxChunkStats
from distributed_ddpg_tpu.ondevice import OnDeviceDDPG as JaxOnDevice
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy, train_state_to_numpy
from distributed_ddpg_tpu_torch.ondevice import ChunkStats, OnDeviceDDPG
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws
from test_torch_slice import REPO

torch.set_num_threads(1)

E, K, B = 4, 16, 8
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/test_torch_scan.py
COMMON = dict(num_actors=E, actor_hidden=(16, 16), critic_hidden=(16, 16), batch_size=B,
              replay_capacity=64, replay_min_size=24, backend="jax_ondevice")


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _jax_schedule(jcfg, chunks):
    """JAX OnDeviceDDPG's key schedule: the init split, then per iteration
    the exploration step's four-way split and, once the ring holds
    max(replay_min_size, batch_size) rows, a sample key for [B] indices."""
    env = JaxPendulum()
    k_init, key = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    init = jax.vmap(env.init)(jax.random.split(k_init, E))
    low, high = jnp.asarray(env.action_low), jnp.asarray(env.action_high)
    size, min_fill = 0, max(jcfg.replay_min_size, jcfg.batch_size)
    draws, indices = [], []
    for _ in range(chunks * K):
        key, k_ou, k_env, k_uni = jax.random.split(key, 4)
        fresh = jax.vmap(env.init)(jax.random.split(k_env, E))
        draws.append(StepDraws(
            noise=torch.from_numpy(np.array(jax.random.normal(k_ou, (E, 1), jnp.float32))),
            reset=torch.from_numpy(np.stack([np.asarray(fresh.th), np.asarray(fresh.thdot)], 1)),
            uniform=torch.from_numpy(np.array(jax.random.uniform(
                k_uni, (E, 1), jnp.float32, minval=low, maxval=high)))))
        size = min(size + E, jcfg.replay_capacity)
        if size >= min_fill:
            key, k_sample = jax.random.split(key)
            indices.append(torch.from_numpy(np.array(
                jax.random.randint(k_sample, (jcfg.batch_size,), 0, max(size, 1)))).long())
    return np.stack([np.asarray(init.th), np.asarray(init.thdot)], 1), draws, indices


@pytest.mark.parametrize("family", ["ddpg", "ddpg-warmup"])
def test_chunks_match_the_jax_monolith(family):
    over = dict(COMMON, **(dict(warmup_uniform_steps=2 * E) if family == "ddpg-warmup" else {}))
    jcfg, cfg = JaxConfig(**over), DDPGConfig(device="cpu", **over)
    mesh = jax_mesh.make_mesh(data_axis=1, model_axis=1, devices=jax.devices()[:1])
    jod = JaxOnDevice(jcfg, mesh=mesh, chunk_size=K)
    od = OnDeviceDDPG(cfg, chunk_size=K)
    od.load_train_state(train_state_from_numpy(jax.tree.map(np.asarray, jod.state)))
    init, draws, indices = _jax_schedule(jcfg, 2)
    od.env_state = od.env.init(torch.from_numpy(init))
    od.obs = od.env.observe(od.env_state)
    used = 0
    for c in range(2):
        jstats = jod.run_chunk()
        stats = od.run_chunk(draws=draws[c * K:(c + 1) * K], indices=indices[used:])
        used += stats.learn_steps
        assert stats.learn_steps == int(jstats.learn_steps)
        np.testing.assert_array_equal(stats.dones.numpy(), np.asarray(jstats.dones))
        _close(f"ep_returns {c}", stats.ep_returns.numpy(), np.asarray(jstats.ep_returns))
        for i, k in enumerate(METRIC_KEYS):
            _close(f"{k} of chunk {c}", stats.metrics[i].item(), float(jstats.metrics[k]),
                   METRIC_RTOL, ATOL)
        if c == 0 and family == "ddpg-warmup":
            # The first two iterations acted uniformly (the ring held < 8
            # rows), the third on the policy.
            ring = od.replay.storage.numpy()
            for it in range(3):
                u = draws[it].uniform.numpy()[:, 0]
                assert np.array_equal(ring[it * E:(it + 1) * E, 3], u) == (it < 2)
    assert used == len(indices) == 2 * K - 5
    assert (od.replay.ptr, len(od.replay)) == (int(jod.carry.ptr), int(jod.carry.size)) == (0, 64)
    _close("ring", od.replay.storage.numpy(), np.asarray(jod.carry.storage))
    ours, theirs = train_state_to_numpy(od.state), jax.tree.map(np.asarray, jod.state)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (a, b) in enumerate(zip(getattr(ours, group), getattr(theirs, group))):
            for key in ("w", "b"):
                _close(f"{group}[{i}].{key}", a[key], b[key])
    assert int(ours.step) == int(theirs.step) == used


def test_terminal_rows_are_stored_at_discount_zero():
    cfg = DDPGConfig(device="cpu", **dict(COMMON, env_id="MountainCarContinuous-v0",
                                          replay_min_size=1000, replay_capacity=2048))
    od = OnDeviceDDPG(cfg, chunk_size=4)
    pos = torch.tensor([0.44, 0.449, -0.5, -1.2])
    vel = torch.tensor([0.02, 0.01, 0.0, -0.05])
    od.env_state = od.env_state._replace(pos=pos, vel=vel)
    od.obs = od.env.observe(od.env_state)
    stats = od.run_chunk()
    rows = od.replay.storage[:len(od.replay)].numpy()
    disc, rew, nxt = rows[:, 4], rows[:, 3], rows[:, 5:7]
    term = (nxt[:, 0] >= 0.45) & (nxt[:, 1] >= 0.0)
    assert term.sum() >= 2 and stats.dones.numpy()[0, :2].all()
    np.testing.assert_array_equal(disc[term], 0.0)
    np.testing.assert_allclose(disc[~term], np.float32(cfg.gamma))
    assert np.all(rew[term] > 99.0) and np.all(rew[~term] <= 0.0)


@pytest.mark.parametrize("over", [
    dict(prioritized=True), dict(n_step=3), dict(train_every=2),
    dict(warmup_uniform_steps=64),
], ids=["per", "n_step", "train_every", "warmup"])
def test_constructor_refusals_match_jax(over):
    over = dict(COMMON, **over)
    with pytest.raises(ValueError) as theirs:
        JaxOnDevice(JaxConfig(**over), chunk_size=K)
    with pytest.raises(ValueError) as ours:
        OnDeviceDDPG(DDPGConfig(device="cpu", **over), chunk_size=K)
    assert str(ours.value) == str(theirs.value)


def test_finalize_stats_matches_jax_on_stacked_rows():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, len(METRIC_KEYS))).astype(np.float32)
    learned = np.array([0, 5, 16], np.int32)
    dones = rng.random((3, K, E)) < 0.1
    rets = np.where(dones, rng.standard_normal((3, K, E)), 0.0).astype(np.float32)

    class _Host:
        _learn_steps = 0

    want = JaxOnDevice.finalize_stats(_Host(), JaxChunkStats(
        metrics={k: m[:, i] for i, k in enumerate(METRIC_KEYS)}, learn_steps=learned,
        dones=dones, ep_returns=rets))
    od = OnDeviceDDPG(DDPGConfig(device="cpu", **COMMON), chunk_size=K)
    got = od.finalize_stats(ChunkStats(metrics=torch.from_numpy(m), learn_steps=list(learned),
                                       dones=torch.from_numpy(dones),
                                       ep_returns=torch.from_numpy(rets)))
    assert got.keys() == want.keys() and got["episodes"] == want["episodes"]
    for k in want:
        _close(k, got[k], want[k], 1e-6, 1e-7)


def test_superstep_equals_chunks_and_state_dict_round_trips():
    over = dict(COMMON, superstep_beats=3)
    a = OnDeviceDDPG(DDPGConfig(device="cpu", **over), chunk_size=K)
    b = OnDeviceDDPG(DDPGConfig(device="cpu", **over), chunk_size=K)
    sup = a.run_superstep()
    chunks = [b.run_chunk() for _ in range(3)]
    assert sup.learn_steps == [c.learn_steps for c in chunks] == [11, 16, 16]
    assert torch.equal(sup.metrics, torch.stack([c.metrics for c in chunks]))
    ra, rb = a.replay, b.replay
    assert torch.equal(ra.storage, rb.storage) and (ra.ptr, len(ra)) == (rb.ptr, len(rb))
    assert a.finalize_stats(sup) == b.finalize_stats(ChunkStats(
        metrics=sup.metrics, learn_steps=sup.learn_steps,
        dones=torch.stack([c.dones for c in chunks]),
        ep_returns=torch.stack([c.ep_returns for c in chunks])))
    c = OnDeviceDDPG(DDPGConfig(device="cpu", **over), chunk_size=K)
    c.replay.load_state_dict(ra.state_dict())
    rc = c.replay
    assert torch.equal(rc.storage, ra.storage) and (rc.ptr, len(rc)) == (ra.ptr, len(ra))


def _cli(flags):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "distributed_ddpg_tpu_torch.train",
                          "--device=cpu", "--backend=jax_ondevice", *flags], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_cli_runs_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    flags = ["--num_actors=4", "--actor_hidden=16,16", "--critic_hidden=16,16",
             "--batch_size=16", "--replay_min_size=100", "--eval_every=1024",
             "--eval_episodes=1", f"--checkpoint_dir={d}", "--checkpoint_every=200"]
    out = _cli(flags + ["--total_env_steps=2560"])
    # Ten chunks' worth of env steps (2560) crossed: one train record.
    assert all(f'"kind": "{k}"' in out for k in ("eval", "train", "final"))
    out2 = _cli(flags + ["--total_env_steps=3072"])
    assert f"resumed from {d} at learner step" in out2
    final = [line for line in out2.splitlines() if line.startswith('{"kind": "final"')][0]
    assert '"step": 3072' in final
