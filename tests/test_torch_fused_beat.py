"""The port's fused beat and superstep (parallel/megastep.py, superstep.py)
on the CPU at tiny widths (nets 16x16, batch 16, K = 2 learner steps, 8
envs x 2 steps a rollout).

- N fused beats bit-identical to the separate sequence (the learner's
  scan-route chunk, then the device actors' rollout into the ring), as
  JAX's test_fused_beat_bit_identical_to_separate_dispatches: uniform and
  PER, guarded and not, DDPG on the stock update and with K2's plain
  version. Every state tensor, the ring, ptr and size, the priorities and
  max_priority, the rollout carry, the generators and (guarded) the probe
  state and health word, with torch.equal.
- After set_lr_scale (the guardrails' cooldown) the beat still equals the
  separate sequence.
- A superstep of B = 4 beats bit-identical to 4 sequential beats, uniform,
  PER (per-beat betas) and guarded; its one host read's per-beat metrics
  equal the beats' own.
- The first bad beat of a superstep reported from its stacked health
  (numeric:grad:nan in the third beat), and a clean superstep's -1.
- The activation rule of fused_beat ('auto' with the chunk kernel's route,
  with the scan route, with a ratio gate; 'on').
- Against the JAX package: N beats of the port against JAX's
  FusedMegastep, and one B = 4 superstep against JAX's FusedSuperstep, on a
  one-device CPU mesh, from JAX's state converted (TrainState, guard state,
  ring, priorities, rollout carry), with JAX's key schedule replayed here
  and passed in (the learner leg's split-then-randint, or PER's
  draw_per_indices on JAX's priorities of the moment; the rollout's four-way
  split a step). Uniform, PER, guarded and both. State, ring, carry,
  priorities and per-beat metrics at tests/test_torch_scan.py's tolerances
  (rtol 2e-5, atol 1e-6; metrics rtol 5e-5); ptr, size, step counts and
  the health words exactly. A superstep's per-beat numbers come from a
  second JAX stack stepped beat by beat (JAX's own test holds the two bit
  for bit). per_beat_betas against JAX's on a grid, bit for bit; the
  first bad beat (numeric:grad:nan@5) against JAX's superstep.
- The port's CLI with the JAX verify recipe's flags (the JAX package's
  .claude/skills/verify/SKILL.md: 8 envs, rollouts of 2, K = 2, B = 4,
  448 env steps) gives the accounting of JAX's CLI, run beside it with the
  same flags: fused_supersteps 6, fused_beats 24, learner_steps 48,
  devactor_env_steps 448.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.actors.device_pool import DeviceActorPool as JaxPool
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs.jax_envs import JaxPendulum
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.parallel.megastep import FusedMegastep as JaxMegastep
from distributed_ddpg_tpu.parallel.superstep import FusedSuperstep as JaxSuperstep
from distributed_ddpg_tpu.parallel.superstep import per_beat_betas as jax_per_beat_betas
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPER
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxReplay
from distributed_ddpg_tpu.replay.device import draw_per_indices as jax_draw_per
from distributed_ddpg_tpu_torch import guardrails
from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep, fused_beat_active
from distributed_ddpg_tpu_torch.parallel.superstep import FusedSuperstep, per_beat_betas
from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
from test_torch_slice import REPO

torch.set_num_threads(1)

BASE = dict(actor_backend="device", num_actors=0, device_actor_envs=8, device_actor_chunk=2,
            learner_chunk=2, batch_size=16, actor_hidden=(16, 16), critic_hidden=(16, 16),
            replay_capacity=2048, replay_min_size=64, fused_chunk="off", fused_beat="on",
            device="cpu")


def _system(**over):
    """A learner, a device-actor pool bound to it and a device replay,
    warmed to replay_min_size by standalone rollouts."""
    cfg = DDPGConfig(**dict(BASE, **over))
    pool = DeviceActorPool(cfg)
    learner = ShardedLearner(cfg, pool.obs_dim, pool.act_dim, pool.action_scale,
                             pool.action_offset, chunk_size=cfg.learner_chunk)
    pool.bind(lambda: learner.state.actor_params)
    if cfg.prioritized:
        rep = DevicePrioritizedReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim,
                                      device="cpu", alpha=cfg.per_alpha, eps=cfg.per_eps)
    else:
        rep = DeviceReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim, device="cpu")
    while len(rep) < cfg.replay_min_size:
        pool.run_chunk(rep)
    return cfg, learner, pool, rep


def _separate(cfg, learner, pool, rep, beta):
    """The dispatch-per-phase loop's iteration: the chunk, then the rollout."""
    if cfg.prioritized:
        out = learner.run_sample_chunk_per(rep, beta)
    else:
        out = learner.run_sample_chunk(rep)
    pool.run_chunk(rep)
    return out


def _snapshot(learner, pool, rep):
    c = pool.carry
    t = [*state_tensors(learner.state), rep.storage[:len(rep)].clone(), *c.env_state,
         c.obs, c.ou, c.ep_ret, c.steps, c.episodes, c.ret_sum,
         learner._gen.get_state(), pool._gen.get_state()]
    if isinstance(rep, DevicePrioritizedReplay):
        t += [rep.priorities.clone(), rep.max_priority.clone()]
    if learner.guard_enabled:
        t += list(learner._guard)
    return t, (rep.ptr, len(rep), c.host_steps)


def _assert_same(a, b):
    (ta, ha), (tb, hb) = a, b
    assert ha == hb
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"tensor {i} differs"


VARIANTS = {
    "uniform": dict(),
    "uniform-k2": dict(fused_update=True),
    "per": dict(prioritized=True),
    "guarded": dict(guardrails=True, fused_update=True),
    "per-guarded": dict(prioritized=True, guardrails=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_beat_bit_identical_to_the_separate_sequence(variant):
    fused, sep = _system(**VARIANTS[variant]), _system(**VARIANTS[variant])
    ms = FusedMegastep(*fused)
    assert ms.guard == fused[0].guardrails
    for n in range(3):
        beta = 0.4 + 0.1 * n
        out_f = ms.run_beat(beta)
        out_s = _separate(*sep, beta)
        for k in METRIC_KEYS:
            assert torch.equal(out_f.metrics[k], out_s.metrics[k]), k
        assert torch.equal(out_f.td_errors, out_s.td_errors)
    _assert_same(_snapshot(*fused[1:]), _snapshot(*sep[1:]))
    if fused[0].guardrails:
        assert fused[1].poll_health() == sep[1].poll_health()
    snap = ms.snapshot()
    assert snap["fused_beats"] == 3 and snap["fused_supersteps"] == 3
    assert fused[2].steps_done == sep[2].steps_done


def test_beat_after_set_lr_scale_equals_the_separate_sequence():
    fused, sep = _system(fused_update=True), _system(fused_update=True)
    ms = FusedMegastep(*fused)
    ms.run_beat()
    _separate(*sep, None)
    for sysm in (fused, sep):
        sysm[1].set_lr_scale(0.5)
    for _ in range(2):
        ms.run_beat()
        _separate(*sep, None)
    _assert_same(_snapshot(*fused[1:]), _snapshot(*sep[1:]))
    # The scale took: a third system without it has other params.
    plain = _system(fused_update=True)
    pms = FusedMegastep(*plain)
    for _ in range(3):
        pms.run_beat()
    assert not torch.equal(plain[1].state.actor_params[0]["w"],
                           fused[1].state.actor_params[0]["w"])


@pytest.mark.parametrize("variant", ["uniform", "per", "guarded"])
def test_superstep_bit_identical_to_sequential_beats(variant):
    over = dict(VARIANTS[variant], superstep_beats=4)
    sup, seq = _system(**over), _system(**over)
    ss, ms = FusedSuperstep(*sup), FusedMegastep(*seq)
    assert ss.beats == 4
    betas = per_beat_betas(sup[0], 200, 4, ss.rows_per_beat)
    assert betas.dtype == np.float32 and np.all(np.diff(betas) > 0)
    for _ in range(2):
        out = ss.run_superstep(betas if sup[0].prioritized else None)
        per_beat = []
        for b in range(4):
            o = ms.run_beat(float(betas[b]) if seq[0].prioritized else None)
            per_beat.append([float(o.metrics[k]) for k in METRIC_KEYS])
        np.testing.assert_array_equal(ss.last_metrics, np.asarray(per_beat))
        assert torch.equal(out.td_errors, o.td_errors)
        if sup[0].guardrails:
            assert sup[1].poll_health() == dict(seq[1].poll_health(), first_bad_beat=-1)
    _assert_same(_snapshot(*sup[1:]), _snapshot(*seq[1:]))
    assert ss.totals() == {"fused_beats": 8, "fused_supersteps": 2,
                           "fused_superstep_beats": 4.0}


def test_superstep_reports_the_first_bad_beat():
    # Guarded steps 5 and 6 are the third beat's (K = 2 a beat).
    cfg, learner, pool, rep = _system(guardrails=True, superstep_beats=4,
                                      faults="numeric:grad:nan@5")
    ss = FusedSuperstep(cfg, learner, pool, rep)
    ss.run_superstep()
    h = learner.poll_health()
    assert h["nonfinite"] == 1 and h["first_bad_beat"] == 2
    assert ss.last_health[:, 1].tolist() == [0, 0, 1, 1]
    ss.run_superstep()
    h = learner.poll_health()
    assert h["nonfinite"] == 1 and h["first_bad_beat"] == -1 and h["total"] == 16


def test_fused_beat_activation_rule():
    def learner_of(**over):
        cfg = DDPGConfig(**dict(BASE, **over))
        return cfg, ShardedLearner(cfg, 3, 1, np.array([2.0], np.float32), chunk_size=2)

    cfg, learner = learner_of(fused_beat="auto", fused_chunk="auto")
    assert learner.fused_chunk_active and not fused_beat_active(cfg, learner, True)
    cfg, learner = learner_of(fused_beat="auto")
    assert fused_beat_active(cfg, learner, True) and not fused_beat_active(cfg, learner, False)
    cfg, learner = learner_of(fused_beat="auto", max_ingest_ratio=1.0)
    assert not fused_beat_active(cfg, learner, True)
    cfg, learner = learner_of(fused_beat="on", fused_chunk="auto")
    assert learner.fused_chunk_active and fused_beat_active(cfg, learner, True)
    cfg, learner = learner_of(fused_beat="off")
    assert not fused_beat_active(cfg, learner, True)


# --- against the JAX package ---------------------------------------------

RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/test_torch_scan.py
JAX_VARIANTS = {
    "uniform": dict(),
    "per": dict(prioritized=True),
    "guarded": dict(guardrails=True),
    "per-guarded": dict(prioritized=True, guardrails=True),
}


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _jax_stack(jcfg):
    """JAX's learner, device-actor pool and device replay on a one-device
    CPU mesh, the ring warmed by standalone rollouts to replay_min_size
    (tests/test_superstep.py's _setup)."""
    mesh = jax_mesh.make_mesh(1, 1, devices=jax.devices("cpu")[:1])
    pool = JaxPool(jcfg, mesh=mesh)
    learner = JaxLearner(jcfg, pool.obs_dim, pool.act_dim, pool.action_scale,
                         action_offset=pool.action_offset, mesh=mesh,
                         chunk_size=jcfg.learner_chunk)
    cls = JaxPER if jcfg.prioritized else JaxReplay
    replay = cls(jcfg.replay_capacity, pool.obs_dim, pool.act_dim, mesh=mesh,
                 block_size=16, async_ship=False)
    pool.set_params(learner.state.actor_params)
    while int(replay.size) < jcfg.replay_min_size:
        pool.run_chunk(replay)
    return learner, pool, replay


def _np(x):
    return np.asarray(jax.device_get(x))


def _port_from_jax(cfg, jl, jp, jr):
    """The port's learner, pool and replay holding JAX's state as it stands."""
    pool = DeviceActorPool(cfg)
    learner = ShardedLearner(cfg, pool.obs_dim, pool.act_dim, pool.action_scale,
                             pool.action_offset, chunk_size=cfg.learner_chunk,
                             state=train_state_from_numpy(jax.tree.map(np.asarray, jl.state)))
    pool.bind(lambda: learner.state.actor_params)
    if learner.guard_enabled:
        learner._guard = guardrails.guard_state_from_numpy(jax.tree.map(np.asarray, jl._guard))
    c = jp._carry

    def t(x, dt=None):
        return torch.as_tensor(_np(x).copy(), dtype=dt)

    env_state = type(pool.carry.env_state)(*(t(x) for x in c.env_state))
    pool._carry = pool.carry._replace(
        env_state=env_state, obs=t(c.obs), ou=t(c.ou), ep_ret=t(c.ep_ret),
        steps=t(c.steps, torch.int64), episodes=t(c.episodes, torch.int64),
        ret_sum=t(c.ret_sum), host_steps=int(c.steps))
    if cfg.prioritized:
        rep = DevicePrioritizedReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim,
                                      device="cpu", alpha=cfg.per_alpha, eps=cfg.per_eps)
        rep.set_per_state(torch.from_numpy(_np(jr.priorities).copy()),
                          torch.tensor(float(jr.max_priority)))
    else:
        rep = DeviceReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim, device="cpu")
    rep.storage.copy_(torch.from_numpy(_np(jr.storage).copy()))
    rep.ptr, rep.size = int(_np(jr.ptr)), int(_np(jr.size))
    return learner, pool, rep


def _rollout_draws(key, k_env, n_envs):
    """JAX's rollout stream from the carry's key (jax ops/exploration.py:
    each step splits next, ou, env, uniform): the normals, every env's
    reset values and the warmup uniforms."""
    env = JaxPendulum()
    low, high = jnp.asarray(env.action_low), jnp.asarray(env.action_high)
    draws = []
    for _ in range(k_env):
        key, k_ou, k_env_key, k_uni = jax.random.split(key, 4)
        fresh = jax.vmap(env.init)(jax.random.split(k_env_key, n_envs))
        draws.append(StepDraws(
            noise=torch.from_numpy(np.array(jax.random.normal(k_ou, (n_envs, 1), jnp.float32))),
            reset=torch.from_numpy(np.stack([_np(fresh.th), _np(fresh.thdot)], 1)),
            uniform=torch.from_numpy(np.array(jax.random.uniform(
                k_uni, (n_envs, 1), jnp.float32, minval=low, maxval=high)))))
    return draws


def _jax_beat_numbers(jcfg, jl, jp, jr, beta):
    """The numbers JAX's next beat will draw, from the stack as it stands:
    the learner leg's indices (and PER weights) and the rollout's draws."""
    _, sub = jax.random.split(jl._key)
    shape = (jcfg.learner_chunk, jcfg.batch_size)
    if jcfg.prioritized:
        idx, w = jax.jit(jax_draw_per, static_argnums=3)(
            sub, jr.priorities, jr.size, shape, jnp.float32(beta))
        inj = dict(idx=torch.from_numpy(np.array(idx)).long(),
                   weights=torch.from_numpy(np.array(w)))
    else:
        idx = jax.random.randint(sub, shape, 0, jnp.maximum(jr.size, 1))
        inj = dict(idx=torch.from_numpy(np.array(idx)).long())
    inj["draws"] = _rollout_draws(jp._carry.key, jp.chunk_size, jp.num_envs)
    return inj


def _assert_like_jax(learner, pool, rep, jl, jp, jr):
    state, ref = learner.state, jax.tree.map(np.asarray, jl.state)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (a, b) in enumerate(zip(getattr(state, group), getattr(ref, group))):
            for key in ("w", "b"):
                _close(f"{group}[{i}].{key}", a[key].numpy(), b[key])
    for opt in ("actor_opt", "critic_opt"):
        o, r = getattr(state, opt), getattr(ref, opt)
        for i in range(len(o.mu)):
            for key in ("w", "b"):
                _close(f"{opt}.mu[{i}].{key}", o.mu[i][key].numpy(), r.mu[i][key])
                _close(f"{opt}.nu[{i}].{key}", o.nu[i][key].numpy(), r.nu[i][key])
        assert int(o.count) == int(r.count), opt
    assert int(state.step) == int(ref.step)
    assert (rep.ptr, len(rep)) == (int(_np(jr.ptr)), int(_np(jr.size)))
    _close("ring", rep.storage.numpy(), _np(jr.storage))
    c, jc = pool.carry, jp._carry
    for i, (a, b) in enumerate(zip(c.env_state, jc.env_state)):
        _close(f"env_state[{i}]", a.numpy(), _np(b))
    for name in ("obs", "ou", "ep_ret", "ret_sum"):
        _close(name, getattr(c, name).numpy(), _np(getattr(jc, name)))
    assert int(c.steps) == c.host_steps == int(_np(jc.steps))
    assert int(c.episodes) == int(_np(jc.episodes))
    if isinstance(rep, DevicePrioritizedReplay):
        _close("priorities", rep.priorities.numpy(), _np(jr.priorities))
        _close("max_priority", float(rep.max_priority), float(jr.max_priority))
    if learner.guard_enabled:
        g, jg = learner._guard, jl._guard
        for name in g._fields:
            _close(f"guard.{name}", getattr(g, name).numpy(), _np(getattr(jg, name)))


def _configs(**over):
    base = dict(BASE, **over)
    base.pop("device")
    return JaxConfig(**base), DDPGConfig(device="cpu", **base)


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_beats_match_the_jax_fused_megastep(variant):
    jcfg, cfg = _configs(**JAX_VARIANTS[variant])
    jl, jp, jr = _jax_stack(jcfg)
    learner, pool, rep = _port_from_jax(cfg, jl, jp, jr)
    jms, ms = JaxMegastep(jcfg, jl, jp, jr), FusedMegastep(cfg, learner, pool, rep)
    for n in range(3):
        beta = 0.4 + 0.1 * n
        inj = _jax_beat_numbers(jcfg, jl, jp, jr, beta)
        jout = jms.run_beat(beta if jcfg.prioritized else None)
        out = ms.run_beat(beta if cfg.prioritized else None, **inj)
        for k in METRIC_KEYS:
            _close(f"beat {n} {k}", out.metrics[k].item(), float(jout.metrics[k]), METRIC_RTOL)
        _close(f"beat {n} td", out.td_errors.numpy(), _np(jout.td_errors))
        if learner.guard_enabled:
            assert learner.poll_health() == jl.poll_health()
    _assert_like_jax(learner, pool, rep, jl, jp, jr)
    assert ms.snapshot()["fused_beats"] == jms.snapshot()["fused_beats"] == 3


def _superstep_pair(jcfg, cfg, budget):
    """Two JAX stacks and the port's converted from the first: JAX's beat
    numbers captured from the second, stepped beat by beat."""
    primary, twin = _jax_stack(jcfg), _jax_stack(jcfg)
    port = _port_from_jax(cfg, *primary)
    B = cfg.superstep_beats
    betas = jax_per_beat_betas(jcfg, budget, B, port[1].rows_per_chunk)
    twin_ms = JaxMegastep(jcfg, *twin)
    numbers, metrics = [], []
    for b in range(B):
        numbers.append(_jax_beat_numbers(jcfg, *twin, float(betas[b])))
        out = twin_ms.run_beat(float(betas[b]) if jcfg.prioritized else None)
        metrics.append([float(out.metrics[k]) for k in METRIC_KEYS])
    return primary, port, betas, numbers, np.asarray(metrics)


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_superstep_matches_the_jax_fused_superstep(variant):
    jcfg, cfg = _configs(superstep_beats=4, **JAX_VARIANTS[variant])
    (jl, jp, jr), (learner, pool, rep), betas, numbers, jax_metrics = _superstep_pair(
        jcfg, cfg, budget=96)
    jss, ss = JaxSuperstep(jcfg, jl, jp, jr), FusedSuperstep(cfg, learner, pool, rep)
    per = cfg.prioritized
    jout = jss.run_superstep(betas=betas if per else None)
    out = ss.run_superstep(betas if per else None,
                           idx=[n["idx"] for n in numbers],
                           weights=[n["weights"] for n in numbers] if per else None,
                           draws=[n["draws"] for n in numbers])
    _close("per-beat metrics", ss.last_metrics, jax_metrics, METRIC_RTOL)
    for k in METRIC_KEYS:
        _close(f"last beat {k}", out.metrics[k].item(), float(jout.metrics[k]), METRIC_RTOL)
    _assert_like_jax(learner, pool, rep, jl, jp, jr)
    if learner.guard_enabled:
        np.testing.assert_array_equal(ss.last_health, _np(jl._health_cur[0]))
        assert learner.poll_health() == jl.poll_health()


def test_per_beat_betas_match_jax():
    for total, beta, final in ((448, 0.4, 1.0), (10_000, 0.5, 0.9), (3, 0.4, 1.0)):
        jcfg, cfg = _configs(total_env_steps=total, per_beta=beta, per_beta_final=final)
        for budget in (0, 16, 100, 448, 9_999):
            for beats in (1, 4, 7):
                got = per_beat_betas(cfg, budget, beats, 16)
                want = jax_per_beat_betas(jcfg, budget, beats, 16)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)


def test_first_bad_beat_matches_the_jax_superstep():
    # Guarded steps 5 and 6 are the third beat's (K = 2 a beat).
    jcfg, cfg = _configs(guardrails=True, superstep_beats=4, faults="numeric:grad:nan@5")
    jl, jp, jr = _jax_stack(jcfg)
    learner, pool, rep = _port_from_jax(cfg, jl, jp, jr)
    jss, ss = JaxSuperstep(jcfg, jl, jp, jr), FusedSuperstep(cfg, learner, pool, rep)
    for expect in (2, -1):
        # Each beat's numbers from the JAX stack as it will stand: the
        # uniform draw's size and keys advance deterministically.
        numbers = []
        key, carry_key, size = jl._key, jp._carry.key, int(_np(jr.size))
        for _ in range(4):
            key, sub = jax.random.split(key)
            numbers.append(torch.from_numpy(np.array(jax.random.randint(
                sub, (jcfg.learner_chunk, jcfg.batch_size), 0, max(size, 1)))).long())
            draws = _rollout_draws(carry_key, jp.chunk_size, jp.num_envs)
            for _ in range(jp.chunk_size):
                carry_key = jax.random.split(carry_key, 4)[0]
            numbers[-1] = (numbers[-1], draws)
            size = min(size + jp.rows_per_chunk, jcfg.replay_capacity)
        jss.run_superstep()
        ss.run_superstep(idx=[n[0] for n in numbers], draws=[n[1] for n in numbers])
        h, jh = learner.poll_health(), jl.poll_health()
        assert h == jh and h["first_bad_beat"] == expect and h["nonfinite"] == 1
        np.testing.assert_array_equal(ss.last_health, _np(jl._health_cur[0]))
    _assert_like_jax(learner, pool, rep, jl, jp, jr)


def test_cli_verify_recipe_gives_the_jax_accounting(tmp_path):
    flags = ["--actor_backend=device", "--num_actors=0", "--device_actor_envs=8",
             "--device_actor_chunk=2", "--learner_chunk=2", "--batch_size=16",
             "--actor_hidden=16,16", "--critic_hidden=16,16", "--replay_capacity=2048",
             "--replay_min_size=64", "--total_env_steps=448", "--eval_every=0",
             "--eval_episodes=1", "--fused_chunk=off", "--fused_beat=on",
             "--superstep_beats=4"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    runs = {
        "port": subprocess.Popen([sys.executable, "-m", "distributed_ddpg_tpu_torch.train",
                                  "--device=cpu", *flags], cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        # JAX's own CLI (JAX_PLATFORMS is honoured by its main) on one CPU device.
        "jax": subprocess.Popen([sys.executable, "-m", "distributed_ddpg_tpu.train",
                                 "--backend=jax_tpu", *flags], cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE),
    }
    summaries = {}
    for name, proc in runs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
        summaries[name] = ast.literal_eval(out.strip().splitlines()[-1])
    keys = ("fused_beat_active", "fused_supersteps", "fused_beats", "learner_steps",
            "devactor_env_steps", "fused_superstep_beats")
    got = tuple(summaries["port"][k] for k in keys)
    assert got == tuple(summaries["jax"][k] for k in keys)
    assert got == (True, 6, 24, 48, 448, 4.0)
