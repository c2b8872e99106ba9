"""The port's vectorized envs (envs/vector_envs.py) against the JAX package's
envs/jax_envs.py, on the CPU.

- A Pendulum step over 64 envs against vmap(JaxPendulum.step): states
  with angles far outside [-pi, pi] (negative ones too), velocities past
  the clip, torques past the bound, step counters at and before the
  200-step limit, and the reset values JAX's step draws for every env
  (init of each env's key) passed in. State, obs, boot_obs, reward, done
  and terminated at rtol 1e-5, atol 1e-6 (f32 sin and cos in two
  libraries); the flags exactly.
- 420 steps of 8 envs driven by JAX's states (each step's input the JAX
  state, so the comparison is one step at a time): two auto-resets each,
  every step held as above.
- A MountainCar step over 64 envs against vmap(JaxMountainCar.step):
  positions at the left wall with negative velocity (the velocity zeroed
  after the clip), at and past the goal with either sign of velocity
  (terminated only with vel >= 0), step counters at the 999-step limit;
  the terminal reward +100, the reset where done.
- `_angle_normalize` is a floor-mod (torch.remainder), as jnp's `%`, at
  negative angles where torch.fmod would differ.
- has_vector_env / make_vector_env over the same four ids as JAX's
  _JAX_ENVS, the refusal with JAX's message; draw_reset on JAX's ranges.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.envs import jax_envs
from distributed_ddpg_tpu_torch.envs import vector_envs as ve

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(name, got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=name)


_JITTED = {}


def _jax_step(env, states, actions, key):
    """vmap(env.step) over E envs with one key each, and the reset values
    JAX drew for each (env.init of the same key)."""
    fn = _JITTED.get(type(env))
    if fn is None:
        def fn(states, actions, key):
            keys = jax.random.split(key, actions.shape[0])
            return jax.vmap(env.step)(states, actions, keys), jax.vmap(env.init)(keys)
        fn = _JITTED[type(env)] = jax.jit(fn)
    return fn(states, jnp.asarray(actions), key)


def _compare(out, jout, fields):
    for name in fields:
        _close(f"state.{name}", getattr(out.state, name).numpy(),
               np.asarray(getattr(jout.state, name)))
    _close("obs", out.obs.numpy(), np.asarray(jout.obs))
    _close("boot_obs", out.boot_obs.numpy(), np.asarray(jout.boot_obs))
    _close("reward", out.reward.numpy(), np.asarray(jout.reward))
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(jout.done))
    np.testing.assert_array_equal(out.terminated.numpy(),
                                  np.broadcast_to(np.asarray(jout.terminated), out.done.shape))


def _pendulum_state(jstate):
    return ve.PendulumState(th=torch.from_numpy(np.asarray(jstate.th).copy()),
                            thdot=torch.from_numpy(np.asarray(jstate.thdot).copy()),
                            t=torch.from_numpy(np.asarray(jstate.t).copy()))


def test_pendulum_step_matches_jax():
    E = 64
    rng = np.random.default_rng(0)
    jstate = jax_envs.PendulumState(
        th=jnp.asarray(rng.uniform(-12.0, 12.0, E).astype(np.float32)),
        thdot=jnp.asarray(rng.uniform(-9.0, 9.0, E).astype(np.float32)),
        t=jnp.asarray(rng.choice([0, 5, 198, 199], E).astype(np.int32)))
    actions = rng.uniform(-3.0, 3.0, (E, 1)).astype(np.float32)
    jout, fresh = _jax_step(jax_envs.JaxPendulum(), jstate, actions, jax.random.PRNGKey(1))
    env = ve.VectorPendulum(E, device="cpu")
    reset = torch.from_numpy(np.stack([np.asarray(fresh.th), np.asarray(fresh.thdot)], 1))
    out = env.step(_pendulum_state(jstate), torch.from_numpy(actions), reset)
    assert out.done.any() and not out.done.all()
    _compare(out, jout, ("th", "thdot", "t"))


def test_pendulum_rollout_with_auto_resets_matches_jax():
    E, T = 8, 420
    jenv, env = jax_envs.JaxPendulum(), ve.VectorPendulum(E, device="cpu")
    key = jax.random.PRNGKey(3)
    k0, key = jax.random.split(key)
    jstate = jax.vmap(jenv.init)(jax.random.split(k0, E))
    _close("init obs", env.observe(_pendulum_state(jstate)).numpy(),
           np.asarray(jax.vmap(jenv.observe)(jstate)))
    rng = np.random.default_rng(4)
    resets = 0
    for _ in range(T):
        key, k = jax.random.split(key)
        actions = rng.uniform(-2.5, 2.5, (E, 1)).astype(np.float32)
        jout, fresh = _jax_step(jenv, jstate, actions, k)
        reset = torch.from_numpy(np.stack([np.asarray(fresh.th), np.asarray(fresh.thdot)], 1))
        out = env.step(_pendulum_state(jstate), torch.from_numpy(actions), reset)
        _compare(out, jout, ("th", "thdot", "t"))
        resets += int(out.done.sum())
        jstate = jout.state
    assert resets == 2 * E


def test_mountain_car_step_matches_jax():
    E = 64
    rng = np.random.default_rng(1)
    pos = rng.choice([-1.2, -1.19, -0.5, 0.0, 0.44, 0.449, 0.45, 0.55, 0.6], E)
    vel = rng.choice([-0.07, -0.02, -0.001, 0.0, 0.001, 0.02, 0.07], E)
    jstate = jax_envs.MountainCarState(
        pos=jnp.asarray(pos.astype(np.float32)), vel=jnp.asarray(vel.astype(np.float32)),
        t=jnp.asarray(rng.choice([0, 500, 997, 998], E).astype(np.int32)))
    actions = rng.uniform(-1.5, 1.5, (E, 1)).astype(np.float32)
    jout, fresh = _jax_step(jax_envs.JaxMountainCar(), jstate, actions, jax.random.PRNGKey(2))
    env = ve.VectorMountainCar(E, device="cpu")
    state = ve.MountainCarState(*(torch.from_numpy(np.asarray(x).copy()) for x in jstate))
    out = env.step(state, torch.from_numpy(actions), torch.from_numpy(
        np.asarray(fresh.pos)[:, None].copy()))
    _compare(out, jout, ("pos", "vel", "t"))
    term = out.terminated.numpy()
    assert term.any() and (~term & out.done.numpy()).any()
    r = out.reward.numpy()
    assert np.all(r[term] > 99.0) and np.all(r[~term] <= 0.0)
    # At the left wall the velocity is zeroed after the position's clip.
    wall = np.asarray(jout.boot_obs)[:, 0] <= -1.2
    assert wall.any() and np.all(out.boot_obs.numpy()[wall, 1] >= 0.0)


def test_angle_normalize_is_a_floor_mod_at_negative_angles():
    x = torch.tensor([-7.0, -3.5, -math.pi - 0.1, -0.2, 0.0, 3.3, 9.9])
    got = ve._angle_normalize(x).numpy()
    want = np.asarray(jax_envs._angle_normalize(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all((got >= -math.pi - 1e-6) & (got < math.pi + 1e-6))
    fmod = (torch.fmod(x + math.pi, 2 * math.pi) - math.pi).numpy()
    assert not np.allclose(fmod, want, atol=1e-3)


def test_vector_env_ids_and_refusal_match_jax():
    assert set(ve._VECTOR_ENVS) == set(jax_envs._JAX_ENVS)
    for env_id, cls in jax_envs._JAX_ENVS.items():
        assert ve.has_vector_env(env_id) == jax_envs.has_jax_env(env_id)
        env = ve.make_vector_env(env_id, 3, device="cpu")
        assert (env.obs_dim, env.act_dim) == (cls.obs_dim, cls.act_dim)
        np.testing.assert_array_equal(env.action_low, cls.action_low)
        np.testing.assert_array_equal(env.action_high, cls.action_high)
    with pytest.raises(ValueError) as ours:
        ve.make_vector_env("HalfCheetah-v4", 2)
    with pytest.raises(ValueError) as theirs:
        jax_envs.make_jax_env("HalfCheetah-v4")
    assert str(ours.value) == str(theirs.value)


def test_draw_reset_on_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    p = ve.VectorPendulum(4096, device="cpu").draw_reset(gen).numpy()
    assert p.shape == (4096, 2)
    assert np.all(np.abs(p[:, 0]) <= math.pi) and np.all(np.abs(p[:, 1]) <= 1.0)
    assert p[:, 0].min() < -3.0 and p[:, 0].max() > 3.0
    m = ve.VectorMountainCar(4096, device="cpu").draw_reset(gen).numpy()
    assert m.shape == (4096, 1) and np.all((m >= -0.6) & (m <= -0.4))
