"""The port's D4PG path against the JAX package's, on the CPU at a small size
(obs 3, act 1, actor 32x32, critic 32x24x16, batch 8, K 4, support [-5, 5]).

- config: the D4PG fields' defaults, `auto` bounds and the JAX gates;
- the C51 support row against jnp.linspace, the weight bridge of a D4PG
  state (num_atoms-wide critic head);
- the projection (the scan path's floor/ceil form and the kernel's
  triangular form) and the losses against the JAX losses, with the edge
  cases: shifted atoms landing exactly on atoms, clipped at v_min and at
  v_max, terminal rows (disc = 0);
- K eager steps against K calls of the JAX make_learner_step;
- the plain chunk (fused_chunk_reference) against the JAX Pallas kernel's
  C51 branch in interpret mode (21 atoms, as the JAX suite's own case);
- the kernel's task table, run by the numpy interpreter of
  tests/test_torch_fused_chunk.py, against the plain chunk at 21 and 51
  atoms, its stages and its operation count;
- ops/support_auto.py against the JAX package's on the same rewards,
  DeviceReplay.reward_sample against the JAX replay's, and a chunk after
  ShardedLearner.set_value_bounds against a learner built with those
  bounds;
- a tiny --device=cpu D4PG run of the trainer with --v_min=auto, in a
  subprocess with a timeout (the actor pool never starts in this process).

The kernel against the plain chunk on a card (marker `cuda`) is in
tests/test_torch_on_card.py.

Tolerances: where the JAX kernel is compared, rtol 2e-4, atol 1e-5 and the
metrics 5e-4, the JAX suite's own C51 tolerances
(tests/test_fused_chunk.py:77); elsewhere rtol 2e-5, atol 1e-6 and the
chunk-mean metrics 5e-5, as in test_torch_core.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_step
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.ops import losses as jax_losses
from distributed_ddpg_tpu.ops import support_auto as jax_support_auto
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from distributed_ddpg_tpu_torch import types
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    make_learner_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.ops import losses, support_auto
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from test_torch_fused_chunk import _assert_stage_dependencies, _interpret_program
from test_torch_slice import train_in_subprocess

OBS, ACT, B, K = 3, 1, 8, 4
ACTOR, CRITIC = (32, 32), (32, 24, 16)
ATOMS, V_MIN, V_MAX = 21, -5.0, 5.0    # dz = 0.5: every atom exact in f32
SCALE, OFFSET = 2.0, 0.25
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
KERNEL_RTOL, KERNEL_ATOL, KERNEL_METRIC_RTOL = 2e-4, 1e-5, 5e-4
NAN = float("nan")


def _configs(atoms=ATOMS, v_min=V_MIN, v_max=V_MAX, **extra):
    common = dict(actor_hidden=ACTOR, critic_hidden=CRITIC, batch_size=B, seed=3,
                  distributional=True, num_atoms=atoms, v_min=v_min, v_max=v_max, **extra)
    return JaxConfig(**common), DDPGConfig(device="cpu", **common)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg):
    s = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    return s._replace(
        step=jnp.int32(5),
        actor_opt=s.actor_opt._replace(count=jnp.int32(5)),
        critic_opt=s.critic_opt._replace(count=jnp.int32(5)),
    )


def _batches(seed, k=K):
    """Random rows with some edge rows in every step: a terminal row
    (disc 0), rewards far below v_min and far above v_max."""
    rng = np.random.default_rng(seed)
    reward = rng.standard_normal((k, B)).astype(np.float32)
    discount = np.full((k, B), 0.99, np.float32)
    discount[:, 0] = 0.0
    reward[:, 1], reward[:, 2] = -40.0, 40.0
    return types.pack_batch_np({
        "obs": rng.standard_normal((k, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1.75, 2.25, (k, B, ACT)).astype(np.float32),
        "reward": reward,
        "discount": discount,
        "next_obs": rng.standard_normal((k, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (k, B)).astype(np.float32),
    })


def _assert_state_matches(state, ref, rtol=RTOL, atol=ATOL):
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for lp, lr in zip(getattr(state, group), getattr(ref, group)):
            for key in ("w", "b"):
                assert tuple(lp[key].shape) == lr[key].shape
                _close(lp[key].detach().numpy(), lr[key], rtol, atol)
    for opt in ("actor_opt", "critic_opt"):
        for tree in ("mu", "nu"):
            for lp, lr in zip(getattr(getattr(state, opt), tree),
                              getattr(getattr(ref, opt), tree)):
                for key in ("w", "b"):
                    _close(lp[key].detach().numpy(), lr[key], rtol, atol)
        assert int(getattr(state, opt).count) == int(getattr(ref, opt).count)
    assert int(state.step) == int(ref.step)


# --- config -----------------------------------------------------------------


def test_d4pg_config_defaults_and_auto_flags_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for name in ("distributional", "num_atoms", "v_min", "v_max", "n_step"):
        assert ours[name] == theirs[name]
    flags = ["--distributional=true", "--n_step=5", "--v_min=auto", "--v_max=auto"]
    cfg = DDPGConfig.from_flags(flags + ["--device=cpu"])
    jcfg = JaxConfig.from_flags(flags)
    assert math.isnan(cfg.v_min) and math.isnan(cfg.v_max) and cfg.v_support_auto
    assert jcfg.v_support_auto and cfg.n_step == jcfg.n_step == 5
    assert not DDPGConfig(device="cpu", distributional=True).v_support_auto
    assert fc.supported(cfg) and fc.supported(_configs(atoms=256)[1])
    assert DDPGConfig.from_flags(["--v_min=-3.5"]).v_min == -3.5


@pytest.mark.parametrize("override", [
    dict(v_min=NAN),
    dict(v_min=NAN, v_max=NAN),
    dict(distributional=True, v_min=NAN, v_max=NAN, gamma=1.0),
    dict(distributional=True, v_min=5.0, v_max=5.0),
    dict(distributional=True, v_min=6.0, v_max=-6.0),
    dict(distributional=True, twin_critic=True),
    dict(distributional=True, sac=True),
])
def test_d4pg_gates_match_jax(override):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**override)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**override)
    assert str(ours.value) == str(theirs.value)


def test_prioritized_still_raises_naming_the_option():
    with pytest.raises(ValueError, match="prioritized"):
        DDPGConfig.from_flags(["--distributional=true", "--n_step=5", "--v_min=auto",
                               "--v_max=auto", "--prioritized=true"])


# --- the support and the weight bridge -------------------------------------------


@pytest.mark.parametrize("v_min,v_max,atoms", [
    (-5.0, 5.0, 21), (-150.0, 150.0, 51), (-1633.2345, 235.71, 51), (-7.3, 11.9, 256),
])
def test_support_row_matches_jnp_linspace(v_min, v_max, atoms):
    """The port's row is the float64 linspace rounded once; the JAX
    package's f32 jnp.linspace (start * (1 - t) + stop * t in f32) lands
    within a few ulps of the bounds' magnitude of it, and both end exactly
    on the bounds."""
    ours = losses.support_row(v_min, v_max, atoms)
    theirs = np.asarray(jnp.linspace(v_min, v_max, atoms, dtype=jnp.float32))
    assert ours.dtype == np.float32 and ours.shape == (atoms,)
    assert ours[0] == np.float32(v_min) and ours[-1] == np.float32(v_max) == theirs[-1]
    ulp = np.spacing(np.float32(max(abs(v_min), abs(v_max))))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=4 * ulp)
    _, cfg = _configs(atoms, v_min, v_max)
    z, bounds = fc.support_params(cfg)
    np.testing.assert_array_equal(z, ours)
    assert bounds[2] == np.float32((v_max - v_min) / (atoms - 1))


def test_d4pg_state_round_trip():
    jcfg, cfg = _configs()
    ref = _np(_jax_state(jcfg))
    assert ref.critic_params[-1]["w"].shape == (CRITIC[-1], ATOMS)
    state = train_state_from_numpy(ref)
    back = train_state_to_numpy(state)
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    again = fc.unflatten_state(fc.flatten_state(state), state, 0, 0)
    for a, b in zip(jax.tree.leaves(train_state_to_numpy(again)), ref_leaves):
        np.testing.assert_array_equal(a, b)
    n_a = sum(v.size for layer in ref.actor_params for v in layer.values())
    n_c = sum(v.size for layer in ref.critic_params for v in layer.values())
    prog = fc._plan(cfg, OBS, ACT)
    assert (prog.n_actor, prog.n_critic) == (n_a, n_c)
    assert fc.state_bytes(cfg, OBS, ACT) == 16 * (n_a + n_c)


# --- projection and losses ----------------------------------------------------


PROJECTION_CASES = {
    "on_atoms": (0.5, 1.0),        # tz_i = z_(i+1): every point on an atom
    "same_atoms": (0.0, 1.0),      # tz = z
    "clip_low": (-40.0, 0.99),     # everything at v_min
    "clip_high": (40.0, 0.99),     # everything at v_max
    "terminal": (1.3, 0.0),        # disc 0: every point at r, between two atoms
    "terminal_on_atom": (1.5, 0.0),
    "random": (None, 0.99),
}


@pytest.mark.parametrize("case", list(PROJECTION_CASES))
def test_projection_matches_jax(case):
    """The port's scan-path projection against JAX's on the same support
    (exactly the same function), and the kernel's triangular form against
    both; every row of the projection sums to 1."""
    rew0, disc0 = PROJECTION_CASES[case]
    rng = np.random.default_rng(1)
    z = losses.support_row(V_MIN, V_MAX, ATOMS)
    logits = rng.standard_normal((B, ATOMS)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    rew = (rng.standard_normal(B) if rew0 is None else np.full(B, rew0)).astype(np.float32)
    disc = np.full(B, disc0, np.float32)
    theirs = np.asarray(jax_losses.categorical_projection(
        jnp.asarray(z), jnp.asarray(probs), jnp.asarray(rew), jnp.asarray(disc)))
    t = torch.from_numpy
    ours = losses.categorical_projection(t(z), t(probs), t(rew), t(disc)).numpy()
    tri = fc.c51_projection(t(probs), t(rew)[:, None], t(disc)[:, None], t(z),
                            V_MIN, V_MAX, (V_MAX - V_MIN) / (ATOMS - 1)).numpy()
    _close(ours, theirs)
    _close(tri, theirs)
    _close(tri.sum(-1), np.ones(B))
    if case == "clip_low":
        _close(tri[:, 0], np.ones(B))
    if case == "clip_high":
        _close(tri[:, -1], np.ones(B))
    if case == "same_atoms":
        _close(tri, probs)


def test_d4pg_losses_match_jax():
    jcfg, _ = _configs()
    jstate = _jax_state(jcfg)
    state = train_state_from_numpy(_np(jstate))
    packed = _batches(1, k=1)[0]
    jbatch = jax_types.unpack_batch(jnp.asarray(packed), OBS, ACT)
    batch = types.unpack_batch(torch.from_numpy(packed), OBS, ACT)
    z = losses.support_row(V_MIN, V_MAX, ATOMS)
    jloss, jtd = jax_losses.distributional_critic_loss(
        jstate.critic_params, jstate.target_actor_params, jstate.target_critic_params,
        jbatch, SCALE, jnp.asarray(z), action_offset=OFFSET)
    loss, td = losses.distributional_critic_loss(
        state.critic_params, state.target_actor_params, state.target_critic_params,
        batch, torch.tensor(SCALE), torch.from_numpy(z), torch.tensor(OFFSET))
    _close(float(loss), float(jloss))
    _close(td.detach().numpy(), np.asarray(jtd))
    _close(float(losses.distributional_actor_loss(
        state.actor_params, state.critic_params, batch, torch.tensor(SCALE),
        torch.from_numpy(z), torch.tensor(OFFSET))),
        float(jax_losses.distributional_actor_loss(
            jstate.actor_params, jstate.critic_params, jbatch, SCALE, jnp.asarray(z),
            action_offset=OFFSET)))


# --- the eager step, the plain chunk and the JAX kernel --------------------------


def test_eager_d4pg_steps_match_jax():
    jcfg, cfg = _configs()
    jstate = _jax_state(jcfg)
    packed = _batches(4)
    jstep = jax.jit(jax_step(jcfg, SCALE, action_offset=OFFSET))
    step = make_learner_step(cfg, SCALE, OFFSET)
    state = train_state_from_numpy(_np(jstate))
    for k in range(K):
        jout = jstep(jstate, jax_types.unpack_batch(jnp.asarray(packed[k]), OBS, ACT))
        jstate = jout.state
        out = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT))
        state = out.state
        _close(out.td_errors.numpy(), np.asarray(jout.td_errors))
        for name in METRIC_KEYS:
            _close(float(out.metrics[name]), float(jout.metrics[name]), METRIC_RTOL, ATOL)
    _assert_state_matches(state, _np(jstate))


@pytest.mark.parametrize("atoms", [ATOMS, 51])
def test_plain_d4pg_chunk_matches_eager_steps(atoms):
    """The plain chunk (the kernel's math: triangular projection, closed-
    form cotangents) against K eager autograd steps (floor/ceil projection,
    autograd), from a JAX-made state."""
    jcfg, cfg = _configs(atoms)
    state = train_state_from_numpy(_np(_jax_state(jcfg)))
    packed = _batches(5)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    new, td, met = run(state, torch.from_numpy(packed))
    step = make_learner_step(cfg, SCALE, OFFSET)
    s, tds, mets = state, [], []
    for k in range(K):
        out = step(s, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT))
        s = out.state
        tds.append(out.td_errors.numpy())
        mets.append(out.metrics)
    _assert_state_matches(new, train_state_to_numpy(s))
    _close(td.numpy(), np.stack(tds))
    for name in METRIC_KEYS:
        _close(float(met[name]), np.mean([float(m[name]) for m in mets]), METRIC_RTOL, ATOL)


def test_plain_d4pg_chunk_matches_jax_kernel():
    """The plain chunk against the JAX Pallas kernel's C51 branch itself,
    in interpret mode."""
    jcfg, cfg = _configs()
    jstate = _jax_state(jcfg)
    packed = _batches(8)
    run_jax = jax_fused_chunk.make_fused_chunk_fn(
        jcfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, interpret=True)
    jnew, jtd, jmet = jax.jit(run_jax)(jstate, jnp.asarray(packed))
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    new, td, met = run(train_state_from_numpy(_np(jstate)), torch.from_numpy(packed))
    _assert_state_matches(new, _np(jnew), KERNEL_RTOL, KERNEL_ATOL)
    _close(td.numpy(), np.asarray(jtd), KERNEL_RTOL, KERNEL_ATOL)
    for name in METRIC_KEYS:
        _close(float(met[name]), float(jmet[name]), KERNEL_METRIC_RTOL, KERNEL_ATOL)


# --- the kernel's program -------------------------------------------------------


@pytest.mark.parametrize("atoms", [ATOMS, 51])
def test_d4pg_program_matches_plain_chunk(atoms):
    jcfg, cfg = _configs(atoms)
    state = train_state_from_numpy(_np(_jax_state(jcfg)))
    packed = _batches(11)
    flat, td, met = _interpret_program(cfg, state, packed, SCALE, OFFSET, None, OBS, ACT)
    new, rtd, rmet = fc.fused_chunk_reference(cfg, state, torch.from_numpy(packed),
                                              SCALE, OFFSET)
    _close(flat, fc.flatten_state(new).numpy())
    _close(td, rtd.numpy())
    _close(met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(), METRIC_RTOL, ATOL)


def test_d4pg_program_stages():
    """Every read comes from an earlier stage; the two row tasks sit in one
    stage after the heads, one tile per ROWS_PER_TILE rows; the actor's
    backward starts after its row task, two stages later than DDPG's."""
    _, cfg = _configs()
    prog = fc._plan(cfg, OBS, ACT)
    ddpg = fc._plan(DDPGConfig(device="cpu", actor_hidden=ACTOR, critic_hidden=CRITIC,
                               batch_size=B), OBS, ACT)
    _assert_stage_dependencies(prog, B)
    assert len(prog.stage_tiles) == len(ddpg.stage_tiles) + 2
    rows = [(s, r) for s in range(len(prog.stage_tiles))
            for r in prog.tasks[prog.stage_start[s]:prog.stage_start[s + 1]]
            if r[fc.F_OP] == fc.OP_ROWS]
    assert sorted(int(r[fc.F_EPI]) for _, r in rows) == [fc.EPI_C51, fc.EPI_C51_PI]
    assert len({s for s, _ in rows}) == 1
    for _, r in rows:
        assert (r[fc.F_M], r[fc.F_N], r[fc.F_NSEG]) == (B, ATOMS, 0)
        assert r[fc.F_TILES_M] * fc.ROWS_PER_TILE >= B and r[fc.F_TILES_N] == 1
    assert not any(r[fc.F_EPI] == fc.EPI_TD for r in prog.tasks)
    assert prog.stage_tiles_skip == prog.stage_tiles
    assert prog.n_critic == ddpg.n_critic + (ATOMS - 1) * (CRITIC[-1] + 1)


def test_d4pg_operation_count():
    """The heads' products are num_atoms wide; the row tasks add the
    softmaxes and the projection of each row, at the O(A) work the
    floor/ceil form needs (not the kernel's A x A triangular form)."""
    _, cfg = _configs()
    dcfg = DDPGConfig(device="cpu", actor_hidden=ACTOR, critic_hidden=CRITIC, batch_size=B)
    prog, ddpg = fc._plan(cfg, OBS, ACT), fc._plan(dcfg, OBS, ACT)
    head_in = CRITIC[-1]
    # The head's forward (3 paths), its weight and bias gradient, and the
    # input gradient of the critic and the actor pass grow with A.
    extra = (3 * 2 * B * head_in + 2 * B * head_in + 2 * B + 2 * 2 * B * head_in) * (ATOMS - 1)
    assert prog.matmul_flops + prog.actor_bwd_flops - (
        ddpg.matmul_flops + ddpg.actor_bwd_flops) == extra
    assert prog.row_ops == B * ATOMS * (
        fc.C51_PROJ_ATOM_OPS + fc.C51_CRITIC_ATOM_OPS + fc.C51_ACTOR_ATOM_OPS)
    assert ddpg.row_ops == 0
    assert fc.ops_per_chunk(cfg, OBS, ACT, K) == K * (
        prog.matmul_flops + prog.actor_bwd_flops + prog.row_ops
        + (fc.ADAM_OPS_PER_PARAM + fc.POLYAK_OPS_PER_PARAM) * (prog.n_actor + prog.n_critic))


# --- auto support, reward_sample, set_value_bounds --------------------------------


def _reward_sets():
    rng = np.random.default_rng(0)
    pendulum = rng.uniform(-16.3, 0.0, 5000)
    lander = rng.normal(-1.0, 2.0, 5000)
    lander[::97] = rng.choice([-100.0, 100.0], size=len(lander[::97]))
    lander_disc = np.where(np.abs(lander) == 100.0, 0.0, 0.99)
    return {
        "pendulum": (pendulum, None, 1),
        "pendulum_nstep": (pendulum * 4.9, np.full(5000, 0.99 ** 5), 5),
        "sparse_terminal": (lander, lander_disc, 1),
        "all_terminal": (rng.normal(0.0, 1.0, 300), np.zeros(300), 1),
        "degenerate": (np.zeros(100), None, 1),
    }


@pytest.mark.parametrize("name", list(_reward_sets()))
def test_support_auto_matches_jax(name):
    rewards, discounts, n_step = _reward_sets()[name]
    ours = support_auto.initial_bounds(rewards, 0.99, n_step, discounts=discounts)
    theirs = jax_support_auto.initial_bounds(rewards, 0.99, n_step, discounts=discounts)
    assert ours == theirs
    lo, hi = ours
    data = (lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo))
    for mean_q in np.linspace(lo - 10.0, hi + 10.0, 41).tolist() + [NAN, 0.0]:
        for since in (None, 10, 5000):
            for fn in (None, lambda: data, lambda: (lo, hi)):
                assert support_auto.maybe_expand(lo, hi, mean_q, since, fn) == \
                    jax_support_auto.maybe_expand(lo, hi, mean_q, since, fn)
    # A controller fed the same sequence decides the same, refusals included.
    ours_c, theirs_c = support_auto.SupportController(), jax_support_auto.SupportController()
    qs = np.random.default_rng(1).uniform(lo - 1.0, hi + 1.0, 60)
    for i, q in enumerate(qs):
        fn = (lambda: data) if i % 3 else (lambda: (lo, hi))
        assert ours_c.check(lo, hi, float(q), 700 * i, fn) == \
            theirs_c.check(lo, hi, float(q), 700 * i, fn)
    assert ours_c.refusals == theirs_c.refusals


def _rows(rng, n):
    rows = rng.standard_normal((n, 2 * OBS + ACT + 3)).astype(np.float32)
    rows[:, OBS + ACT + 1] = np.where(rng.uniform(size=n) < 0.1, 0.0, 0.99)
    return rows


def test_reward_sample_matches_jax():
    """The same inserts into both replays (full blocks shipped, a few rows
    left staged): the (reward, discount) columns of the filled rows, then
    the staged ones; and an even stride once the ring holds more than
    max_n."""
    rng = np.random.default_rng(0)
    ours = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    theirs = JaxDeviceReplay(64, OBS, ACT, block_size=16)
    for n in (20, 30, 25):
        rows = _rows(rng, n)
        ours.add_packed(rows)
        theirs.add_packed(rows)
    assert ours.pending_rows == theirs.pending_rows == 11
    for max_n in (100_000, 20):
        r, d = ours.reward_sample(max_n)
        jr, jd = theirs.reward_sample(max_n)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(d, jd)
    assert len(ours.reward_sample()[0]) == len(ours) + ours.pending_rows
    assert support_auto.replay_data_bounds(ours, 0.99, 3) == \
        jax_support_auto.replay_data_bounds(theirs, 0.99, 3)


def test_set_value_bounds_matches_a_fresh_learner():
    """A chunk after set_value_bounds equals the chunk of a learner built
    with those bounds; an unresolved 'auto' support raises."""
    _, cfg = _configs()
    rng = np.random.default_rng(2)
    replay = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    replay.add_packed(_rows(rng, 64))
    idx = torch.from_numpy(rng.integers(0, 64, (K, B)))
    start = train_state_from_numpy(_np(_jax_state(_configs()[0])))
    moved = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, state=start)
    moved.set_value_bounds(-8.0, 3.0)
    fresh = ShardedLearner(cfg.replace(v_min=-8.0, v_max=3.0), OBS, ACT, SCALE, OFFSET,
                           chunk_size=K, state=start)
    a, b = moved.run_sample_chunk(replay, idx=idx), fresh.run_sample_chunk(replay, idx=idx)
    assert (moved.config.v_min, moved.config.v_max) == (-8.0, 3.0)
    np.testing.assert_array_equal(a.td_errors.numpy(), b.td_errors.numpy())
    np.testing.assert_array_equal(fc.flatten_state(moved.state).numpy(),
                                  fc.flatten_state(fresh.state).numpy())
    old = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, state=start)
    assert not np.array_equal(old.run_sample_chunk(replay, idx=idx).td_errors.numpy(),
                              a.td_errors.numpy())
    auto = ShardedLearner(cfg.replace(v_min=NAN, v_max=NAN), OBS, ACT, SCALE, OFFSET,
                          chunk_size=K, state=start)
    with pytest.raises(ValueError, match="auto"):
        auto.run_sample_chunk(replay, idx=idx)
    auto.set_value_bounds(-8.0, 3.0)
    np.testing.assert_array_equal(auto.run_sample_chunk(replay, idx=idx).td_errors.numpy(),
                                  a.td_errors.numpy())
    ddpg = fc.make_fused_chunk_fn(DDPGConfig(device="cpu", batch_size=B), OBS, ACT, SCALE,
                                  device="cpu")
    with pytest.raises(ValueError, match="distributional"):
        ddpg.set_value_bounds(-1.0, 1.0)


# --- the training loop ------------------------------------------------------------


def test_tiny_d4pg_train_run_with_auto_support(tmp_path):
    """README's D4PG command at a tiny size on the CPU, in a subprocess:
    the support resolved from the warmup rewards before the first chunk,
    kept on every later record, finite metrics."""
    records = train_in_subprocess([
        "--distributional=true", "--n_step=5", "--v_min=auto", "--v_max=auto",
        "--actor_hidden=16,16", "--critic_hidden=16,16", "--batch_size=16",
        "--learner_chunk=4", "--replay_min_size=200", "--total_env_steps=600",
        "--eval_every=0", "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")
    support = [r for r in records if r["kind"] == "support"]
    assert [r["reason"] for r in support] == ["warmup"]
    lo, hi = support[0]["v_min"], support[0]["v_max"]
    assert math.isfinite(lo) and math.isfinite(hi) and lo < -100.0 < 0.0 < hi
    first_train = records.index(next(r for r in records if r["kind"] == "train"))
    assert records.index(support[0]) < first_train
    final = records[-1]
    assert final["kind"] == "final" and final["chunks"] >= 1
    assert (final["v_min"], final["v_max"], final["support_refusals"]) == (lo, hi, 0)
    assert all(math.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))
