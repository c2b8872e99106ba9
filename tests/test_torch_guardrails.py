"""The port's numerical-health guardrails against the JAX package's, on the
CPU at a small size (obs 3, act 1, nets 8x8, batch 16), on
tests/test_guardrails.py's cases and the same numpy inputs.

- The guarded step (guardrails.make_guarded_step) against JAX's, from the
  same GuardState (guard_state_from_numpy) and TrainState: on healthy
  rows, a NaN batch, an Inf reward, a z-score spike after the EWMA's
  warmup, a pre_bad flag, and an injected numeric:grad:nan ordinal that
  fires once on the monotonic clock. Skip flags, counters and the health
  word exactly; the EWMA, the state, td and the metrics at
  tests/test_torch_slice.py's rtol 2e-5, atol 1e-6.
- batch_row_health with more than 32 bad rows: the same pre_bad, count and
  32 indices in the same order as JAX's top_k; the host-fed path's -1s.
- The numeric fault grammar parsed and rejected as JAX's; every other
  component refused by the port.
- Guarded-on healthy equals guarded-off bit for bit on the port's scan
  route, uniform and PER, DDPG, TD3, D4PG, SAC and DDPG with K2 (the state,
  td and, under PER, the priorities); the disabled path has no probe.
- Bad rows attributed to their source through the learner and the replay,
  reset_guard keeping the cumulative counters and the clock, reseed, and
  PER's (0 + eps)^alpha for a bad step's rows.
- set_lr_scale composed with set_value_bounds, in either order, bit for
  bit against a step built on the scaled rates and the new support.
- checkpoint.discard_above against JAX's; the pool's quarantine_source and
  its breaker (backoff, crash-loop quarantine, the probe); sources_of
  through coalesced ships on the shipper and the scheduler, a padded flush
  and a failed ship, against JAX's track_sources.
- The config fields and checks against JAX's.
- Three CLI drills in child processes: a rollback that finishes its budget
  (exit 0, a restored step below the first injected one, the newer
  checkpoints renamed diverged_step_N), an abort (exit 77, no checkpoint
  after it) and a poisoned row's source quarantined.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import checkpoint as jax_ckpt
from distributed_ddpg_tpu import guardrails as jax_guard
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.faults import FaultPlan as JaxFaultPlan
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_make_step
from distributed_ddpg_tpu.metrics import GuardrailStats as JaxGuardrailStats
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from distributed_ddpg_tpu.types import Batch as JaxBatch
from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch import guardrails
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
from distributed_ddpg_tpu_torch.exits import EXIT_NUMERIC
from distributed_ddpg_tpu_torch.faults import FaultPlan
from distributed_ddpg_tpu_torch.learner import (
    init_train_state,
    make_learner_step,
    train_state_from_numpy,
)
from distributed_ddpg_tpu_torch.metrics import GuardrailStats
from distributed_ddpg_tpu_torch.parallel.learner import (
    ShardedLearner,
    make_scan_chunk_fn,
    state_tensors,
)
from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
from distributed_ddpg_tpu_torch.transfer import TransferScheduler
from distributed_ddpg_tpu_torch.types import Batch, packed_width
from test_torch_slice import REPO

torch.set_num_threads(1)

OBS, ACT, B = 3, 1, 16
RTOL, ATOL = 2e-5, 1e-6                            # tests/test_torch_slice.py


def _cfgs(**kw):
    common = dict(actor_hidden=(8, 8), critic_hidden=(8, 8), batch_size=B, **kw)
    return JaxConfig(**common), DDPGConfig(device="cpu", **common)


def _batch(rng, reward_scale=1.0, poison_obs=False, poison_reward=None):
    """tests/test_guardrails.py's _batch, as numpy fields."""
    obs = rng.standard_normal((B, OBS)).astype(np.float32)
    if poison_obs:
        obs[0, 0] = np.nan
    reward = (reward_scale * rng.standard_normal(B)).astype(np.float32)
    if poison_reward is not None:
        reward[0] = poison_reward
    return dict(obs=obs, action=rng.standard_normal((B, ACT)).astype(np.float32),
                reward=reward, discount=np.full((B,), 0.99, np.float32),
                next_obs=rng.standard_normal((B, OBS)).astype(np.float32),
                weight=np.ones((B,), np.float32))


def _jax_batch(f):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in f.items()})


def _port_batch(f):
    return Batch(**{k: torch.from_numpy(v.copy()) for k, v in f.items()})


def _close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _compare(state, g, td, m, jstate, jg, jtd, jm):
    for name in guardrails.GuardState._fields:
        got, want = getattr(g, name), np.asarray(getattr(jg, name))
        if name in guardrails._INT_FIELDS:
            assert int(got) == int(want), name
        else:
            _close(name, got.numpy(), want)
    assert (guardrails.health_vector(g).tolist()
            == np.asarray(jax_guard.health_vector(jg)).tolist())
    jstate = jax.tree.map(np.asarray, jstate)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (lp, lr) in enumerate(zip(getattr(state, group), getattr(jstate, group))):
            for key in ("w", "b"):
                _close(f"{group}[{i}].{key}", lp[key].numpy(), lr[key])
    for opt in ("actor_opt", "critic_opt"):
        assert int(getattr(state, opt).count) == int(getattr(jstate, opt).count)
        for lp, lr in zip(getattr(state, opt).mu, getattr(jstate, opt).mu):
            _close(f"{opt}.mu", lp["w"].numpy(), lr["w"])
    assert int(state.step) == int(jstate.step)
    _close("td", td.numpy(), np.asarray(jtd))
    for k, v in jm.items():
        _close(k, m[k].numpy(), np.asarray(v))


# --- the guarded step against JAX's -----------------------------------------

STEP_CASES = {
    # name: (zmax, warmup, inject, [batch kwargs or "pre_bad" per step])
    "healthy_then_nan_then_inf": (8.0, 64, None, [{}, dict(poison_obs=True),
                                                  dict(poison_reward=np.inf), {}]),
    "zscore_spike": (6.0, 8, None, [{}] * 12 + [dict(reward_scale=1e6), {}]),
    "pre_bad": (8.0, 64, None, ["pre_bad", {}]),
    "inject_grad_nan_at_3": (8.0, 64, {"grad": (3,)}, [{}] * 5),
    "inject_loss_spike_at_10": (6.0, 4, {"loss": (10,)}, [{}] * 12),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_guarded_step_matches_jax(case):
    zmax, warmup, inject, plan = STEP_CASES[case]
    jcfg, cfg = _cfgs()
    jguarded = jax_guard.make_guarded_step(jax_make_step(jcfg, 1.0), zmax, warmup, inject)
    guarded = guardrails.make_guarded_step(make_learner_step(cfg, 1.0), zmax, warmup, inject)
    jstate = jax_init(jcfg, OBS, ACT, seed=0)
    jg = jax_guard.init_guard_state()
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    g = guardrails.guard_state_from_numpy(jax.tree.map(np.asarray, jg))
    rng = np.random.default_rng(0)
    skipped = []
    for kw in plan:
        pre_bad = kw == "pre_bad"
        fields = _batch(rng, **({} if pre_bad else kw))
        before = int(g.skipped)
        jstate, jg, jtd, jm = jguarded(jstate, jg, _jax_batch(fields), jnp.asarray(pre_bad))
        state, g, td, m = guarded(state, g, _port_batch(fields), torch.tensor(pre_bad))
        _compare(state, g, td, m, jstate, jg, jtd, jm)
        skipped.append(int(g.skipped) > before)
    want = {
        "healthy_then_nan_then_inf": [False, True, True, False],
        "zscore_spike": [False] * 12 + [True, False],
        "pre_bad": [True, False],
        "inject_grad_nan_at_3": [False, False, True, False, False],
        "inject_loss_spike_at_10": [False] * 9 + [True, False, False],
    }[case]
    assert skipped == want
    if case == "zscore_spike":
        assert int(g.spikes) == 1 and int(g.nonfinite) == 0
    if case == "inject_loss_spike_at_10":
        assert int(g.spikes) == 1


def test_zscore_lockout_at_a_data_shift_matches_jax():
    """The z-score detector at JAX's default zmax 8 over a data shift, as
    the main path meets one at a chunk boundary: 160 steps drawn from a
    fixed pool of 48 rows (the EWMA's variance shrinks as the critic fits
    them), then 40 from a pool of fresh rows whose critic loss jumps far
    above the band. Every step after the shift is a spike, and since a
    spike never updates the EWMA, the band stays where it was: the lock-out
    behind the guarded main path's skips, whose count depends on how many
    new rows the actors land between chunks (PERF.md section 7). The
    port's skip flags equal JAX's step for step, on the same batches from
    the same state; its EWMA within rtol 1e-4."""
    jcfg, cfg = _cfgs()
    jguarded = jax.jit(jax_guard.make_guarded_step(jax_make_step(jcfg, 1.0), 8.0, 64))
    guarded = guardrails.make_guarded_step(make_learner_step(cfg, 1.0), 8.0, 64)
    jstate = jax_init(jcfg, OBS, ACT, seed=0)
    jg = jax_guard.init_guard_state()
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    g = guardrails.guard_state_from_numpy(jax.tree.map(np.asarray, jg))
    rng = np.random.default_rng(5)
    old = _batch(np.random.default_rng(6)), _batch(np.random.default_rng(7)), \
        _batch(np.random.default_rng(8))
    jskips, skips = [], []
    for i in range(200):
        if i < 160:
            pool = old[i % 3]
            idx = rng.permutation(B)
            fields = {k: v[idx] for k, v in pool.items()}
        else:
            fields = _batch(rng, reward_scale=4.0)
        before, jbefore = int(g.spikes), int(jg.spikes)
        jstate, jg, _, _ = jguarded(jstate, jg, _jax_batch(fields), jnp.asarray(False))
        state, g, _, _ = guarded(state, g, _port_batch(fields), torch.tensor(False))
        jskips.append(int(jg.spikes) > jbefore)
        skips.append(int(g.spikes) > before)
    assert skips == jskips
    assert not any(skips[:160]) and all(skips[160:])
    for name in ("loss_mean", "loss_var", "gnorm_mean", "gnorm_var"):
        np.testing.assert_allclose(float(getattr(g, name)), float(np.asarray(getattr(jg, name))),
                                   rtol=1e-4, err_msg=name)


def test_injection_does_not_refire_on_a_preserved_clock():
    """Rollback keeps the clock: a step-keyed fault never fires again."""
    _, cfg = _cfgs()
    guarded = guardrails.make_guarded_step(make_learner_step(cfg, 1.0), 8.0, 64,
                                           {"grad": (3,)})
    state = init_train_state(cfg, OBS, ACT, 0)
    g = guardrails.init_guard_state(total=3)
    rng = np.random.default_rng(3)
    for _ in range(3):
        state, g, _, _ = guarded(state, g, _port_batch(_batch(rng)), torch.tensor(False))
    assert int(g.skipped) == 0 and int(g.total) == 6


def test_batch_row_health_matches_jax_past_32_bad_rows():
    rng = np.random.default_rng(4)
    packed = rng.standard_normal((6, 16, 8)).astype(np.float32)
    bad = rng.random((6, 16)) < 0.45
    cols = rng.integers(0, 8, (6, 16))
    packed[bad, cols[bad]] = np.where(rng.random(bad.sum()) < 0.5, np.nan, np.inf)
    assert bad.sum() > guardrails.GUARD_BAD_IDX
    idx = rng.integers(0, 100_000, (6, 16)).astype(np.int32)
    for ids in (idx, None):
        want = jax_guard.batch_row_health(jnp.asarray(packed),
                                          None if ids is None else jnp.asarray(ids))
        got = guardrails.batch_row_health(torch.from_numpy(packed),
                                          None if ids is None else torch.from_numpy(ids))
        for a, b in zip(got, want):
            assert a.numpy().tolist() == np.asarray(b).tolist()
    # Fewer bad rows than slots: the rest pads with -1, as JAX's.
    few = np.zeros((2, 4, 8), np.float32)
    few[1, 2, 3] = np.inf
    got = guardrails.batch_row_health(torch.from_numpy(few), torch.arange(8).view(2, 4))
    assert got[2].tolist() == [6] + [-1] * (guardrails.GUARD_BAD_IDX - 1)


# --- the numeric grammar ----------------------------------------------------


def test_numeric_fault_grammar_parses_as_jax():
    spec = "numeric:grad:nan@500;numeric:loss:spike@7;numeric:replay:inf@42;numeric:grad:nan@3"
    plan, jplan = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    assert plan.numeric_steps() == jplan.numeric_steps() == {"grad": (3, 500), "loss": (7,)}
    assert plan.numeric_replay_rows() == jplan.numeric_replay_rows() == (42,)
    assert not FaultPlan.parse("") and FaultPlan.parse("numeric:loss:spike@1~0.5")


@pytest.mark.parametrize("spec", ["numeric:grad:inf@5", "numeric:loss:nan@5",
                                  "numeric:params:nan@5", "numeric:grad:crash@5",
                                  "numeric:grad:nan@0", "numeric:grad:nan@x",
                                  "numeric:nan@3"])
def test_numeric_fault_grammar_rejects_as_jax(spec):
    with pytest.raises(ValueError, match="numeric"):
        JaxFaultPlan.parse(spec)
    with pytest.raises(ValueError, match="numeric"):
        FaultPlan.parse(spec)


@pytest.mark.parametrize("spec", ["pod:1:kill@5", "pod:0:exit@3:77",
                                  "slice:0:corrupt@1", "pod:1:hang@2~1.5"])
def test_other_fault_components_are_refused(spec):
    """The JAX grammar takes them all; the port refuses `slice` (the data-plane
    half of ROADMAP.md Queue 1 item 10) and parses `pod` as JAX does."""
    theirs = JaxFaultPlan.parse(spec)
    if spec.startswith("slice"):
        with pytest.raises(ValueError, match="not in this slice"):
            FaultPlan.parse(spec)
        with pytest.raises(ValueError, match="item 10"):
            DDPGConfig(faults=spec)
    else:
        assert [s.describe() for s in FaultPlan.parse(spec).specs] == \
            [s.describe() for s in theirs.specs]
        assert DDPGConfig(faults=spec).fault_plan().pod_site(int(spec.split(":")[1]))


# --- the guarded chunk on the port's learner ------------------------------------

FAMILIES = {
    "ddpg": {},
    "ddpg-k2": dict(fused_update=True),
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=11, v_min=-10.0, v_max=10.0),
    "sac": dict(sac=True),
}


def _learner(guard, per=False, chunk=4, fill_seed=0, **kw):
    cfg = DDPGConfig(device="cpu", actor_hidden=(8, 8), critic_hidden=(8, 8), batch_size=B,
                     guardrails=guard, prioritized=per, fused_chunk="off", **kw)
    learner = ShardedLearner(cfg, OBS, ACT, np.ones(1, np.float32), chunk_size=chunk)
    cls = DevicePrioritizedReplay if per else DeviceReplay
    rep = cls(1000, OBS, ACT, "cpu", block_size=64, track_sources=guard)
    rng = np.random.default_rng(fill_seed)
    rep.add_packed(rng.standard_normal((256, rep.width)).astype(np.float32), source=1)
    rep.drain_pending()
    return learner, rep


def _chunks(learner, rep, per, n=4):
    tds = []
    for _ in range(n):
        out = learner.run_sample_chunk_per(rep, 0.5) if per else learner.run_sample_chunk(rep)
        tds.append(out.td_errors)
    return tds


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_guarded_healthy_equals_unguarded_bit_for_bit(family, per):
    runs = []
    for guard in (False, True):
        learner, rep = _learner(guard, per, **FAMILIES[family])
        assert learner.route(per) == "scan"
        tds = _chunks(learner, rep, per)
        held = state_tensors(learner.state) + tds
        if per:
            held += [rep.priorities, rep.max_priority]
        runs.append(held)
        if guard:
            assert learner.poll_health() == dict(total=16, nonfinite=0, spikes=0, skipped=0,
                                                 bad_rows=0)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_disabled_path_has_no_probe_surface():
    learner, rep = _learner(False)
    assert not learner.guard_enabled and not hasattr(learner, "_guard")
    learner.run_sample_chunk(rep)
    assert learner.poll_health() is None and len(learner.bad_indices()) == 0


def test_guardrails_take_the_scan_route():
    cfg = DDPGConfig(device="cpu", actor_hidden=(8, 8), critic_hidden=(8, 8), batch_size=B,
                     guardrails=True)
    learner = ShardedLearner(cfg, OBS, ACT, np.ones(1, np.float32), chunk_size=4)
    assert learner.route() == learner.route(per=True) == "scan"
    assert not learner.fused_chunk_active
    # Unguarded, the same config takes the kernel route.
    assert ShardedLearner(cfg.replace(guardrails=False), OBS, ACT, np.ones(1, np.float32),
                          chunk_size=4).route() == "kernel"


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_bad_rows_attribution_reset_clock_and_reseed(per):
    learner, rep = _learner(True, per)
    rng = np.random.default_rng(9)
    bad = rng.standard_normal((64, rep.width)).astype(np.float32)
    bad[:, OBS + ACT] = np.inf   # the reward column
    rep.add_packed(bad, source=3)
    rep.drain_pending()
    saw_bad_step = False
    for _ in range(4):
        out = learner.run_sample_chunk_per(rep, 0.5) if per else learner.run_sample_chunk(rep)
        if per:
            bad_steps = (out.td_errors == 0).all(dim=1)
            saw_bad_step |= bool(bad_steps.any())
    h = learner.poll_health()
    assert h["bad_rows"] > 0 and h["skipped"] > 0
    idx = learner.bad_indices()
    assert 0 < len(idx) <= guardrails.GUARD_BAD_IDX
    assert set(int(s) for s in rep.sources_of(idx)) == {3}
    assert (~np.isfinite(rep.storage[torch.from_numpy(idx)].numpy())).any(axis=1).all()
    if per:
        # A bad step's zeroed td stamps its rows at (0 + eps)^alpha.
        assert saw_bad_step
        floor = np.float32(rep.eps) ** np.float32(rep.alpha)
        assert np.isclose(rep.priorities.numpy(), floor, rtol=1e-6).any()
    learner.reset_guard()
    assert learner.poll_health() is None
    learner.run_sample_chunk_per(rep, 0.5) if per else learner.run_sample_chunk(rep)
    after = learner.poll_health()
    assert after["skipped"] >= h["skipped"] and after["total"] == 20
    assert after["bad_rows"] >= h["bad_rows"]
    seed = learner._gen.initial_seed()
    learner.reseed(7)
    assert learner._gen.initial_seed() != seed


def test_health_counters_delta_as_jax():
    """GuardrailStats.absorb and snapshot against JAX's on one sequence."""
    ours, theirs = GuardrailStats(), JaxGuardrailStats()
    seq = [dict(total=4, nonfinite=0, spikes=0, skipped=0, bad_rows=0),
           dict(total=8, nonfinite=2, spikes=1, skipped=3, bad_rows=5),
           dict(total=12, nonfinite=2, spikes=3, skipped=5, bad_rows=5)]
    for h in seq:
        assert ours.absorb(h) == theirs.absorb(h)
    for s in (ours, theirs):
        s.record_rollback(40)
        s.record_lr_cooldown()
        s.record_source_quarantine()
    assert ours.snapshot() == theirs.snapshot()


# --- set_lr_scale and set_value_bounds ------------------------------------------


@pytest.mark.parametrize("order", ["lr_first", "bounds_first"])
@pytest.mark.parametrize("k2", [False, True], ids=["autograd", "k2"])
def test_lr_scale_composes_with_value_bounds(order, k2):
    cfg = DDPGConfig(device="cpu", actor_hidden=(8, 8), critic_hidden=(8, 8), batch_size=B,
                     distributional=True, num_atoms=11, v_min=-10.0, v_max=10.0,
                     fused_chunk="off", guardrails=True, fused_update=k2)
    learner = ShardedLearner(cfg, OBS, ACT, np.ones(1, np.float32), chunk_size=4)
    if order == "lr_first":
        learner.set_lr_scale(0.25)
        learner.set_value_bounds(-30.0, 5.0)
    else:
        learner.set_value_bounds(-30.0, 5.0)
        learner.set_lr_scale(0.25)
    assert learner.lr_scale == 0.25
    rng = np.random.default_rng(2)
    packed = rng.standard_normal((4, B, packed_width(OBS, ACT))).astype(np.float32)
    packed[..., -1] = 1.0
    state = learner.state
    out = learner.run_chunk({
        "obs": packed[..., :OBS], "action": packed[..., OBS:OBS + ACT],
        "reward": packed[..., OBS + ACT], "discount": packed[..., OBS + ACT + 1],
        "next_obs": packed[..., OBS + ACT + 2:-1]})
    want_cfg = cfg.replace(v_min=-30.0, v_max=5.0, actor_lr=cfg.actor_lr * 0.25,
                           critic_lr=cfg.critic_lr * 0.25, guardrails=False)
    scan = make_scan_chunk_fn(want_cfg, OBS, ACT, np.ones(1, np.float32), chunk_size=4)
    want_state, want_td, _ = scan(state, torch.from_numpy(packed), None, step0=0)
    assert torch.equal(out.td_errors, want_td)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(out.state),
                                                  state_tensors(want_state)))
    # Back to 1.0: the support stays where set_value_bounds put it.
    learner.set_lr_scale(1.0)
    assert learner.config.v_min == -30.0 and learner.lr_scale == 1.0


def test_lr_scale_refused_on_the_kernel_route():
    cfg = DDPGConfig(device="cpu", actor_hidden=(8, 8), critic_hidden=(8, 8), batch_size=B)
    learner = ShardedLearner(cfg, OBS, ACT, np.ones(1, np.float32), chunk_size=4)
    with pytest.raises(ValueError, match="scan route"):
        learner.set_lr_scale(0.5)


# --- checkpoint, pool and replay pieces --------------------------------------------


def _names(d):
    return sorted(os.listdir(d))


def test_discard_above_matches_jax(tmp_path):
    _, cfg = _cfgs()
    state = init_train_state(cfg, OBS, ACT, 0)
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        for step in (10, 20, 30):
            ckpt.save(str(d), step, state, None, cfg, keep=0)
    got = ckpt.discard_above(str(dirs[0]), 10)
    want = jax_ckpt.discard_above(str(dirs[1]), 10)
    assert got == want == [20, 30]
    assert _names(dirs[0]) == _names(dirs[1])
    assert ckpt.latest_step(str(dirs[0])) == 10 and ckpt.valid_steps(str(dirs[0])) == [10]
    for s in (20, 30):
        assert (dirs[0] / f"diverged_step_{s}").is_dir()
        assert not (dirs[0] / f"manifest_{s}.json").exists()
    assert ckpt.discard_above(str(dirs[0]), 10) == []
    assert ckpt.discard_above(str(tmp_path / "none"), 0) == []


def _spec():
    return EnvSpec(obs_dim=OBS, act_dim=ACT, action_low=np.full(ACT, -1.0, np.float32),
                   action_high=np.full(ACT, 1.0, np.float32))


def test_pool_quarantine_source_direct():
    pool = ActorPool(DDPGConfig(device="cpu", num_actors=2, transport="queue"), _spec())
    assert pool.quarantine_source(0, why="numeric")
    assert pool.quarantined_count == 1
    assert not pool.quarantine_source(0), "double-quarantine must no-op"
    assert not pool.quarantine_source(99), "bad slot id must no-op"
    assert pool.recovery_counters() == {"actor_respawns": 0, "actor_quarantined": 1,
                                        "actor_unquarantined": 0}


def _stub_pool(monkeypatch, **cfg_kw):
    """An ActorPool whose _spawn never forks (tests/test_faults.py's stub):
    every respawn fails again, so the breaker's states can be driven."""
    pool = ActorPool(DDPGConfig(device="cpu", num_actors=1, transport="queue", **cfg_kw),
                     _spec())
    spawned = []

    def fake_spawn(i):
        spawned.append(i)
        pool._heartbeat[i] = 0.0
        pool._procs[i] = None

    monkeypatch.setattr(pool, "_spawn", fake_spawn)
    return pool, spawned


def test_monitor_backoff_then_quarantine(monkeypatch):
    pool, spawned = _stub_pool(monkeypatch, respawn_backoff_s=0.05, respawn_backoff_max_s=0.2,
                               quarantine_respawns=3, quarantine_window_s=60.0)
    stats = pool.monitor()
    assert stats["respawned"] == 0 and pool._pending_respawn[0]
    time.sleep(0.06)
    assert pool.monitor()["respawned"] == 1 and spawned == [0]
    time.sleep(0.01)
    pool.monitor()                       # failure 2
    time.sleep(0.25)
    assert pool.monitor()["respawned"] == 1
    assert pool.monitor()["quarantined"] == 1   # failure 3 trips the breaker
    assert pool.recovery_counters() == {"actor_respawns": 2, "actor_quarantined": 1,
                                        "actor_unquarantined": 0}
    time.sleep(0.25)
    assert pool.monitor()["respawned"] == 0 and spawned == [0, 0]


def test_monitor_quarantine_probe_recovers_slot(monkeypatch):
    pool, spawned = _stub_pool(monkeypatch, respawn_backoff_s=0.0, quarantine_respawns=2,
                               quarantine_window_s=0.05, quarantine_probe_s=0.1)
    for _ in range(3):
        pool.monitor()
    assert pool.quarantined_count == 1
    n = len(spawned)
    time.sleep(0.12)
    assert pool.monitor()["respawned"] == 1 and len(spawned) == n + 1   # the probe

    class _Alive:
        def is_alive(self):
            return True

    pool._procs[0] = _Alive()
    pool._heartbeat[0] = time.time()
    pool._rows_seen_t[0] = time.time() + 0.01
    time.sleep(0.06)
    pool._heartbeat[0] = time.time()
    pool.monitor()
    assert pool.quarantined_count == 0
    assert pool.recovery_counters()["actor_unquarantined"] == 1


OBS4, ACT2, CAP, BLOCK = 4, 2, 512, 32
SOURCED = [(1, 30), (2, 70), (0, 64), (3, 5), (1, 200), (2, 33), (0, 128), (3, 400)]


def _sourced_inflow():
    rng = np.random.default_rng(5)
    w = packed_width(OBS4, ACT2)
    return [(s, rng.standard_normal((n, w)).astype(np.float32)) for s, n in SOURCED]


@pytest.mark.parametrize("route", ["inline", "shipper", "scheduler"])
def test_sources_of_through_coalesced_ships_matches_jax(route):
    sched = TransferScheduler().start() if route == "scheduler" else None
    kw = dict(max_coalesce=4, staging_blocks=8, track_sources=True)
    if route != "inline":
        kw.update(async_ship=True)
    try:
        ours = DeviceReplay(CAP, OBS4, ACT2, "cpu", block_size=BLOCK, scheduler=sched,
                            host_pool=sched is not None, **kw)
        theirs = JaxDeviceReplay(CAP, OBS4, ACT2, block_size=BLOCK, max_coalesce=4,
                                 staging_blocks=8, track_sources=True)
        for s, rows in _sourced_inflow():
            ours.add_packed(rows, source=s)
            theirs.add_packed(rows, source=s)
        ours.drain_pending()
        theirs.drain_pending()
        ours.flush()
        theirs.flush()
        every = np.arange(CAP)
        assert ours.sources_of(every).tolist() == theirs.sources_of(every).tolist()
        assert ours.ingest_snapshot()["ingest_coalesce_mean"] > 1.0
        assert len(set(ours.sources_of(every).tolist())) >= 2
        ours.close()
        theirs.close()
    finally:
        if sched is not None:
            sched.close()


def test_sources_of_after_a_failed_ship_and_a_restore():
    """A failed ship loses its rows and their tags together (the shipper's
    bounded restart); a restore leaves its rows untagged and the staged
    rows' tags in place."""
    class _FailOnce(DeviceReplay):
        failed = False

        def _ship(self, rows):
            if not self.failed and len(rows) > BLOCK:
                type(self).failed = True
                raise OSError("injected ship failure")
            super()._ship(rows)

    rep = _FailOnce(CAP, OBS4, ACT2, "cpu", block_size=BLOCK, async_ship=True, max_coalesce=4,
                    staging_blocks=8, track_sources=True)
    w = packed_width(OBS4, ACT2)
    try:
        rep.add_packed(np.zeros((4 * BLOCK, w), np.float32), source=5)   # lost
        deadline = time.time() + 10
        while rep._shipper.exc is None and time.time() < deadline:
            time.sleep(0.01)
        rep.add_packed(np.ones((2 * BLOCK, w), np.float32), source=6)    # restarts it
        rep.drain_pending()
        assert rep.ingest_snapshot()["ingest_shipper_restarts"] == 1
        assert rep.size == 2 * BLOCK
        assert rep.sources_of(np.arange(2 * BLOCK)).tolist() == [6] * (2 * BLOCK)
        assert (rep.storage[:2 * BLOCK] == 1.0).all()
        state = rep.state_dict()
        rep.add_packed(np.ones((BLOCK // 2, w), np.float32), source=7)   # staged only
        rep.load_state_dict(state)
        assert (rep.sources_of(np.arange(CAP)) == -1).all()
        rep.flush()
        assert rep.sources_of(np.arange(2 * BLOCK, 3 * BLOCK)).tolist() == [7] * BLOCK
    finally:
        rep.close()


def test_sources_untracked_is_minus_one():
    rep = DeviceReplay(CAP, OBS4, ACT2, "cpu", block_size=BLOCK)
    rep.add_packed(np.zeros((BLOCK, packed_width(OBS4, ACT2)), np.float32), source=2)
    assert (rep.sources_of([0, 5, CAP + 3]) == -1).all()


# --- the config ---------------------------------------------------------------

NEW_FIELDS = ("guardrails", "guardrail_zmax", "guardrail_warmup_steps", "guardrail_rollback_k",
              "guardrail_rollback_window", "guardrail_max_rollbacks", "guardrail_lr_backoff",
              "guardrail_lr_cooldown_steps", "guardrail_source_offenses",
              "quarantine_respawns", "quarantine_window_s", "quarantine_probe_s",
              "respawn_backoff_s", "respawn_backoff_max_s", "faults")


def test_config_fields_have_the_jax_names_and_defaults():
    ours, theirs = DDPGConfig(), JaxConfig()
    for name in NEW_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    cfg = DDPGConfig.from_flags(["--guardrails=true", "--guardrail_zmax=4.5",
                                 "--faults=numeric:grad:nan@9", "--quarantine_probe_s=0"])
    assert cfg.guardrails and cfg.guardrail_zmax == 4.5 and cfg.quarantine_probe_s == 0.0
    assert cfg.fault_plan().numeric_steps() == {"grad": (9,)}


@pytest.mark.parametrize("bad", [
    dict(guardrails=True, fused_chunk="on"), dict(guardrail_lr_backoff=0.0),
    dict(guardrail_lr_backoff=1.5), dict(guardrail_zmax=-1.0),
    dict(guardrail_warmup_steps=0), dict(guardrail_rollback_k=-1),
    dict(guardrail_rollback_window=0), dict(guardrail_max_rollbacks=-1),
    dict(guardrail_lr_cooldown_steps=0), dict(guardrail_source_offenses=-1),
    dict(quarantine_respawns=-1), dict(quarantine_window_s=0.0),
    dict(quarantine_probe_s=-1.0), dict(respawn_backoff_s=-1.0),
])
def test_config_checks_refuse_as_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as err:
        DDPGConfig(**bad)
    assert str(err.value) == str(jax_err.value)


def test_guardrails_refused_on_more_than_one_rank():
    with pytest.raises(ValueError, match="not in this slice"):
        DDPGConfig(guardrails=True, data_axis=2)
    DDPGConfig(guardrails=True, data_axis=1)
    DDPGConfig(guardrails=True)   # -1: the whole group, checked by the learner


# --- the CLI drills ----------------------------------------------------------------

DRILL = ["--device=cpu", "--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
         "--batch_size=16", "--learner_chunk=8", "--replay_min_size=200", "--eval_every=0",
         "--eval_episodes=1", "--guardrails=true", "--max_learn_ratio=1.0",
         "--max_ingest_ratio=1.0"]


def _drill(flags, timeout=180):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "distributed_ddpg_tpu_torch.train", *DRILL,
                          *flags], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    final = [json.loads(line) for line in res.stdout.splitlines()
             if line.startswith('{"kind": "final"')]
    return res, (final[-1] if final else None)


# The rollback and abort drills hold the non-finite path: --guardrail_zmax=1000
# keeps the z-score detector, which skips healthy steps at its default of 8
# now and then, from moving the rollback or the abort to another chunk.


def test_cli_rollback_drill_restores_before_the_divergence_and_finishes(tmp_path):
    ck = tmp_path / "ck"
    res, final = _drill(["--fused_update=true", "--total_env_steps=1000",
                         f"--checkpoint_dir={ck}", "--checkpoint_every=8",
                         "--checkpoint_keep=8", "--guardrail_rollback_k=2",
                         "--guardrail_zmax=1000",
                         "--faults=numeric:grad:nan@300;numeric:grad:nan@330"])
    assert res.returncode == 0, res.stderr[-4000:]
    assert final["guardrail_rollbacks"] >= 1 and final["guardrail_nonfinite_steps"] >= 2
    restored = final["guardrail_last_rollback_step"]
    assert 0 < restored < 300
    assert final["step"] >= 1000 and math.isfinite(final["final_return"])
    assert all(math.isfinite(final[k]) for k in ("critic_loss", "actor_loss"))
    diverged = sorted(int(p.name.split("_")[-1]) for p in ck.iterdir()
                      if p.name.startswith("diverged_step_"))
    assert diverged and min(diverged) > restored
    assert "ROLLBACK #1" in res.stderr
    step = ckpt.latest_step(str(ck))
    assert ckpt.verify_checkpoint(str(ck), step)[0]


def test_cli_abort_drill_exits_77_without_a_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    res, final = _drill(["--total_env_steps=100000", f"--checkpoint_dir={ck}",
                         "--checkpoint_every=8", "--guardrail_rollback_k=1",
                         "--guardrail_max_rollbacks=0", "--guardrail_zmax=1000",
                         "--faults=numeric:grad:nan@50"])
    assert res.returncode == EXIT_NUMERIC == 77, res.stderr[-4000:]
    assert "NUMERIC ABORT" in res.stderr
    aborted_at = final["learner_steps"]
    assert final["guardrail_rollbacks"] == 0 and final["final_return"] is None
    assert aborted_at < 5000
    # The abort wrote nothing: every checkpoint is from before the chunk of
    # the injected step.
    steps = [int(p.name.split("_")[1]) for p in ck.iterdir() if p.name.startswith("step_")]
    assert steps and max(steps) < 50 <= aborted_at


def test_cli_poison_drill_quarantines_the_source():
    res, final = _drill(["--num_actors=2", "--total_env_steps=2500",
                         "--guardrail_rollback_k=0", "--guardrail_source_offenses=1",
                         "--faults=numeric:replay:inf@300"])
    assert res.returncode == 0, res.stderr[-4000:]
    poisoned = re.search(r"poisoned ingested row 300 \(reward=\+inf\) from actor (\d)",
                         res.stderr)
    quarantined = re.findall(r"QUARANTINED worker (\d) \(numeric\)", res.stderr)
    assert poisoned and quarantined == [poisoned.group(1)]
    assert final["guardrail_bad_rows"] >= 1 and final["guardrail_source_quarantines"] >= 1
    assert final["actor_quarantined"] == 1 and final["learner_steps"] > 0
