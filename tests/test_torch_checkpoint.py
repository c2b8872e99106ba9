"""Checkpoint and resume of the port against the JAX package, on the CPU at
a small size (obs 3, act 2, nets 32x32, batch 16, K 4, replay capacity
512 in blocks of 64).

- The state: for DDPG, TD3, D4PG with auto bounds and PER, and SAC with
  its temperature learned, a JAX checkpoint written by the JAX save and
  read back by the JAX restore (orbax: the loader lives here, never in the
  port), converted, then saved and restored by the port: every leaf, the
  replay's keys, v_bounds and env_steps bit-identical to what JAX
  restored.
- The format: each package's verify_checkpoint accepts the other's
  checkpoints and rejects the same truncated payload; the JAX
  check_config_compatible reads the port's config_<N>.json and raises on
  the same fields as the port's.
- Retention: the same save sequences through both modules (old steps
  pruned at keep 3, keep 0 keeps all, stale steps above pruned) leave the
  same step_*, manifest_* and config_* names.
- Retries (a JAX FaultPlan site ticked by the port's writer) consumed and
  exhausted; AsyncSaver's snapshot isolation and its retry count.
- A resumed chunk: a learner restored from a port checkpoint runs the next
  chunk bit for bit as the uninterrupted learner does (TD3 on both routes,
  DDPG with K2, D4PG and SAC with PER), and that chunk agrees with JAX's
  learner restored from the same state, given the same rows and noise, at
  tests/fused_parity_util.py's DDPG tier (rtol 2e-5, atol 1e-6, metrics
  5e-5).
- Through the CLI, in child processes with a timeout: a corrupt newest
  checkpoint falls back (corrupt_step_N); SIGTERM exits 75 with a
  checkpoint that both packages verify; a D4PG auto resume keeps its
  bounds; a SAC resume keeps log_alpha and alpha_opt; two gloo ranks under
  torchrun resume the same step with bit-identical replicas. A resumed
  pool's uniform-warmup budget is the JAX pool's.
"""

import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import checkpoint as jax_ckpt
from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.faults import FaultPlan
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPerReplay
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxReplay
from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of
from distributed_ddpg_tpu_torch.exits import EXIT_PREEMPTED
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    train_state_from_numpy,
    train_state_to_flat,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
from distributed_ddpg_tpu_torch.types import pack_batch_np

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K, STEP0 = 3, 2, 16, 4, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, BLOCK, FILL = 512, 64, 384
BETA = 0.55
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/fused_parity_util.py, DDPG tier
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {
    "ddpg": dict(),
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-10.0, v_max=10.0),
    "d4pg-auto-per": dict(distributional=True, num_atoms=21, v_min=float("nan"),
                          v_max=float("nan"), prioritized=True),
    "sac": dict(sac=True),
}


def _configs(over):
    common = {**dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     replay_capacity=CAP), **over}
    jax_only = {k: v for k, v in common.items() if k != "fused_chunk"}
    return JaxConfig(fused_chunk="off", **jax_only), DDPGConfig(device="cpu", **common)


def _one_device():
    return jax_mesh.make_mesh(1, 1, devices=jax.devices()[:1])


def _mid_training(jcfg):
    """The JAX initial state at step STEP0 with nonzero Adam moments and
    offset counts (and SAC's temperature moved), as numpy."""
    s = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    rng = np.random.default_rng(STEP0)

    def moments(opt, count):
        return opt._replace(
            mu=jax.tree.map(lambda x: jnp.asarray(
                1e-3 * rng.standard_normal(x.shape), jnp.float32), opt.mu),
            nu=jax.tree.map(lambda x: jnp.asarray(
                rng.uniform(1e-6, 1e-4, x.shape), jnp.float32), opt.nu),
            count=jnp.int32(count))

    s = s._replace(step=jnp.int32(STEP0), actor_opt=moments(s.actor_opt, STEP0 + 2),
                   critic_opt=moments(s.critic_opt, STEP0 + 4))
    if jcfg.sac:
        s = s._replace(log_alpha=jnp.float32(math.log(0.3)),
                       alpha_opt=s.alpha_opt._replace(
                           mu=jnp.float32(0.01), nu=jnp.float32(2e-4),
                           count=jnp.int32(STEP0 - 3)))
    return jax.tree.map(np.asarray, s)


def _rows(n, seed):
    """Packed replay rows as the actors write them (weight column 1)."""
    rng = np.random.default_rng(seed)
    return pack_batch_np({
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "action": rng.uniform(-2, 2, (n, ACT)).astype(np.float32),
        "reward": (3.0 * rng.standard_normal(n)).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
        "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
    })


def _priorities(seed):
    p = np.zeros(CAP, np.float32)
    p[:FILL] = np.random.default_rng(seed).uniform(0.1, 2.0, FILL).astype(np.float32)
    return p


def _port_replay(cfg, fill=True):
    if cfg.prioritized:
        rep = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK,
                                      alpha=cfg.per_alpha, eps=cfg.per_eps)
    else:
        rep = DeviceReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK)
    if fill:
        rep.add_packed(_rows(FILL, 5))
        if cfg.prioritized:
            rep.set_per_state(torch.from_numpy(_priorities(6)), torch.tensor(1.5))
    return rep


def _jax_flat(js):
    """A JAX TrainState's leaves keyed by the port's paths (state.npz)."""
    out = {}

    def params(prefix, tree):
        for i, layer in enumerate(tree):
            for k in ("w", "b"):
                out[f"{prefix}/{i}/{k}"] = np.asarray(layer[k])

    for field in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        params(field, getattr(js, field))
    for field in ("actor_opt", "critic_opt"):
        opt = getattr(js, field)
        params(f"{field}/mu", opt.mu)
        params(f"{field}/nu", opt.nu)
        out[f"{field}/count"] = np.asarray(opt.count)
    out["step"] = np.asarray(js.step)
    if js.log_alpha is not None:
        out["log_alpha"] = np.asarray(js.log_alpha)
    if js.alpha_opt is not None:
        for k in ("mu", "nu", "count"):
            out[f"alpha_opt/{k}"] = np.asarray(getattr(js.alpha_opt, k))
    return out


def _to_jax(state):
    """The port's TrainState as a JAX TrainState of numpy leaves."""
    n = train_state_to_numpy(state)

    def opt(o):
        return None if o is None else jax_types.OptState(mu=o.mu, nu=o.nu, count=o.count)

    return jax_types.TrainState(
        actor_params=n.actor_params, critic_params=n.critic_params,
        target_actor_params=n.target_actor_params,
        target_critic_params=n.target_critic_params,
        actor_opt=opt(n.actor_opt), critic_opt=opt(n.critic_opt), step=n.step,
        log_alpha=n.log_alpha, alpha_opt=opt(n.alpha_opt))


def _assert_flat_identical(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- the state: bit-identical to what the JAX package restores ------------------------


@pytest.mark.parametrize("family", ["ddpg", "td3", "d4pg-auto-per", "sac"])
def test_state_round_trip_matches_jax_restore(family, tmp_path):
    jcfg, cfg = _configs(FAMILIES[family])
    jstate = _mid_training(jcfg)
    jrep_cls = JaxPerReplay if cfg.prioritized else JaxReplay
    jrep = jrep_cls(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK)
    jrep.add_packed(_rows(FILL, 5))
    bounds = (-1384.25, 125.5) if cfg.v_support_auto else None
    if cfg.prioritized:
        jrep.set_per_state(jnp.asarray(_priorities(6)), jnp.float32(2.25))
    jax_ckpt.save(str(tmp_path / "jax"), 40, jstate, jrep, jcfg, env_steps=1234,
                  v_bounds=bounds)
    jfresh = jrep_cls(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK)
    jmeta = {}
    jrestored, jstep, jenv = jax_ckpt.restore(
        str(tmp_path / "jax"), jax_init(jcfg, OBS, ACT, seed=9), jfresh, config=jcfg,
        meta_out=jmeta)
    jrestored = jax.tree.map(np.asarray, jrestored)
    jreplay = jfresh.state_dict()

    # The port takes JAX's restored state and replay, saves, restores.
    rep = _port_replay(cfg, fill=False)
    rep.load_state_dict(jreplay)
    ckpt.save(str(tmp_path / "port"), jstep, train_state_from_numpy(jrestored), rep, cfg,
              env_steps=jenv, v_bounds=jmeta.get("v_bounds"))
    fresh = _port_replay(cfg, fill=False)
    meta = {}
    state, step, env = ckpt.restore(str(tmp_path / "port"),
                                    init_train_state(cfg, OBS, ACT, seed=9), fresh,
                                    config=cfg, meta_out=meta)
    assert (step, env) == (jstep, jenv) == (40, 1234)
    _assert_flat_identical(train_state_to_flat(state), _jax_flat(jrestored))
    got = fresh.state_dict()
    assert set(got) == set(jreplay)
    for key in jreplay:
        assert got[key].dtype == jreplay[key].dtype, key
        np.testing.assert_array_equal(got[key], jreplay[key], err_msg=key)
    assert meta.get("v_bounds") == jmeta.get("v_bounds") == bounds
    if cfg.prioritized:
        assert float(fresh.max_priority) == 2.25


# --- the format ------------------------------------------------------------------------


def _truncate_largest(root):
    target = max((os.path.join(d, n) for d, _, ns in os.walk(root) for n in ns),
                 key=os.path.getsize)
    with open(target, "r+b") as f:
        f.truncate(max(os.path.getsize(target) // 2, 1))
    return os.path.relpath(target, root)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_verifies_the_others_checkpoints(writer, tmp_path):
    jcfg, cfg = _configs({})
    d = str(tmp_path)
    if writer == "port":
        rep = _port_replay(cfg)
        ckpt.save(d, 8, train_state_from_numpy(_mid_training(jcfg)), rep, cfg)
    else:
        jrep = JaxReplay(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK)
        jrep.add_packed(_rows(FILL, 5))
        jax_ckpt.save(d, 8, _mid_training(jcfg), jrep, jcfg)
    assert ckpt.verify_checkpoint(d, 8) == jax_ckpt.verify_checkpoint(d, 8) == (True, "ok")
    assert ckpt.valid_steps(d) == jax_ckpt.valid_steps(d) == [8]
    rel = _truncate_largest(os.path.join(d, "step_8"))
    ok, why = ckpt.verify_checkpoint(d, 8)
    assert not ok and why.startswith(f"size mismatch {rel}")
    assert jax_ckpt.verify_checkpoint(d, 8) == (ok, why)
    assert ckpt.valid_steps(d) == jax_ckpt.valid_steps(d) == []


@pytest.mark.parametrize("change, want", [
    (dict(), None), (dict(actor_hidden=(16, 16)), ["actor_hidden"]),
    (dict(v_min=-5.0, v_max=5.0), ["v_max", "v_min"]),
    (dict(prioritized=True, n_step=3, seed=4), ["n_step", "prioritized"]),
])
def test_config_check_reads_the_same_as_jax(change, want, tmp_path):
    """The port's config_<N>.json under each package's check: the same
    verdict, naming the same fields (an auto support as null and nan)."""
    base = dict(distributional=True, v_min=float("nan"), v_max=float("nan"))
    _, cfg = _configs(base)
    ckpt.save(str(tmp_path), 3, init_train_state(cfg, OBS, ACT, seed=0), None, cfg)
    saved = json.loads((tmp_path / "config_3.json").read_text())
    assert saved["v_min"] is None and saved["actor_hidden"] == list(HIDDEN)
    jcfg2, cfg2 = _configs({**base, **change})
    verdicts = []
    for check, c in ((ckpt.check_config_compatible, cfg2),
                     (jax_ckpt.check_config_compatible, jcfg2)):
        try:
            check(str(tmp_path), 3, c)
            verdicts.append(None)
        except ValueError as e:
            verdicts.append(sorted(re.findall(r"^  (\w+):", str(e), re.M)))
    assert verdicts == [want, want]


# --- retention, retries, the async saver -----------------------------------------------


def _names(d):
    return sorted(n for n in os.listdir(d) if n.startswith(("step_", "manifest_", "config_")))


@pytest.mark.parametrize("sequence", [
    [(10, 3), (20, 3), (30, 3), (40, 3), (50, 3), (60, 0)],
    [(100_000, 0), (110_000, 0), (120_000, 0), (10_000, 3), (20_000, 3), (30_000, 3)],
])
def test_retention_leaves_the_same_names_as_jax(sequence, tmp_path):
    jcfg, cfg = _configs({})
    jstate = _mid_training(jcfg)
    state = train_state_from_numpy(jstate)
    for step, keep in sequence:
        jax_ckpt.save(str(tmp_path / "jax"), step, jstate, None, jcfg, keep=keep)
        ckpt.save(str(tmp_path / "port"), step, state, None, cfg, keep=keep)
        assert _names(tmp_path / "port") == _names(tmp_path / "jax")
    assert ckpt.latest_step(str(tmp_path / "port")) == sequence[-1][0]


def test_write_retry_consumes_an_injected_ioerror(tmp_path):
    cfg = _configs({})[1]
    state = init_train_state(cfg, OBS, ACT, seed=0)
    site = FaultPlan.parse("ckpt:write:ioerror@1").site("ckpt", "write")
    path = ckpt.save(str(tmp_path), 5, state, None, cfg, retries=2, backoff_s=0.01,
                     fault=site)
    assert os.path.isdir(path) and ckpt.verify_checkpoint(str(tmp_path), 5)[0]
    assert site.calls == 2
    saver = ckpt.AsyncSaver()
    site = FaultPlan.parse("ckpt:write:ioerror@1").site("ckpt", "write")
    assert saver.save_async(str(tmp_path), 7, state, None, cfg, retries=2, backoff_s=0.01,
                            fault=site)
    saver.wait()
    assert saver.write_retries == 1 and ckpt.latest_step(str(tmp_path)) == 7


def test_write_retries_exhausted_raise_and_leave_nothing(tmp_path):
    cfg = _configs({})[1]
    site = FaultPlan.parse("ckpt:write:ioerror@1;ckpt:write:ioerror@2;ckpt:write:ioerror@3"
                           ).site("ckpt", "write")
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 5, init_train_state(cfg, OBS, ACT, seed=0), None, cfg,
                  retries=2, backoff_s=0.01, fault=site)
    assert site.calls == 3
    assert not [n for n in os.listdir(tmp_path) if n.startswith("step_5")]
    saver = ckpt.AsyncSaver()
    site = FaultPlan.parse("ckpt:write:ioerror@1").site("ckpt", "write")
    saver.save_async(str(tmp_path), 6, init_train_state(cfg, OBS, ACT, seed=0), None, cfg,
                     fault=site)
    with pytest.raises(OSError):
        saver.wait()


def test_async_saver_snapshots_at_call_time(tmp_path):
    """Changes to the state and the replay after save_async returns do not
    reach the checkpoint; a save while the writer is busy is skipped."""
    cfg = _configs(dict(prioritized=True))[1]
    state = init_train_state(cfg, OBS, ACT, seed=0)
    rep = _port_replay(cfg)
    want_state = train_state_to_flat(state)
    want_replay = rep.state_dict()
    saver = ckpt.AsyncSaver()
    gate = FaultPlan.parse("ckpt:write:slow@1~0.5").site("ckpt", "write")
    assert saver.save_async(str(tmp_path), 3, state, rep, cfg, fault=gate) is True
    state.actor_params[0]["w"].add_(1.0)
    state.critic_opt.count.add_(7)
    rep.storage.mul_(-1.0)
    rep.priorities.fill_(9.0)
    rep.max_priority.fill_(9.0)
    assert saver.save_async(str(tmp_path), 4, state, rep, cfg) is False
    saver.wait()
    assert saver.skipped == 1 and ckpt.latest_step(str(tmp_path)) == 3
    fresh = _port_replay(cfg, fill=False)
    restored, _, _ = ckpt.restore(str(tmp_path), init_train_state(cfg, OBS, ACT, seed=1),
                                  fresh)
    _assert_flat_identical(train_state_to_flat(restored), want_state)
    for key, want in want_replay.items():
        np.testing.assert_array_equal(fresh.state_dict()[key], want, err_msg=key)


def test_per_restore_writes_into_the_tensors_the_replay_holds():
    """load_state_dict keeps the priority vector and max priority tensors
    (whatever read them reads the restored values) and zeroes the slots
    past the restored size."""
    cfg = _configs(dict(prioritized=True))[1]
    src = _port_replay(cfg)
    dst = _port_replay(cfg, fill=False)
    dst.priorities.fill_(5.0)
    held = dst.per_state()
    dst.load_state_dict(src.state_dict())
    assert dst.per_state()[2] is held[2] and dst.per_state()[3] is held[3]
    assert torch.equal(dst.priorities, src.priorities) and float(dst.max_priority) == 1.5


# --- a resumed chunk ------------------------------------------------------------------

RESUME_CASES = {
    "td3-kernel": dict(FAMILIES["td3"], fused_chunk="on"),
    "td3-scan": dict(FAMILIES["td3"], fused_chunk="off"),
    "ddpg-scan-fused_update": dict(fused_update=True),
    "d4pg-kernel-per": dict(FAMILIES["d4pg"], prioritized=True, fused_chunk="on"),
    "sac-scan-per": dict(sac=True, prioritized=True, fused_chunk="off"),
}


def _chunk(learner, rep, idx, weights, eps=None):
    if rep.__class__ is DevicePrioritizedReplay:
        return learner.run_sample_chunk_per(rep, BETA, idx=idx, weights=weights, eps=eps)
    return learner.run_sample_chunk(rep, idx=idx, eps=eps)


def _result(learner, rep, out):
    held = state_tensors(learner.state) + [out.td_errors, *out.metrics.values()]
    if isinstance(rep, DevicePrioritizedReplay):
        held += [rep.priorities, rep.max_priority]
    return [t.clone() for t in held]


def _jax_noise(jcfg, step):
    if jcfg.sac:
        return tuple(torch.from_numpy(np.array(e)) for e in jax_fused_chunk.sac_noise_eps(
            jcfg, jnp.int32(step), K, B, ACT))
    if jcfg.twin_critic and jcfg.target_noise > 0:
        return torch.from_numpy(np.array(
            jax_fused_chunk.td3_noise_eps(jcfg, jnp.int32(step), K, B, ACT)))
    return None


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resumed_chunk_is_the_uninterrupted_one_and_jaxs(name, tmp_path):
    jcfg, cfg = _configs(RESUME_CASES[name])
    d = str(tmp_path)
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K,
                             state=train_state_from_numpy(_mid_training(jcfg)))
    assert learner.fused_chunk_active is (cfg.fused_chunk == "on")
    rep = _port_replay(cfg)
    _chunk(learner, rep, None, None)             # a chunk on the learner's own draws
    step = STEP0 + K
    ckpt.save(d, step, learner.state, rep, cfg, env_steps=700)
    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, FILL, (K, B)))
    weights = torch.from_numpy(rng.uniform(0.5, 1.0, (K, B)).astype(np.float32))
    want = _result(learner, rep, _chunk(learner, rep, idx, weights))

    # A fresh learner and replay, restored, run the same chunk: the same
    # bits (its TD3 noise or SAC normals drawn from the restored step).
    fresh = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    frep = _port_replay(cfg, fill=False)
    state, got_step, env = ckpt.restore(d, fresh.state, frep, config=cfg)
    fresh.load_state(state)
    assert (got_step, env, fresh._step) == (step, 700, step)
    got = _result(fresh, frep, _chunk(fresh, frep, idx, weights))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"tensor {i} of the resumed chunk differs"

    # JAX's learner restored from the same state (its own checkpoint of
    # it), fed the same rows and its own noise for this step.
    jax_ckpt.save(str(tmp_path / "jax"), step, _to_jax(state), None, jcfg)
    jstate, _, _ = jax_ckpt.restore(str(tmp_path / "jax"), jax_init(jcfg, OBS, ACT, seed=1))
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_one_device(), chunk_size=K,
                    unroll=1)
    jl.state = jax.device_put(jax.tree.map(np.asarray, jstate), jl._state_sharding)
    eps = _jax_noise(jcfg, step)
    port = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    prep = _port_replay(cfg, fill=False)
    port.load_state(ckpt.restore(d, port.state, prep)[0])
    out = _chunk(port, prep, idx, weights, eps)
    packed = prep.storage[idx].numpy()
    if cfg.prioritized:
        packed[..., -1] = weights.numpy()
    o, a = OBS, ACT
    jout = jl.run_chunk({
        "obs": packed[..., :o], "action": packed[..., o:o + a],
        "reward": packed[..., o + a], "discount": packed[..., o + a + 1],
        "next_obs": packed[..., o + a + 2:2 * o + a + 2], "weight": packed[..., -1]})
    jflat = _jax_flat(jax.tree.map(np.asarray, jout.state))
    for key, value in train_state_to_flat(port.state).items():
        np.testing.assert_allclose(value, jflat[key], rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(out.td_errors.numpy(), np.asarray(jout.td_errors), rtol=RTOL,
                               atol=ATOL)
    for key in METRIC_KEYS:
        np.testing.assert_allclose(float(out.metrics[key]), float(jout.metrics[key]),
                                   rtol=METRIC_RTOL, atol=ATOL, err_msg=key)


def test_resumed_pool_takes_no_uniform_warmup_again():
    """The resumed env steps count against SAC's uniform-warmup budget,
    as in the JAX pool."""
    from distributed_ddpg_tpu.actors.pool import ActorPool as JaxPool
    from distributed_ddpg_tpu.envs import make as jax_make, spec_of as jax_spec_of

    for offset in (0, 400, 1000, 5000):
        jcfg = JaxConfig(sac=True, replay_min_size=1000, num_actors=3)
        cfg = DDPGConfig(sac=True, replay_min_size=1000, num_actors=3, device="cpu")
        jpool = JaxPool(jcfg, jax_spec_of(jax_make(jcfg.env_id, seed=0)))
        jpool.env_steps_offset = offset
        pool = ActorPool(cfg, spec_of(make(cfg.env_id, seed=0)), env_steps_offset=offset)
        assert pool.warmup_budget_per_worker() == jpool.warmup_budget_per_worker()
    assert pool.warmup_budget_per_worker() == 0


# --- through the CLI -----------------------------------------------------------------

# --shm_ring_rows=128: the actor runs at most 128 rows ahead of the
# learner, as on the queue (4 batches of 32), so a run's env steps take
# the chunks these drills are sized for.
TINY = ["--device=cpu", "--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--learner_chunk=4", "--replay_min_size=200", "--eval_every=0",
        "--eval_episodes=1", "--shm_ring_rows=128"]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(flags, log_path, timeout=120, torchrun=False):
    """The trainer's CLI in a child process; (result, JSONL records)."""
    head = ([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2"]
            if torchrun else [sys.executable])
    cmd = [*head, "-m", "distributed_ddpg_tpu_torch.train", *TINY, *flags,
           f"--log_path={log_path}"]
    res = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=timeout)
    records = ([json.loads(line) for line in log_path.read_text().splitlines()]
               if log_path.exists() else [])
    return res, records


def _resumed(stdout, d):
    return [int(m) for m in re.findall(rf"resumed from {re.escape(str(d))} at learner step "
                                       r"(\d+), env step \d+", stdout)]


def test_cli_corrupt_newest_checkpoint_falls_back(tmp_path):
    d = tmp_path / "ckpt"
    flags = [f"--checkpoint_dir={d}", "--checkpoint_every=4", "--checkpoint_keep=3"]
    res, _ = _cli(flags + ["--total_env_steps=2000"], tmp_path / "a.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    steps = ckpt.valid_steps(str(d))
    assert len(steps) >= 2, steps
    latest, fallback = steps[-1], steps[-2]
    _truncate_largest(str(d / f"step_{latest}"))
    res, records = _cli(flags + ["--total_env_steps=2400"], tmp_path / "b.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"step_{latest} failed verification" in res.stderr
    assert _resumed(res.stdout, d) == [fallback]
    assert (d / f"corrupt_step_{latest}").is_dir()
    final = records[-1]
    assert final["resumed_from"] == fallback and final["learner_steps"] >= fallback
    if (d / f"step_{latest}").is_dir():   # written again by the resumed run
        assert ckpt.verify_checkpoint(str(d), latest)[0]


def test_cli_sigterm_takes_an_emergency_checkpoint_and_exits_75(tmp_path):
    d, log_path = tmp_path / "ckpt", tmp_path / "m.jsonl"
    cmd = [sys.executable, "-m", "distributed_ddpg_tpu_torch.train", *TINY,
           "--total_env_steps=2000000", f"--checkpoint_dir={d}",
           "--checkpoint_every=1000000000", f"--log_path={log_path}"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 90
        while time.time() < deadline and proc.poll() is None:
            if log_path.exists() and '"kind": "train"' in log_path.read_text():
                break
            time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[1][-2000:]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == EXIT_PREEMPTED == 75, err[-3000:]
    assert "emergency checkpoint" in err
    step = ckpt.latest_step(str(d))
    assert step is not None and step > 0
    assert ckpt.verify_checkpoint(str(d), step) == jax_ckpt.verify_checkpoint(str(d), step) \
        == (True, "ok")
    final = json.loads(log_path.read_text().splitlines()[-1])
    assert final["kind"] == "final" and final["emergency_ckpt"] == 1
    assert final["learner_steps"] == step and final["final_return"] is None
    # Resumed at its own env-step budget, the run is already done: the
    # checkpoint's env steps count against total_env_steps.
    res, records = _cli([f"--checkpoint_dir={d}", f"--total_env_steps={final['step']}"],
                        tmp_path / "again.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    assert _resumed(res.stdout, d) == [step]
    again = records[-1]
    assert (again["chunks"], again["learner_steps"], again["step"]) == (0, step, final["step"])


def test_cli_d4pg_auto_resume_keeps_its_bounds(tmp_path):
    d = tmp_path / "ckpt"
    flags = ["--distributional=true", "--n_step=5", "--v_min=auto", "--v_max=auto",
             "--prioritized=true", f"--checkpoint_dir={d}", "--checkpoint_every=4"]
    res, first = _cli(flags + ["--total_env_steps=500"], tmp_path / "a.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    step = ckpt.latest_step(str(d))
    meta = json.loads((d / f"step_{step}" / "meta.json").read_text())
    warm = next(r for r in first if r["kind"] == "support")
    res, records = _cli(flags + ["--total_env_steps=700"], tmp_path / "b.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    support = [r for r in records if r["kind"] == "support"]
    assert support[0]["reason"] == "checkpoint"
    # A record holds a float to 6 decimals (metrics._jsonable, the JAX
    # logger's rule); the checkpoint's meta holds it whole.
    bounds = [round(v, 6) for v in meta["v_bounds"]]
    assert [support[0]["v_min"], support[0]["v_max"]] == bounds
    assert not [r for r in support if r["reason"] == "warmup"]
    if len(support) == 1:   # no expansion since: the run trained on them
        assert [records[-1]["v_min"], records[-1]["v_max"]] == bounds
    assert bounds == [warm["v_min"], warm["v_max"]] or len(
        [r for r in first if r["kind"] == "support"]) > 1


def test_cli_sac_resume_keeps_its_temperature_state(tmp_path):
    """The resumed run's temperature count goes on from the checkpoint's
    (a fresh alpha_opt would count from 0): alpha_opt, and log_alpha with
    it, came back, and the step with them."""
    d = tmp_path / "ckpt"
    flags = ["--sac=true", "--actor_lr=3e-4", "--critic_lr=3e-4", "--tau=0.005",
             f"--checkpoint_dir={d}", "--checkpoint_every=4", "--checkpoint_keep=0"]
    res, _ = _cli(flags + ["--total_env_steps=500"], tmp_path / "a.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    first = ckpt.latest_step(str(d))
    with np.load(d / f"step_{first}" / "state.npz") as z:
        assert int(z["alpha_opt/count"]) == int(z["step"]) == first
        alpha0 = float(z["log_alpha"])
    assert alpha0 != math.log(0.2)
    res, records = _cli(flags + ["--total_env_steps=1000"], tmp_path / "b.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    assert _resumed(res.stdout, d) == [first]
    last = ckpt.latest_step(str(d))
    assert first < last <= records[-1]["learner_steps"]
    with np.load(d / f"step_{last}" / "state.npz") as z:
        assert int(z["alpha_opt/count"]) == int(z["step"]) == int(z["critic_opt/count"]) == last


def test_cli_two_gloo_ranks_resume_the_same_step(tmp_path):
    d = tmp_path / "ckpt"
    flags = ["--data_axis=2", f"--checkpoint_dir={d}", "--checkpoint_every=8"]
    res, _ = _cli(flags + ["--total_env_steps=500"], tmp_path / "a.jsonl", torchrun=True)
    assert res.returncode == 0, res.stderr[-3000:]
    step = ckpt.latest_step(str(d))
    res, records = _cli(flags + ["--total_env_steps=700"], tmp_path / "b.jsonl",
                        torchrun=True)
    assert res.returncode == 0, res.stderr[-3000:]
    assert _resumed(res.stdout, d) == [step, step]
    final = records[-1]
    assert final["replicas_identical"] is True and final["resumed_from"] == step
    assert final["learner_steps"] >= step and final["data_axis"] == 2
