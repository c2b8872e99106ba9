"""Prioritized replay on the device in the port against the JAX package,
on the CPU at a small size (obs 3, act 2, nets 32x32, batch 16, K 4,
capacity 512, blocks of 64).

- draw_per_indices: on dyadic priorities (every running sum exact, so the
  f32 cumsum's order cannot matter) with JAX's own uniforms passed in,
  the same indices as the JAX draw and weights within rtol 1e-6; on
  random priorities the frequency and weight checks of
  tests/test_device_per.py (atol 0.004, rtol 2e-4) and nothing drawn at
  or past the fill.
- DevicePrioritizedReplay's stamps against the JAX one's on the same rows
  (a plain insert, a wrapping insert, a padded flush, a max priority
  moved in between): equal priority vectors, ptr and size.
- One PER chunk (run_sample_chunk_per) for DDPG, TD3 (delay 2, its
  smoothing noise the JAX scan's own, passed in), D4PG (21 atoms) and
  SAC (the JAX scan's normals), on both of the port's routes, against the
  JAX ShardedLearner(fused_chunk='off').run_sample_chunk_per on the same
  state, rows and priorities: the test reproduces the JAX draw (the
  learner's key split as its program splits it, then draw_per_indices)
  and hands the port those idx and weights. End state, td and the
  priorities of the slots drawn once within rtol 2e-5, atol 1e-6, the
  metrics and max_priority within rtol 5e-5 (tests/fused_parity_util.py's
  tightest tier, as tests/test_fused_chunk.py runs it for DDPG); a slot
  drawn more than once holds its last draw's value in both.
- The duplicate rule (scatter_last_wins): last in flat order wins, twice
  bit-identical, as XLA's scatter does on the CPU; a chunk then an insert
  stamps the chunk's new max priority; the storage's weight column is
  untouched by a chunk.
- state_dict / load_state_dict under the JAX package's keys.
- README's D4PG command with --prioritized=true through the CLI in a
  child process.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPerReplay
from distributed_ddpg_tpu.replay.device import draw_per_indices as jax_draw
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.replay.device import (
    DevicePrioritizedReplay,
    draw_per_indices,
    fixed_order_cumsum,
    scatter_last_wins,
)
from distributed_ddpg_tpu_torch.types import pack_batch_np
from test_torch_slice import train_in_subprocess

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K, STEP0 = 3, 2, 16, 4, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, BLOCK, FILL = 512, 64, 384
BETA = 0.55
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/fused_parity_util.py, DDPG tier
FAMILIES = {
    "ddpg": dict(),
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-10.0, v_max=10.0),
    "sac": dict(sac=True),
}


def _one_device():
    return jax_mesh.make_mesh(1, 1, devices=jax.devices()[:1])


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


def _dyadic_priorities(size, seed):
    """Multiples of 1/8 up to 4 and zeros past `size`: every partial sum is
    exact in f32, in any order."""
    rng = np.random.default_rng(seed)
    p = np.zeros(CAP, np.float32)
    p[:size] = rng.integers(1, 33, size) / 8.0
    return p


# --- the draw ---------------------------------------------------------------


@pytest.mark.parametrize("size, beta, seed", [(CAP, 0.4, 0), (300, 1.0, 1), (1, 0.7, 2)])
def test_draw_matches_jax_on_dyadic_priorities(size, beta, seed):
    prios = _dyadic_priorities(size, seed)
    key = jax.random.PRNGKey(seed)
    jidx, jw = jax.jit(jax_draw, static_argnums=3)(
        key, jnp.asarray(prios), jnp.int32(size), (K, B), jnp.float32(beta))
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (K, B))))
    idx, w = draw_per_indices(torch.from_numpy(prios), size, (K, B), beta, uniform=uniform)
    assert idx.shape == (K, B) and w.shape == (K, B) and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    assert int(idx.max()) < size


def test_draw_is_proportional_with_the_host_weights():
    """tests/test_device_per.py's check on the port's draw: the empirical
    frequency matches p_i / sum(p), the weights are (N P(i))^-beta / max,
    and nothing is drawn at or past the fill."""
    cap, n, k, b, beta = 64, 48, 25, 64, 0.7
    rng = np.random.default_rng(0)
    prios = np.zeros(cap, np.float32)
    prios[:n] = rng.uniform(0.1, 2.0, n).astype(np.float32)
    probs = prios / prios.sum()
    counts = np.zeros(cap)
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        idx, w = draw_per_indices(torch.from_numpy(prios), n, (k, b), beta, generator=gen)
        idx = idx.numpy()
        counts += np.bincount(idx.reshape(-1), minlength=cap)
        w_host = (n * probs[idx]) ** (-beta)
        np.testing.assert_allclose(w.numpy(), w_host / w_host.max(axis=-1, keepdims=True),
                                   rtol=2e-4)
    np.testing.assert_allclose((counts / counts.sum())[:n], probs[:n], atol=0.004)
    assert counts[n:].sum() == 0, "sampled beyond the fill"


# --- the stamps -------------------------------------------------------------


def test_stamps_match_jax():
    """Three full blocks and a remainder, a max priority moved, a wrapping
    insert of five blocks, then a padded flush: the same stamps in both."""
    jrep = JaxPerReplay(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK)
    rep = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK)

    def same(where):
        np.testing.assert_array_equal(rep.priorities.numpy(),
                                      np.asarray(jax.device_get(jrep.priorities)), where)
        assert (rep.ptr, len(rep)) == (int(jrep.ptr), len(jrep)), where
        assert float(rep.max_priority) == float(jrep.max_priority)

    for r in (jrep, rep):
        r.add_packed(_rows(200, 0))
    same("first insert")
    moved = np.linspace(0.5, 2.0, CAP).astype(np.float32)
    jrep.set_per_state(jnp.asarray(moved), jnp.float32(2.5))
    rep.set_per_state(torch.from_numpy(moved.copy()), torch.tensor(2.5))
    for r in (jrep, rep):
        r.add_packed(_rows(400, 1))
    same("wrapping insert")
    assert rep.ptr < 200 and rep.priorities[0].item() == 2.5
    for r in (jrep, rep):
        r.add_packed(_rows(10, 2))
        r.flush()
    same("padded flush")


# --- one PER chunk against the JAX learner's ---------------------------------


def _configs(family):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                  prioritized=True, **FAMILIES[family])
    return JaxConfig(fused_chunk="off", **common), DDPGConfig(device="cpu", **common)


def _mid_training(jcfg):
    """The JAX initial state at step STEP0 with nonzero Adam moments and
    offset counts (over zero moments Adam's step turns sign-like)."""
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
        s = s._replace(log_alpha=jnp.float32(math.log(0.3)))
    return jax.tree.map(np.asarray, s)


def _priorities(seed):
    rng = np.random.default_rng(seed)
    p = np.zeros(CAP, np.float32)
    p[:FILL] = rng.uniform(0.1, 2.0, FILL).astype(np.float32)
    return p


def _jax_noise(jcfg):
    if jcfg.sac:
        return tuple(torch.from_numpy(np.array(e)) for e in jax_fused_chunk.sac_noise_eps(
            jcfg, jnp.int32(STEP0), K, B, ACT))
    if jcfg.twin_critic and jcfg.target_noise > 0:
        return torch.from_numpy(np.array(
            jax_fused_chunk.td3_noise_eps(jcfg, jnp.int32(STEP0), K, B, ACT)))
    return None


@pytest.fixture(scope="module", params=list(FAMILIES))
def jax_per_chunk(request):
    """One family's JAX PER chunk (scan route), its draw reproduced."""
    jcfg, cfg = _configs(request.param)
    jstate = _mid_training(jcfg)
    rows, prios = _rows(FILL, 5), _priorities(6)
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_one_device(), chunk_size=K,
                    unroll=1)
    assert not jl.fused_chunk_active
    jl.state = jax.device_put(jstate, jl._state_sharding)
    jrep = JaxPerReplay(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK,
                        alpha=jcfg.per_alpha, eps=jcfg.per_eps)
    jrep.add_packed(rows)
    jrep.set_per_state(jnp.asarray(prios), jnp.float32(1.5))
    # The draw as the learner's program makes it (parallel/learner.py:465).
    _, sub = jax.random.split(jl._key)
    idx, weights = jax.jit(jax_draw, static_argnums=3)(
        sub, jnp.asarray(prios), jnp.int32(FILL), (K, B), jnp.float32(BETA))
    out = jl.run_sample_chunk_per(jrep, BETA)
    return dict(
        family=request.param, cfg=cfg, jstate=jstate, rows=rows, prios=prios,
        idx=np.array(idx), weights=np.array(weights), eps=_jax_noise(jcfg),
        out=jax.tree.map(np.asarray, out),
        new_prios=np.asarray(jax.device_get(jrep.priorities)),
        max_priority=float(jrep.max_priority),
    )


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _last_draw(idx, vals):
    """slot -> the value of its last draw in flat K x B order."""
    out = {}
    for i, v in zip(idx.reshape(-1).tolist(), vals.reshape(-1).tolist()):
        out[i] = v
    return out


def _port_chunk(ref, route, monkeypatch):
    cfg = ref["cfg"].replace(fused_chunk=route)
    if ref["eps"] is not None:   # the JAX scan's own noise, for step STEP0
        def noise(config, gen, step, k, b, act):
            assert (step, k, b, act) == (STEP0, K, B, ACT)
            return ref["eps"]

        monkeypatch.setattr(fc, "sac_noise_eps" if cfg.sac else "td3_noise_eps", noise)
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K,
                             state=train_state_from_numpy(ref["jstate"]))
    assert learner.fused_chunk_active is (route == "on")
    rep = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK,
                                  alpha=cfg.per_alpha, eps=cfg.per_eps)
    rep.add_packed(ref["rows"])
    rep.set_per_state(torch.from_numpy(ref["prios"].copy()), torch.tensor(1.5))
    storage = rep.storage.clone()
    out = learner.run_sample_chunk_per(rep, BETA, idx=torch.from_numpy(ref["idx"]),
                                       weights=torch.from_numpy(ref["weights"]))
    assert torch.equal(rep.storage, storage), "the chunk wrote into the replay's rows"
    return learner, rep, out


@pytest.mark.parametrize("route", ["on", "off"])
def test_per_chunk_matches_jax(jax_per_chunk, route, monkeypatch):
    ref, jout = jax_per_chunk, jax_per_chunk["out"]
    learner, rep, out = _port_chunk(ref, route, monkeypatch)
    state, jstate = learner.state, jout.state
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (lp, lr) in enumerate(zip(getattr(state, group), getattr(jstate, group))):
            for key in ("w", "b"):
                _close(f"{group}[{i}].{key}", lp[key].numpy(), lr[key])
    for opt in ("actor_opt", "critic_opt"):
        o, r = getattr(state, opt), getattr(jstate, opt)
        for i in range(len(o.mu)):
            for key in ("w", "b"):
                _close(f"{opt}.mu[{i}].{key}", o.mu[i][key].numpy(), r.mu[i][key])
                _close(f"{opt}.nu[{i}].{key}", o.nu[i][key].numpy(), r.nu[i][key])
        assert int(o.count) == int(r.count), opt
    assert int(state.step) == int(jstate.step) == STEP0 + K
    if jstate.log_alpha is not None:
        _close("log_alpha", state.log_alpha.numpy(), jstate.log_alpha)
    td = out.td_errors.numpy()
    _close("td", td, jout.td_errors)
    for name in METRIC_KEYS:
        _close(name, float(out.metrics[name]), float(jout.metrics[name]), METRIC_RTOL, ATOL)
    _close("max_priority", float(rep.max_priority), ref["max_priority"], METRIC_RTOL, ATOL)

    # The priorities: untouched slots as they were, every drawn slot within
    # the tolerance, and a slot drawn twice or more at its last draw's value.
    got, want, idx = rep.priorities.numpy(), ref["new_prios"], ref["idx"]
    drawn = np.zeros(CAP, bool)
    drawn[idx.reshape(-1)] = True
    np.testing.assert_array_equal(got[~drawn], ref["prios"][~drawn])
    np.testing.assert_array_equal(want[~drawn], ref["prios"][~drawn])
    _close("priorities", got[drawn], want[drawn])
    counts = np.bincount(idx.reshape(-1), minlength=CAP)
    new_p = (np.abs(td) + np.float32(1e-6)) ** np.float32(0.6)
    jnew_p = (np.abs(jout.td_errors) + np.float32(1e-6)) ** np.float32(0.6)
    for slot, v in _last_draw(idx, new_p).items():
        if counts[slot] > 1:
            _close(f"duplicate slot {slot}", got[slot], v, 1e-6, 0.0)
            _close(f"duplicate slot {slot} (JAX)", want[slot],
                   _last_draw(idx, jnew_p)[slot], 1e-6, 0.0)
    assert (counts > 1).any(), "the draw should repeat a slot"


# --- the duplicate rule, the in-flight order, the checkpoint ---------------------


def test_scatter_last_wins_matches_xla_and_is_deterministic():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 40, (K * 50,))
    vals = rng.standard_normal(K * 50).astype(np.float32)
    runs = []
    for _ in range(2):
        target = torch.zeros(64)
        scatter_last_wins(target, torch.from_numpy(idx), torch.from_numpy(vals))
        runs.append(target)
    assert torch.equal(runs[0], runs[1])
    want = np.zeros(64, np.float32)
    for i, v in zip(idx, vals):
        want[i] = v
    np.testing.assert_array_equal(runs[0].numpy(), want)
    xla = jax.jit(lambda p, i, v: p.at[i].set(v))(jnp.zeros(64), jnp.asarray(idx),
                                                   jnp.asarray(vals))
    np.testing.assert_array_equal(np.asarray(xla), want)


def test_insert_after_a_chunk_stamps_its_new_max(monkeypatch):
    jcfg, cfg = _configs("ddpg")
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K,
                             state=train_state_from_numpy(_mid_training(jcfg)))
    rep = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK)
    rep.add_packed(_rows(FILL, 5))
    weight_col = rep.storage[:, -1].clone()
    learner.run_sample_chunk_per(rep, BETA)
    new_max = float(rep.max_priority)
    assert new_max > 1.0, "rewards of scale 3 should give a priority above 1"
    assert torch.equal(rep.storage[:, -1], weight_col)
    ptr = rep.ptr
    rep.add_packed(_rows(BLOCK, 7))
    assert torch.equal(rep.priorities[ptr:ptr + BLOCK], torch.full((BLOCK,), new_max))


def test_state_dict_round_trip_under_jax_keys():
    jrep = JaxPerReplay(CAP, OBS, ACT, mesh=_one_device(), block_size=BLOCK)
    rep = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK)
    prios = _priorities(8)
    for r in (jrep, rep):
        r.add_packed(_rows(FILL, 9))
    jrep.set_per_state(jnp.asarray(prios), jnp.float32(2.25))
    rep.set_per_state(torch.from_numpy(prios.copy()), torch.tensor(2.25))
    state, jstate = rep.state_dict(), jrep.state_dict()
    assert {"priorities", "max_priority"} <= set(state) <= set(jstate)
    for key in state:
        np.testing.assert_array_equal(state[key], jstate[key], key)
    fresh = DevicePrioritizedReplay(CAP, OBS, ACT, "cpu", block_size=BLOCK)
    fresh.load_state_dict(jstate)
    assert torch.equal(fresh.priorities, rep.priorities)
    assert float(fresh.max_priority) == 2.25 and (fresh.ptr, len(fresh)) == (rep.ptr, FILL)
    assert torch.equal(fresh.storage, rep.storage)


# --- the train entry point --------------------------------------------------------


def test_readme_d4pg_command_with_per_trains(tmp_path):
    total = 600
    records = train_in_subprocess([
        "--distributional=true", "--n_step=5", "--prioritized=true", "--v_min=auto",
        "--v_max=auto", "--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--learner_chunk=4", "--replay_min_size=200",
        f"--total_env_steps={total}", "--eval_every=0", "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")
    final = records[-1]
    assert final["kind"] == "final" and final["prioritized"] is True
    assert final["chunks"] >= 1 and final["learner_steps"] == 4 * final["chunks"]
    for key in (*METRIC_KEYS, "final_return", "max_priority", "beta"):
        assert math.isfinite(final[key]), key
    assert final["max_priority"] > 0
    # The JAX trainer's anneal, per_beta + min(1, e / total) (per_beta_final
    # - per_beta), at the env-step count e of the last dispatch: a whole
    # count past the warmup and not past the final one.
    jcfg = JaxConfig()
    e = (final["beta"] - jcfg.per_beta) / (jcfg.per_beta_final - jcfg.per_beta) * total
    assert abs(e - round(e)) < 1e-6 and 200 <= round(e) <= final["step"]
    assert all(r["prioritized"] and jcfg.per_beta <= r["beta"] <= final["beta"]
               for r in records if r["kind"] == "train")


@pytest.mark.parametrize("n,block", [(1, 256), (64, 256), (65, 256), (257, 256),
                                     (70_001, 256), (70_001, 32), (1_000_003, 1024)])
def test_fixed_order_cumsum_is_a_prefix_sum(n, block):
    """The card's prefix sum of the PER draw (its order fixed by the length
    alone, for bit-identical replicas), run here on the CPU: within f32
    rounding of a float64 prefix sum (a few ulps of the total), exact on
    dyadic values (every partial sum representable, as the dyadic draw
    checks need), and the same twice."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(np.float32))
    got = fixed_order_cumsum(x, block)
    want = torch.cumsum(x.double(), 0)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 8 * 2.0 ** -24 * float(want[-1])
    assert torch.equal(got, fixed_order_cumsum(x, block))
    dyadic = torch.from_numpy((rng.integers(1, 9, n) / 8.0).astype(np.float32))
    assert torch.equal(fixed_order_cumsum(dyadic, block), torch.cumsum(dyadic, 0))
