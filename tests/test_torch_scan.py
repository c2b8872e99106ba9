"""The scan route and the fused Adam + Polyak update (K2) in the port
against the JAX package, on the CPU at a small size (obs 3, act 2, nets
32x32, batch 8, K 4, from step 5 with nonzero Adam moments and every count
offset).

- K2's plain version (ops/fused_update.fused_adam_polyak on CPU tensors)
  against the JAX fused_adam_polyak, whose Pallas kernel runs here in
  interpret mode, on the JAX test's ragged leaves over 3 steps
  (tests/test_fused.py:23; rtol 1e-6, atol 1e-7 as there); and bit for bit
  against adam_update + polyak_update.
- The eager step with fused_update=True against the JAX jit_learner_step,
  2 steps, DDPG and D4PG (rtol 1e-5, atol 1e-6, tests/test_fused.py:45).
- The eager step's C51 projection against the JAX one at a support whose
  top atom's index rounds past the end (rtol 1e-6, atol 1e-7).
- The port's scan chunk (parallel/learner.make_scan_chunk_fn, K eager
  steps) against the JAX ShardedLearner(fused_chunk='off').run_chunk on the
  same packed batches, one device: DDPG and D4PG at 300 atoms with
  fused_update, DDPG with critic_l2=0.01 and action_insert_layer 0 and 2,
  one critic hidden layer, TD3 (delay 2, smoothing; the JAX td3_noise_eps,
  the JAX scan's own stream, passed in) and SAC (the JAX sac_noise_eps),
  and bf16 with fused_update, at test_torch_slice.py's rtol 2e-5, atol
  1e-6 (metrics 5e-5), which test_torch_bf16.py also holds the eager bf16
  step to (measured: the state within 3.0e-8, td within 8.3e-7, D4PG's).
  Each case's JAX chunk is built and run once (a module fixture).
- The port's ShardedLearner takes the scan route for these configs and
  its run_chunk equals the scan chunk; the route rule ('auto', 'on',
  'off') and the config's new range checks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import jit_learner_step as jax_jit_step
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.ops.fused_update import fused_adam_polyak as jax_fused_adam_polyak
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu_torch import types
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    make_learner_step,
    train_state_from_numpy,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.ops.fused_update import (
    fused_adam_polyak,
    fused_adam_polyak_reference,
)
from distributed_ddpg_tpu_torch.ops.optim import adam_update, tree_leaves
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, make_scan_chunk_fn
from distributed_ddpg_tpu_torch.types import OptState

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K, STEP0 = 3, 2, 8, 4, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/test_torch_slice.py
CASES = {
    "ddpg-fused_update": dict(fused_update=True),
    "d4pg-300atoms-fused_update": dict(distributional=True, num_atoms=300, v_min=-10.0,
                                       v_max=10.0, fused_update=True),
    "ddpg-l2-insert0": dict(critic_l2=0.01, action_insert_layer=0),
    "ddpg-l2-insert2": dict(critic_l2=0.01, action_insert_layer=2),
    "ddpg-one-critic-layer": dict(critic_hidden=(32,)),
    "td3-delay2-noise": dict(twin_critic=True, policy_delay=2, target_noise=0.2,
                             fused_chunk="off"),
    "sac": dict(sac=True, fused_chunk="off"),
    "ddpg-bf16-fused_update": dict(fused_update=True, compute_dtype="bfloat16"),
}


def _configs(overrides):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3)
    common.update(overrides)
    jax_only = {k: v for k, v in common.items() if k != "fused_chunk"}
    return (JaxConfig(**jax_only, fused_chunk="off"),
            DDPGConfig(device="cpu", **common))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg):
    """The JAX package's initial state, moved to mid-training: step STEP0,
    every count offset and nonzero Adam moments (over zero moments Adam's
    step turns sign-like, where the two frameworks' rounding differs)."""
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
    return s


def _batches(seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "action": rng.uniform(-2, 2, (K, B, ACT)).astype(np.float32),
        "reward": rng.standard_normal((K, B)).astype(np.float32),
        "discount": np.full((K, B), 0.99, np.float32),
        "next_obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (K, B)).astype(np.float32),
    }


def _jax_eps(jcfg):
    """The JAX scan's own noise for steps STEP0 .. STEP0+K-1: TD3's
    smoothing [K, B, act], SAC's normals (eps_next, eps_cur), or None."""
    if jcfg.sac:
        return tuple(torch.from_numpy(np.array(e)) for e in jax_fused_chunk.sac_noise_eps(
            jcfg, jnp.int32(STEP0), K, B, ACT))
    if jcfg.twin_critic and jcfg.target_noise > 0:
        return torch.from_numpy(np.array(
            jax_fused_chunk.td3_noise_eps(jcfg, jnp.int32(STEP0), K, B, ACT)))
    return None


def _assert_close(name, got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol} "
        f"(max_abs_err {err.max():.3e})")


def _assert_state(state, ref, rtol=RTOL, atol=ATOL):
    """The port's TrainState against the JAX one (numpy leaves)."""
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (lp, lr) in enumerate(zip(getattr(state, group), getattr(ref, group))):
            for key in ("w", "b"):
                _assert_close(f"{group}[{i}].{key}", lp[key].numpy(), lr[key], rtol, atol)
    for opt in ("actor_opt", "critic_opt"):
        o, r = getattr(state, opt), getattr(ref, opt)
        for i, (lp, lr) in enumerate(zip(o.mu, r.mu)):
            for key in ("w", "b"):
                _assert_close(f"{opt}.mu[{i}].{key}", lp[key].numpy(), lr[key], rtol, atol)
                _assert_close(f"{opt}.nu[{i}].{key}", o.nu[i][key].numpy(), r.nu[i][key],
                              rtol, atol)
        assert int(o.count) == int(r.count), opt
    assert int(state.step) == int(ref.step)
    if ref.log_alpha is not None:
        _assert_close("log_alpha", state.log_alpha.numpy(), ref.log_alpha, rtol, atol)
        assert int(state.alpha_opt.count) == int(ref.alpha_opt.count)


# --- K2: the fused Adam + Polyak update ------------------------------------

RAGGED = [(17, 256), (256,), (256, 129), (3,)]      # tests/test_fused.py:23


def _ragged_tree(rng):
    leaves = [rng.standard_normal(s).astype(np.float32) for s in RAGGED]
    return ({"w": leaves[0], "b": leaves[1]}, {"w": leaves[2], "b": leaves[3]})


def _torch_tree(tree):
    return tuple({k: torch.from_numpy(v.copy()) for k, v in layer.items()} for layer in tree)


def test_fused_update_plain_version_matches_jax_kernel():
    """Three steps from zero moments: the port's K2 wrapper on CPU tensors
    (its plain version) against the JAX Pallas kernel in interpret mode,
    on the same params, targets and gradients (sin(p + i) of the port's
    params, as tests/test_fused.py takes them)."""
    rng = np.random.default_rng(0)
    params, targets = _ragged_tree(rng), _ragged_tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    jp, jt = params, targets
    jopt = OptState(mu=zeros, nu=zeros, count=jnp.zeros((), jnp.int32))
    p, t = _torch_tree(params), _torch_tree(targets)
    opt = OptState(mu=_torch_tree(zeros), nu=_torch_tree(zeros),
                   count=torch.zeros((), dtype=torch.int32))
    jit_fused = jax.jit(jax_fused_adam_polyak, static_argnums=(4, 5))
    for i in range(3):
        grads = tuple({k: np.sin(v.numpy() + i).astype(np.float32) for k, v in layer.items()}
                      for layer in p)
        jp, jopt, jt = jit_fused(jp, grads, jopt, jt, 1e-3, 0.05)
        p, opt, t = fused_adam_polyak(p, _torch_tree(grads), opt, t, 1e-3, 0.05)
        for name, got, want in (("params", p, jp), ("mu", opt.mu, jopt.mu),
                                ("nu", opt.nu, jopt.nu), ("targets", t, jt)):
            for a, b in zip(tree_leaves(got), tree_leaves(_np(want))):
                _assert_close(f"step {i} {name}", a.numpy(), b, rtol=1e-6, atol=1e-7)
    assert int(opt.count) == int(jopt.count) == 3


def test_fused_update_plain_version_is_adam_then_polyak():
    """On CPU tensors the wrapper is its plain version, and that is
    adam_update then polyak_update, bit for bit."""
    rng = np.random.default_rng(1)
    params, targets, grads = (_torch_tree(_ragged_tree(rng)) for _ in range(3))
    mu, nu = _torch_tree(_ragged_tree(rng)), _torch_tree(_ragged_tree(rng))
    nu = tuple({k: v.abs() for k, v in layer.items()} for layer in nu)
    opt = OptState(mu=mu, nu=nu, count=torch.tensor(7, dtype=torch.int32))
    want_p, want_opt = adam_update(params, grads, opt, 3e-4)
    want = (want_p, want_opt, polyak_update(want_p, targets, 5e-3))
    for got in (fused_adam_polyak(params, grads, opt, targets, 3e-4, 5e-3),
                fused_adam_polyak_reference(params, grads, opt, targets, 3e-4, 5e-3)):
        for tree, ref in ((got[0], want[0]), (got[1].mu, want[1].mu), (got[1].nu, want[1].nu),
                          (got[2], want[2])):
            for a, b in zip(tree_leaves(tree), tree_leaves(ref)):
                assert torch.equal(a, b)
        assert int(got[1].count) == 8


def test_fused_update_raises_off_the_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor on a card: the wrapper raises
    (it never falls back to the plain version off the CPU)."""
    tree = ({"w": torch.empty((2, 2), device="meta"), "b": torch.empty(2, device="meta")},)
    opt = OptState(mu=tree, nu=tree, count=torch.zeros((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_adam_polyak(tree, tree, opt, tree, 1e-3, 1e-3)


@pytest.mark.parametrize("family", ["ddpg", "d4pg"])
def test_eager_fused_update_step_matches_jax(family):
    """Two eager steps with fused_update=True against two calls of the JAX
    jit_learner_step (its K2 in interpret mode)."""
    over = dict(fused_update=True)
    if family == "d4pg":
        over.update(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0)
    jcfg, cfg = _configs(over)
    jstate = _jax_state(jcfg)
    fields = _batches(4)
    packed = types.pack_batch_np(fields)
    jstep = jax_jit_step(jcfg, SCALE, donate=False, action_offset=OFFSET)
    step = make_learner_step(cfg, SCALE, OFFSET)
    state = train_state_from_numpy(_np(jstate))
    for k in range(2):
        jout = jstep(jstate, jax_types.unpack_batch(jnp.asarray(packed[k]), OBS, ACT))
        out = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT))
        jstate, state = jout.state, out.state
        _assert_close(f"step {k} td", out.td_errors.numpy(), np.asarray(jout.td_errors),
                      1e-5, 1e-6)
        for name in METRIC_KEYS:
            _assert_close(f"step {k} {name}", float(out.metrics[name]),
                          float(jout.metrics[name]), 1e-5, 1e-6)
    _assert_state(state, _np(jstate), 1e-5, 1e-6)


def test_categorical_projection_at_a_support_whose_top_index_rounds_past_the_end():
    """At 51 atoms on [-25, 25 + 7 * 2**-18] (both exact in f32) a true
    division gives dz = 1 + 4 * 2**-23 and, for a target clipped to v_max,
    b = 50 + 2**-18, so ceil(b) is atom 51 of 51. The port's projection
    (the eager D4PG step's) must not index past the table, and must put the
    mass where the JAX projection's clamped gather puts it."""
    from distributed_ddpg_tpu.ops.losses import categorical_projection as jax_projection
    from distributed_ddpg_tpu_torch.ops.losses import (
        categorical_projection,
        categorical_support,
    )

    atoms, v_min, v_max = 51, -25.0, 25.0 + 7 * 2.0 ** -18
    support = categorical_support(v_min, v_max, atoms)
    assert support[-1].item() == v_max
    dz = (support[-1] - support[0]) / support.new_full((), atoms - 1)
    assert torch.ceil((support[-1] - support[0]) / dz).item() == atoms   # past the end
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(atoms), size=6).astype(np.float32)
    # Rows clipped at v_max, clipped at v_min, and in between.
    rewards = np.array([100.0, 30.0, -100.0, 0.5, -3.25, 0.0], np.float32)
    discounts = np.full(6, 0.99, np.float32)
    got = categorical_projection(support, torch.from_numpy(probs),
                                 torch.from_numpy(rewards), torch.from_numpy(discounts))
    want = np.asarray(jax_projection(jnp.asarray(support.numpy()), jnp.asarray(probs),
                                     jnp.asarray(rewards), jnp.asarray(discounts)))
    _assert_close("projection", got.numpy(), want, rtol=1e-6, atol=1e-7)
    _assert_close("top atom of the clipped row", got[0, -1].item(), 1.0, rtol=1e-6, atol=1e-7)


# --- the scan chunk ---------------------------------------------------------


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One case's inputs and the JAX scan chunk's output, made once."""
    jcfg, cfg = _configs(CASES[request.param])
    jstate = _np(_jax_state(jcfg))   # numpy: the JAX chunk donates its input
    fields = _batches(11)
    one_device = jax_mesh.make_mesh(1, 1, devices=jax.devices()[:1])
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=one_device, chunk_size=K, unroll=1)
    assert not jl.fused_chunk_active
    jl.state = jax.device_put(jstate, jl._state_sharding)
    jout = jl.run_chunk(fields)
    return dict(name=request.param, cfg=cfg, jstate=jstate, fields=fields,
                eps=_jax_eps(jcfg), jout=_np(jout))


def test_scan_chunk_matches_jax_scan_chunk(case):
    cfg, jout = case["cfg"], case["jout"]
    run = make_scan_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    packed = torch.from_numpy(types.pack_batch_np(case["fields"]))
    state, td, metrics = run(train_state_from_numpy(case["jstate"]), packed, case["eps"],
                             step0=STEP0)
    _assert_state(state, jout.state)
    _assert_close("td", td.numpy(), jout.td_errors)
    assert td.shape == (K, B)
    for name in METRIC_KEYS:
        _assert_close(name, float(metrics[name]), float(jout.metrics[name]), METRIC_RTOL, ATOL)


def test_sharded_learner_takes_the_scan_route(case):
    """The port's learner picks the scan route for every case (each is
    outside the kernel's envelope or sets fused_chunk='off') and its
    run_chunk, which draws TD3's and SAC's noise itself, equals the scan
    chunk fed that draw."""
    cfg = case["cfg"]
    start = train_state_from_numpy(case["jstate"])
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, state=start)
    assert not learner.fused_chunk_active
    out = learner.run_chunk(case["fields"])
    eps = None
    if cfg.sac:
        eps = fc.sac_noise_eps(cfg, torch.Generator(), STEP0, K, B, ACT)
    elif cfg.takes_noise:
        eps = fc.td3_noise_eps(cfg, torch.Generator(), STEP0, K, B, ACT)
    run = make_scan_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    packed = torch.from_numpy(types.pack_batch_np(case["fields"]))
    ref, rtd, _ = run(start, packed, eps, step0=STEP0)
    assert torch.equal(out.td_errors, rtd)
    assert torch.equal(fc.flatten_state(learner.state), fc.flatten_state(ref))
    assert int(learner.state.step) == STEP0 + K


def test_scan_chunk_d4pg_set_value_bounds_rebuilds_the_step():
    """After set_value_bounds the scan chunk equals one built on the new
    support, and an 'auto' support raises until it is set."""
    over = dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0, fused_update=True)
    jcfg, cfg = _configs(over)
    start = train_state_from_numpy(_np(_jax_state(jcfg)))
    packed = torch.from_numpy(types.pack_batch_np(_batches(2)))
    moved = make_scan_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    moved.set_value_bounds(-8.0, 3.0)
    fresh = make_scan_chunk_fn(cfg.replace(v_min=-8.0, v_max=3.0), OBS, ACT, SCALE, OFFSET,
                               chunk_size=K)
    a, b = moved(start, packed, None, STEP0), fresh(start, packed, None, STEP0)
    assert torch.equal(a[1], b[1])
    assert torch.equal(fc.flatten_state(a[0]), fc.flatten_state(b[0]))
    auto = make_scan_chunk_fn(cfg.replace(v_min=math.nan, v_max=math.nan), OBS, ACT, SCALE,
                              OFFSET, chunk_size=K)
    with pytest.raises(ValueError, match="auto"):
        auto(start, packed, None, STEP0)


# --- the route rule and the config -------------------------------------------


@pytest.mark.parametrize("over, active", [
    (dict(), True),
    (dict(twin_critic=True, policy_delay=2, target_noise=0.2), True),
    (dict(distributional=True, num_atoms=256), True),
    (dict(sac=True), True),
    (dict(compute_dtype="bfloat16"), True),
    (dict(fused_chunk="off"), False),
    (dict(fused_update=True), False),
    (dict(critic_l2=0.01), False),
    (dict(action_insert_layer=0), False),
    (dict(critic_hidden=(32,)), False),
    (dict(distributional=True, num_atoms=257), False),
])
def test_auto_route_follows_the_kernel_envelope(over, active):
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, device="cpu")
    cfg = cfg.replace(**over)
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    assert learner.fused_chunk_active is active
    assert fc.supported(cfg) is (active or cfg.fused_chunk == "off")


@pytest.mark.parametrize("over", [dict(fused_update=True), dict(critic_l2=0.01),
                                  dict(distributional=True, num_atoms=300)])
def test_fused_chunk_on_outside_the_envelope_raises(over):
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, device="cpu",
                     fused_chunk="on", **over)
    with pytest.raises(ValueError, match="fused_chunk='on'"):
        ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    assert ShardedLearner(cfg.replace(fused_chunk="off"), OBS, ACT, SCALE, OFFSET,
                          chunk_size=K).fused_chunk_active is False


@pytest.mark.parametrize("over, match", [
    (dict(fused_chunk="sometimes"), "fused_chunk"),
    (dict(action_insert_layer=3), "action_insert_layer"),
    (dict(action_insert_layer=-1), "action_insert_layer"),
    (dict(distributional=True, num_atoms=1), "num_atoms"),
    (dict(sac=True, fused_update=True), "fused_update"),
    (dict(twin_critic=True, fused_update=True), "fused_update"),
])
def test_config_checks_match_jax(over, match):
    """The port raises where the JAX config raises, with its message."""
    with pytest.raises(ValueError, match=match):
        DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, **over)
    if "num_atoms" not in over:   # the JAX config has no atom check
        with pytest.raises(ValueError, match=match):
            JaxConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, **over)
