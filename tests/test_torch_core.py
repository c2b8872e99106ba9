"""The port's core modules against the JAX package's, on the CPU at a small
size: packed batches, the MLPs, Adam, Polyak, the eager learner step over
K steps from one JAX-made TrainState, and the config.

Tolerances: rtol 2e-5, atol 1e-6 (tests/test_fused_chunk.py:60's oracle
tolerance); the metrics of K steps 5e-5, as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_step
from distributed_ddpg_tpu.models import mlp as jax_mlp
from distributed_ddpg_tpu.ops.optim import adam_update as jax_adam
from distributed_ddpg_tpu.ops.polyak import polyak_update as jax_polyak
from distributed_ddpg_tpu_torch import types
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    make_act_fn,
    make_learner_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.models import mlp
from distributed_ddpg_tpu_torch.ops.optim import adam_update
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K = 3, 1, 8, 4
HIDDEN = (32, 32)
RTOL, ATOL = 2e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _close_trees(port, ref):
    for lp, lr in zip(port, ref):
        for key in ("w", "b"):
            _close(lp[key].detach().numpy(), lr[key])


def _fields(seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((*lead, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, (*lead, ACT)).astype(np.float32),
        "reward": rng.standard_normal(lead).astype(np.float32),
        "discount": np.full(lead, 0.99, np.float32),
        "next_obs": rng.standard_normal((*lead, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, lead).astype(np.float32),
    }


def _jax_state(seed=3):
    cfg = JaxConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=seed)
    return cfg, jax_init(cfg, OBS, ACT, seed=seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("weight", [True, False])
def test_pack_unpack_matches_jax(weight):
    fields = _fields(0, lead=(K, B))
    if not weight:
        fields.pop("weight")
    packed = types.pack_batch_np(dict(fields))
    np.testing.assert_array_equal(packed, jax_types.pack_batch_np(dict(fields)))
    assert packed.shape[-1] == types.packed_width(OBS, ACT)
    port = types.unpack_batch(torch.from_numpy(packed), OBS, ACT)
    ref = jax_types.unpack_batch(jnp.asarray(packed), OBS, ACT)
    for name in types.Batch._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))


def test_init_shapes_match_jax():
    cfg, jstate = _jax_state()
    state = init_train_state(DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN,
                                        device="cpu"), OBS, ACT, seed=0)
    jnp_state = _np(jstate)
    for port, ref in ((state.actor_params, jnp_state.actor_params),
                      (state.critic_params, jnp_state.critic_params),
                      (state.target_critic_params, jnp_state.target_critic_params),
                      (state.critic_opt.nu, jnp_state.critic_opt.nu)):
        assert [tuple(l[k].shape) for l in port for k in ("w", "b")] == [
            l[k].shape for l in ref for k in ("w", "b")]
    # Init bounds: hidden U(+-1/sqrt(fan_in)), final U(+-FINAL_INIT_SCALE).
    assert float(state.actor_params[0]["w"].abs().max()) <= 1 / np.sqrt(OBS)
    assert float(state.critic_params[-1]["w"].abs().max()) <= mlp.FINAL_INIT_SCALE
    assert mlp.FINAL_INIT_SCALE == jax_mlp.FINAL_INIT_SCALE
    for t, p in zip(state.target_actor_params, state.actor_params):
        assert torch.equal(t["w"], p["w"])
    assert int(state.step) == int(state.actor_opt.count) == 0


def test_apply_matches_jax():
    _, jstate = _jax_state()
    state = train_state_from_numpy(_np(jstate))
    f = _fields(1)
    obs, act = torch.from_numpy(f["obs"]), torch.from_numpy(f["action"])
    scale, offset = np.float32(1.5), np.float32(0.25)
    _close(mlp.actor_apply(state.actor_params, obs, scale, offset).numpy(),
           jax_mlp.actor_apply(jstate.actor_params, f["obs"], scale, offset))
    _close(mlp.critic_apply(state.critic_params, obs, act).numpy(),
           jax_mlp.critic_apply(jstate.critic_params, f["obs"], f["action"]))
    act_fn = make_act_fn(None, scale, offset)
    _close(act_fn(state.actor_params, obs).numpy(),
           jax_mlp.actor_apply(jstate.actor_params, f["obs"], scale, offset))


def test_adam_and_polyak_match_jax():
    _, jstate = _jax_state()
    state = train_state_from_numpy(_np(jstate))
    rng = np.random.default_rng(2)
    grads_np = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                            _np(jstate.critic_params))
    grads = train_state_from_numpy(_np(jstate)._replace(critic_params=grads_np)).critic_params
    p, opt = state.critic_params, state.critic_opt
    jp, jopt = jstate.critic_params, jstate.critic_opt
    for _ in range(3):   # several steps: the bias correction follows the count
        p, opt = adam_update(p, grads, opt, 1e-3)
        jp, jopt = jax.jit(jax_adam)(jp, grads_np, jopt, 1e-3)
    _close_trees(p, _np(jp))
    _close_trees(opt.mu, _np(jopt.mu))
    _close_trees(opt.nu, _np(jopt.nu))
    assert int(opt.count) == int(jopt.count) == 3
    _close_trees(polyak_update(p, state.target_critic_params, 5e-3),
                 _np(jax_polyak(jp, jstate.target_critic_params, 5e-3)))


def test_eager_steps_match_jax_learner_step():
    """K eager autograd steps of the port against K calls of the JAX
    make_learner_step, from the same JAX-made state (learner.py's oracle)."""
    jcfg, jstate = _jax_state()
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cpu")
    packed = types.pack_batch_np(_fields(4, lead=(K, B)))
    jstep, step = jax.jit(jax_step(jcfg, 2.0)), make_learner_step(cfg, 2.0)
    state = train_state_from_numpy(_np(jstate))
    for k in range(K):
        jout = jstep(jstate, jax_types.unpack_batch(jnp.asarray(packed[k]), OBS, ACT))
        out = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT))
        jstate, state = jout.state, out.state
        _close(out.td_errors.numpy(), np.asarray(jout.td_errors))
        for name in METRIC_KEYS:
            _close(float(out.metrics[name]), float(jout.metrics[name]), 5e-5, ATOL)
    ref = _np(jstate)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        _close_trees(getattr(state, group), getattr(ref, group))
    for opt in ("actor_opt", "critic_opt"):
        _close_trees(getattr(state, opt).mu, getattr(ref, opt).mu)
        _close_trees(getattr(state, opt).nu, getattr(ref, opt).nu)
        assert int(getattr(state, opt).count) == int(getattr(ref, opt).count) == K
    assert int(state.step) == int(ref.step) == K


def test_train_state_round_trip():
    _, jstate = _jax_state()
    ref = _np(jstate)
    back = train_state_to_numpy(train_state_from_numpy(ref))
    assert back._fields == ref._fields[:len(back._fields)]
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)


def test_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    shared = set(ours) & set(theirs)
    assert len(shared) >= 30
    # repr, so that a nan default (target_entropy's) equals the other's nan.
    assert {k: repr(ours[k]) for k in shared} == {k: repr(theirs[k]) for k in shared}
    assert set(ours) - set(theirs) == {"device"}


@pytest.mark.parametrize("override", [
    dict(policy_delay=2), dict(fused_chunk="sometimes"),
    dict(sac=True, fused_update=True),
    dict(data_axis=0), dict(compute_dtype="float16"), dict(guardrails=True, fused_chunk="on"),
    dict(data_axis=-2), dict(model_axis=0), dict(host_replay=True, data_axis=2),
    dict(serve_actors=True, data_axis=2), dict(transport="tcp"), dict(fused_mesh="on"),
    # (`slice` faults are in the slice since the sharded replay; the device
    # actors and the guarded learner on two ranks since the data plane on
    # ranks, so these two cases now hold the refusals left.)
    dict(action_insert_layer=5), dict(serve_actors=True, model_axis=2),
])
def test_options_outside_the_slice_raise(override):
    if override in _ON_RANKS_NOW:
        # The host replay and serving on more than one rank are ported: the
        # JAX package takes them, and so does the port, field for field.
        theirs, ours = JaxConfig(**override), DDPGConfig(**override)
        for f in dataclasses.fields(JaxConfig):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            assert a == b or a != a and b != b, f.name   # NaN: an 'auto' field
        return
    name = next(iter(override))
    with pytest.raises(ValueError, match=name):
        DDPGConfig(**override)


_ON_RANKS_NOW = [dict(host_replay=True, data_axis=2), dict(serve_actors=True, data_axis=2),
                 dict(serve_actors=True, model_axis=2)]


@pytest.mark.parametrize("override", [
    dict(fused_update=True), dict(distributional=True, num_atoms=300, fused_update=True),
    dict(critic_l2=0.01), dict(action_insert_layer=0), dict(action_insert_layer=2),
    dict(critic_hidden=(64,)), dict(fused_chunk="off"),
    dict(data_axis=2), dict(fused_mesh="off"), dict(checkpoint_dir="/x"),
    dict(transport="shm"), dict(actor_backend="device", data_axis=2),
    dict(guardrails=True, data_axis=2),
])
def test_configs_outside_the_kernel_envelope_construct(override):
    """The scan route admits what the chunk kernel's envelope leaves out
    (and the device actors and the guarded learner on two ranks)."""
    cfg = DDPGConfig(**override)
    assert all(getattr(cfg, k) == v for k, v in override.items())


def test_from_flags():
    cfg = DDPGConfig.from_flags(["--actor_hidden=64,64", "--batch_size", "32",
                                 "--device=cpu", "--max_learn_ratio=1.5"])
    assert cfg.actor_hidden == (64, 64) and cfg.batch_size == 32
    assert cfg.device == "cpu" and cfg.max_learn_ratio == 1.5
    with pytest.raises(ValueError, match="distributional"):
        DDPGConfig.from_flags(["--v_min=auto", "--v_max=auto"])
