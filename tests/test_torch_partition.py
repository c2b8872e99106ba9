"""The port's partition-rule engine (parallel/partition.py), its tensor-
parallel config checks and the rank grid's arithmetic, against the JAX
package's parallel/partition.py, config.py and make_mesh, in this process
(after the JAX package's tests/test_partition.py).

- The spec trees: for the cfg_kw matrix of the JAX package's
  test_rules_reproduce_legacy_pspec (seed DDPG, TD3's rank-3 ensemble
  leaves, SAC, the distributional head, 400x300, three 64-wide layers), at
  Pendulum's shapes (obs 3, act 1: the critic's action-insert layer is
  hidden + 1 wide, replicated) and the benchmark's (obs 17, act 6: it is
  row-parallel at M = 2), at M = 1, 2 and 4, the port's state_pspec equals
  JAX's, each JAX PartitionSpec compared as a tuple.
- The engine's semantics (first match, trailing alignment, indivisible ->
  replicated, scalars, unmatched and outranking specs) with JAX's
  messages; the Adam moments and targets take the params' specs; the
  layer kinds the Megatron apply runs; shard_tree's blocks rebuild the
  logical tree.
- The config: JAX's tensor-parallel checks and messages; serving, the
  host replay, the device actors, the monolith and the guarded learner
  under model_axis > 1 are accepted with JAX's fields;
  resolve_data_axis on a grid raises as make_mesh does; mode='explicit'
  is data-parallel only, with JAX's message.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel import partition as jax_partition

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import state_items, train_state_from_numpy
from distributed_ddpg_tpu_torch.parallel import partition
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.parallel.mesh import resolve_data_axis

torch.set_num_threads(1)

CFG_KW = [
    {},
    dict(twin_critic=True, target_noise=0.1),
    dict(sac=True),
    dict(distributional=True),
    dict(actor_hidden=(400, 300), critic_hidden=(400, 300)),
    dict(actor_hidden=(64, 64, 64), critic_hidden=(64, 64, 64)),
]
CFG_IDS = ["ddpg", "td3", "sac", "d4pg", "400x300", "3x64"]


def _as_tuples(tree):
    """A JAX spec tree with every PartitionSpec as a plain tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _same_tree(ours, theirs, path="state"):
    """Structural equality of two spec trees (TrainState/OptState fields by
    name, tuples of {w, b} layers, spec tuples at the leaves)."""
    if theirs is None or ours is None:
        assert ours is None and theirs is None, path
    elif hasattr(theirs, "_fields"):
        for f in theirs._fields:
            _same_tree(getattr(ours, f), getattr(theirs, f), f"{path}.{f}")
    elif isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _same_tree(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(ours, tuple) and all(e is None or isinstance(e, str) for e in ours):
        assert ours == tuple(theirs), (path, ours, theirs)
    else:
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _same_tree(a, b, f"{path}/{i}")


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("shape", [(3, 1), (17, 6)], ids=["pendulum", "bench"])
@pytest.mark.parametrize("cfg_kw", CFG_KW, ids=CFG_IDS)
def test_spec_trees_match_jax_state_pspec(cfg_kw, shape, m):
    jcfg = JaxConfig(**cfg_kw)
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, *shape, 0))
    mesh = jax_mesh.make_mesh(-1, m)
    theirs = _as_tuples(jax_partition.state_pspec(jstate, mesh))
    ours = partition.state_pspec(train_state_from_numpy(jstate), m)
    _same_tree(ours, theirs)


def test_rule_engine_semantics():
    leaf = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    # first match wins
    rules = [(r"head/w$", (None, None)), (r"/w$", (None, "model"))]
    spec = partition.match_partition_rules(rules, {"head": {"w": leaf(8, 4)}}, 2)
    assert spec["head"]["w"] == (None, None)
    # a rank-2 spec covers a rank-3 stacked leaf (trailing alignment)
    spec = partition.match_partition_rules([(r"w$", (None, "model"))],
                                           ({"w": leaf(2, 8, 4)},), 2)
    assert spec[0]["w"] == (None, None, "model")
    # indivisible -> the whole leaf replicated
    spec = partition.match_partition_rules([(r"w$", (None, "model"))],
                                           ({"w": leaf(8, 5)},), 2)
    assert spec[0]["w"] == (None, None)
    # scalars replicate without the table
    assert partition.match_partition_rules([], {"count": leaf()}, 2)["count"] == ()


@pytest.mark.parametrize("case", ["unmatched", "outrank"])
def test_rule_engine_errors_match_jax(case):
    leaf = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    if case == "unmatched":
        tree, ours, theirs = ({"w": leaf(4, 4)},), [(r"nope", ())], [(r"nope", P())]
    else:
        tree, ours, theirs = ({"b": leaf(4)},), [(r"b$", (None, "model"))], \
            [(r"b$", P(None, "model"))]
    with pytest.raises(jax_partition.PartitionRuleError) as want:
        jax_partition.match_partition_rules(theirs, tree, 2)
    with pytest.raises(partition.PartitionRuleError) as got:
        partition.match_partition_rules(ours, tree, 2)
    assert str(got.value) == str(want.value).replace("PartitionSpec(None, 'model')",
                                                     "(None, 'model')")


def test_state_pspec_moments_and_targets_take_the_params_specs():
    jstate = jax.tree.map(np.asarray, jax_init(JaxConfig(sac=True), 4, 2, 0))
    sp = partition.state_pspec(train_state_from_numpy(jstate), 2)
    assert sp.actor_opt.mu == sp.actor_opt.nu == sp.target_actor_params == sp.actor_params
    assert sp.critic_opt.mu == sp.target_critic_params == sp.critic_params
    assert sp.step == sp.actor_opt.count == sp.log_alpha == sp.alpha_opt.count == ()


@pytest.mark.parametrize("shape,kinds", [((3, 1), ("col", "rep", "rep")),
                                         ((17, 6), ("col", "row", "rep"))],
                         ids=["pendulum", "bench"])
def test_layer_kinds_of_the_critic(shape, kinds):
    """Trap 1's two shapes at full width: 256 + 1 does not divide 2 (the
    insert layer replicated), 256 + 6 does (row-parallel)."""
    jstate = jax.tree.map(np.asarray, jax_init(JaxConfig(), *shape, 0))
    sp = partition.state_pspec(train_state_from_numpy(jstate), 2)
    assert partition.layer_kinds(sp.critic_params) == kinds
    assert partition.layer_kinds(sp.actor_params) == ("col", "row", "rep")
    bad = ({"w": (None, "model"), "b": (None,)},)
    with pytest.raises(partition.PartitionRuleError, match="no Megatron split"):
        partition.layer_kinds(bad)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_shard_tree_blocks_rebuild_the_logical_tree(m):
    """Each model rank's shards are the logical leaves cut into m
    contiguous blocks along the spec's dim (block r on rank r), and the
    replicated leaves whole."""
    jstate = jax.tree.map(np.asarray, jax_init(JaxConfig(twin_critic=True, target_noise=0.1),
                                               17, 6, 0))
    logical = train_state_from_numpy(jstate)
    specs = partition.state_pspec(logical, m)
    ranks = [dict(state_items(partition.shard_tree(logical, specs, r, m))) for r in range(m)]
    split = 0
    for path, whole in state_items(logical):
        parts = [shards[path] for shards in ranks]
        dims = [d for d in range(whole.dim()) if parts[0].shape[d] != whole.shape[d]]
        if not dims:
            assert all(torch.equal(p, whole) for p in parts), path
            continue
        split += 1
        assert len(dims) == 1 and all(p.shape[dims[0]] * m == whole.shape[dims[0]]
                                      for p in parts), path
        assert torch.equal(torch.cat(parts, dim=dims[0]), whole), path
    assert (split > 0) == (m > 1)


@pytest.mark.parametrize("over", [
    dict(model_axis=0), dict(model_axis=2, backend="native"),
    dict(model_axis=2, fused_chunk="on"), dict(model_axis=2, actor_hidden=(255, 256)),
    dict(model_axis=4, critic_hidden=(256, 130)),
], ids=["below-one", "native", "fused-chunk-on", "actor-hidden", "critic-hidden"])
def test_tp_config_checks_match_jax(over):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**over)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**over)
    assert str(ours.value) == str(theirs.value)


def test_tp_configs_jax_accepts_and_the_port_runs():
    for cfg in (DDPGConfig(model_axis=2), DDPGConfig(model_axis=2, fused_chunk="off"),
                DDPGConfig(model_axis=2, replay_sharding="sharded", fused_update=True),
                DDPGConfig(model_axis=4, distributional=True, prioritized=True)):
        assert cfg.model_axis > 1


@pytest.mark.parametrize("over", [
    dict(serve_actors=True), dict(actor_backend="device", num_actors=0),
    dict(backend="jax_ondevice"), dict(host_replay=True), dict(guardrails=True),
], ids=["serve", "device-actors", "ondevice", "host-replay", "guardrails"])
def test_one_rank_paths_are_refused_under_model_axis(over):
    theirs = JaxConfig(model_axis=2, **over)     # legal in the JAX package
    # Every one of them runs on a grid now (tests/test_torch_dataplane_ranks.py,
    # test_torch_host_replay_ranks.py, test_torch_serve_ranks.py; the name is
    # kept from when they were refused): accepted with JAX's fields.
    ours = DDPGConfig(model_axis=2, **over)
    for f in dataclasses.fields(JaxConfig):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a == b or a != a and b != b, f.name   # NaN: an 'auto' field


@pytest.mark.parametrize("world,data_axis,m", [(4, -1, 2), (4, 2, 2), (3, -1, 2), (4, 1, 2),
                                               (2, -1, 2)])
def test_resolve_data_axis_on_a_grid_matches_make_mesh(world, data_axis, m):
    cfg = DDPGConfig(data_axis=data_axis, model_axis=m)
    devices = jax.devices()[:world]
    try:
        want = jax_mesh.make_mesh(data_axis, m, devices=devices).shape["data"]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_data_axis(cfg, world)
        assert str(got.value) == str(e)
    else:
        assert resolve_data_axis(cfg, world) == want


def test_learner_modes_match_jax():
    with pytest.raises(ValueError, match="data-parallel only"):
        ShardedLearner(DDPGConfig(model_axis=2, device="cpu"), 4, 2, 1.0, mode="explicit")
    with pytest.raises(ValueError) as ours:
        ShardedLearner(DDPGConfig(device="cpu"), 4, 2, 1.0, mode="pmap")
    assert str(ours.value) == "mode must be 'auto' or 'explicit', got 'pmap'"
    lrn = ShardedLearner(DDPGConfig(device="cpu", actor_hidden=(16, 16),
                                    critic_hidden=(16, 16)), 4, 2, 1.0, mode="explicit")
    assert lrn.mode == "explicit" and lrn.model_axis == 1 and lrn.tp is None
