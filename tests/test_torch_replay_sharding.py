"""The port's sharded device replay (replay/device.py with
replay_sharding='sharded', the owner-masked gather and the sharded PER
of parallel/learner.py) against its replicated placement and the JAX
package's, on the CPU, after the JAX package's tests/test_replay_sharding.py.

- In this process, D replays with a DataGroup each (rank 0..D-1, no
  process group: an ingest is local to its rank) take the same ragged row
  stream through coalesced ships and a wrap: their local slots, read in
  logical order (p on rank p % D, slot p // D), are the replicated ring
  bit for bit, PER's stamps too; each row lands once, on its owner; the
  storage and the bytes each rank landed are measured (replay_*). The
  slice states and the N -> M reshard: split_slice_state and
  merge_slice_states against the JAX functions on the same numpy states,
  the 1/2/4 -> 1/2/4 matrix through each rank's slice_state_dict and
  load_state_dict, and merge's refusals with JAX's messages. The config's
  checks and messages against JAX's.
- On D = 2 and D = 4 gloo ranks (tests/torch_mesh_child.py running
  tests/torch_shard_child.py, one launch a world): a sharded uniform
  chunk bit for bit the replicated one (two chunks, the stock update and
  K2's plain version); on D = 2 the sharded chunk against JAX's sharded
  chunk on 2 of the conftest's CPU devices with JAX's indices (state and
  td within rtol 2e-5 / atol 1e-6, the metrics 5e-5: the scan route's
  tolerances of tests/test_torch_mesh.py); the sharded PER draw against
  JAX's make_sharded_per_draw with the same uniforms on integer
  priorities (every sum exact): indices equal, weights within 1e-6; a
  PER chunk sharded and replicated on one draw: the priorities owner-only
  and equal to the replicated ones, max_priority equal; reward_sample the
  same across placements; draws clamped to the live rows and
  proportional to the mass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.replay import device as jax_device
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxReplay

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
from distributed_ddpg_tpu_torch.parallel.mesh import DataGroup
from distributed_ddpg_tpu_torch.replay.device import (
    DevicePrioritizedReplay,
    DeviceReplay,
    ReplayUsageError,
    merge_slice_states,
    split_slice_state,
)
from test_torch_mesh import _close, _mid_training, _rows as mesh_rows
from torch_mesh_child import run_ranks, state_arrays

torch.set_num_threads(1)

OBS, ACT, B, K = 5, 3, 8, 3
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, FILL, BLOCK = 512, 256, 128
BETA = 0.6
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
WIDTH = 2 * OBS + ACT + 3


def _stream(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, WIDTH)).astype(np.float32)


def _groups(d: int):
    return [DataGroup(rank=r, world_size=d, device=torch.device("cpu")) for r in range(d)]


def _logical(parts):
    """Each rank's local [capacity / D, ...] slots as the logical ring."""
    return np.stack(parts, 0).swapaxes(0, 1).reshape(-1, *parts[0].shape[1:])


# --- ingest parity, in this process ---------------------------------------------


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_sharded_ingest_matches_replicated_through_a_wrap(d, per):
    cls = DevicePrioritizedReplay if per else DeviceReplay
    cap, block = 256, 32
    ref = cls(cap, OBS, ACT, "cpu", block_size=block)
    shards = [cls(cap, OBS, ACT, "cpu", block_size=block, replay_sharding="sharded", group=g)
              for g in _groups(d)]
    rng = np.random.default_rng(1)
    data = _stream(0, 700)
    pos = 0
    for size in rng.integers(1, 90, 40):    # sub-block trickles and multi-block bursts
        chunk = data[pos:pos + size]
        pos += size
        for rep in [ref] + shards:
            rep.add_packed(chunk)
        if pos >= len(data) - 90:
            break
    for rep in [ref] + shards:
        rep.flush()
        assert (rep.ptr, rep.size) == (ref.ptr, ref.size)
    assert ref.size == cap                      # the ring wrapped
    np.testing.assert_array_equal(_logical([s.storage.numpy() for s in shards]),
                                  ref.storage.numpy())
    if per:
        np.testing.assert_array_equal(_logical([s.priorities.numpy() for s in shards]),
                                      ref.priorities.numpy())
    rows_landed = 0
    for s in shards:
        snap = s.shard_snapshot([t.local_fill for t in shards])
        assert snap["replay_shard_count"] == d
        assert snap["replay_device_storage_bytes"] == cap * WIDTH * 4 // d
        assert snap["replay_shard_fill_min"] == snap["replay_shard_fill_max"] == cap // d
        assert snap["replay_ingest_bytes_per_row"] == WIDTH * 4 / d
        rows_landed += snap["replay_ingest_bytes"] // (WIDTH * 4)
    # Every shipped row landed once, on one rank.
    assert rows_landed == ref.shard_snapshot()["replay_ingest_bytes"] // (WIDTH * 4)
    assert set(ref.shard_snapshot()) == {k for k in jax_device.ReplayShardStats().snapshot()}


def test_sharded_insert_device_rows_and_its_alignment():
    d = 2
    ref = DevicePrioritizedReplay(64, OBS, ACT, "cpu", block_size=8)
    shards = [DevicePrioritizedReplay(64, OBS, ACT, "cpu", block_size=8,
                                      replay_sharding="sharded", group=g) for g in _groups(d)]
    data = torch.from_numpy(_stream(3, 80))
    for lo, hi in ((0, 24), (24, 48), (48, 80)):        # the last insert wraps
        for rep in [ref] + shards:
            rep.insert_device_rows(data[lo:hi])
    np.testing.assert_array_equal(_logical([s.storage.numpy() for s in shards]),
                                  ref.storage.numpy())
    np.testing.assert_array_equal(_logical([s.priorities.numpy() for s in shards]),
                                  ref.priorities.numpy())
    with pytest.raises(ValueError, match="do not divide over 2 shards"):
        shards[0].insert_device_rows(data[:3])


@pytest.mark.parametrize("over, match", [
    (dict(capacity=100), "must divide evenly over 3 shards"),
    (dict(block_size=8), "block_size 8 must divide evenly over 3 shards"),
])
def test_replay_checks_its_alignment_as_jax(over, match):
    kw = {**dict(capacity=96, block_size=12), **over}
    g = _groups(3)[0]
    with pytest.raises(ValueError, match=match) as ours:
        DeviceReplay(kw["capacity"], OBS, ACT, "cpu", block_size=kw["block_size"],
                     replay_sharding="sharded", group=g)
    mesh = jax_mesh.make_mesh(3, 1, devices=jax.devices()[:3])
    with pytest.raises(ValueError) as theirs:
        JaxReplay(kw["capacity"], OBS, ACT, mesh=mesh, block_size=kw["block_size"],
                  replay_sharding="sharded")
    assert str(ours.value) == str(theirs.value)


def test_multi_writer_state_dict_raises_and_one_rank_is_one_slice():
    g = _groups(2)[1]
    rep = DevicePrioritizedReplay(64, OBS, ACT, "cpu", block_size=8,
                                  replay_sharding="sharded", group=g)
    rep.add_packed(_stream(4, 40))
    with pytest.raises(ReplayUsageError, match="single-writer"):
        rep.state_dict()
    sl = rep.slice_state_dict()
    np.testing.assert_array_equal(sl["positions"], np.arange(1, 40, 2))
    one = DevicePrioritizedReplay(64, OBS, ACT, "cpu", block_size=8, replay_sharding="sharded")
    one.add_packed(_stream(4, 40))
    whole = one.slice_state_dict()
    np.testing.assert_array_equal(whole["positions"], np.arange(40))
    np.testing.assert_array_equal(whole["rows"][1::2], sl["rows"])
    np.testing.assert_array_equal(whole["priorities"][1::2], sl["priorities"])


# --- slice states and the reshard ---------------------------------------------------


def _state(n=37, cap=64, per=True, seed=6):
    rng = np.random.default_rng(seed)
    st = {"packed": rng.standard_normal((n, WIDTH)).astype(np.float32),
          "ptr": np.asarray(n % cap), "size": np.asarray(n)}
    if per:
        st["priorities"] = rng.uniform(0.1, 3.0, n).astype(np.float32)
        st["max_priority"] = np.asarray(3.5, np.float32)
    return st


@pytest.mark.parametrize("n_from", [1, 2, 4])
@pytest.mark.parametrize("n_to", [1, 2, 4])
def test_reshard_matrix_matches_jax(n_from, n_to):
    """A state split over n_from writers (as JAX's split_slice_state does),
    merged (as JAX's merge does) and loaded into n_to ranks: every rank's
    slots are the logical ring's, and its slice is JAX's split at n_to."""
    cap = 64
    st = _state(n=40, cap=cap)
    ours = split_slice_state(st, n_from, cap)
    theirs = jax_device.split_slice_state(st, n_from, cap)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    merged = merge_slice_states(ours[::-1])
    jmerged = jax_device.merge_slice_states(theirs)
    for key in jmerged:
        np.testing.assert_array_equal(merged[key], jmerged[key], err_msg=key)
    reps = [DevicePrioritizedReplay(cap, OBS, ACT, "cpu", block_size=8,
                                    replay_sharding="sharded",
                                    group=g if n_to > 1 else None) for g in _groups(n_to)]
    for rep in reps:
        rep.load_state_dict(merged)
    want = jax_device.split_slice_state(jmerged, n_to, cap)
    for rep, w in zip(reps, want):
        got = rep.slice_state_dict()
        for key in w:
            np.testing.assert_array_equal(got[key], w[key], err_msg=key)


@pytest.mark.parametrize("fault", ["hole", "overlap", "fork"])
def test_merge_refuses_holes_overlaps_and_forks_as_jax(fault):
    slices = split_slice_state(_state(), 2, 64)
    if fault == "hole":
        slices = slices[:1]
    elif fault == "overlap":
        slices = [slices[0], slices[0]]
    else:
        slices[1] = dict(slices[1], ptr=np.asarray(5, np.int64))
    with pytest.raises(ReplayUsageError) as ours:
        merge_slice_states(slices)
    with pytest.raises(jax_device.ReplayUsageError) as theirs:
        jax_device.merge_slice_states(slices)
    assert str(ours.value) == str(theirs.value)


# --- the config ---------------------------------------------------------------------


@pytest.mark.parametrize("over", [
    dict(replay_sharding="sharded", fused_chunk="on"),
    dict(replay_sharding="sharded", data_axis=3, replay_capacity=1000),
    dict(replay_sharding="sharded", data_axis=4, actor_backend="device", num_actors=0,
         device_actor_envs=3, device_actor_chunk=5),
], ids=["fused_chunk_on", "capacity", "device_actor_rows"])
def test_sharded_config_checks_match_jax(over):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**over)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**over)
    assert str(ours.value) == str(theirs.value)


def test_sharded_is_accepted_and_model_axis_still_refused():
    from distributed_ddpg_tpu_torch import config as config_mod

    # model_axis is in the port (the tensor-parallel learner): the sharded
    # replay composes with it; the device actors beside it are still
    # refused with item 10's message.
    assert not hasattr(config_mod, "_NOT_IN_SLICE")
    assert DDPGConfig(replay_sharding="sharded").replay_sharding == "sharded"
    assert DDPGConfig(replay_sharding="sharded", data_axis=2,
                      replay_capacity=1024).data_axis == 2
    assert DDPGConfig(replay_sharding="sharded", model_axis=2).model_axis == 2
    with pytest.raises(ValueError, match="item 10"):
        DDPGConfig(model_axis=2, replay_sharding="sharded", actor_backend="device",
                   num_actors=0)


# --- on gloo ranks --------------------------------------------------------------------


def _suite_inputs(d: int, seed: int):
    """The suite's inputs for D ranks: rows, integer priorities over the
    live rows (exact sums), uniforms, and one PER draw (pidx, pweights)."""
    rng = np.random.default_rng(seed)
    rows = mesh_rows(seed)
    n_live = FILL
    prios = np.zeros(CAP, np.float32)
    prios[:n_live] = rng.integers(1, 9, n_live)
    # JAX's draw makes its uniforms from a key, replicated: the same ones.
    uniform = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (K, B * d)))
    pidx = rng.integers(0, n_live, (K, B * d))
    pidx[0, :4] = pidx[0, 0]                       # a duplicate: the last write wins
    pweights = rng.uniform(0.5, 1.0, (K, B * d)).astype(np.float32)
    return dict(rows=rows, prios=prios, n_live=np.int64(n_live), uniform=uniform,
                key=np.int64(seed), pidx=pidx, pweights=pweights)


def _spec(**extra):
    cfg = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3)
    return dict(kind="shard_suite", config=cfg, obs=OBS, act=ACT, k=K, scale=SCALE,
                offset=OFFSET, capacity=CAP, block=BLOCK, beta=BETA, **extra)


def _jax_learner(d, fused_update):
    mesh = jax_mesh.make_mesh(d, 1, devices=jax.devices()[:d])
    jcfg = JaxConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     fused_update=fused_update, replay_sharding="sharded")
    return jcfg, JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=mesh, chunk_size=K, unroll=1,
                            replay_sharding="sharded")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of the suite on 2 ranks, with JAX's sharded chunk, draw
    and state made here."""
    d = 2
    inputs = _suite_inputs(d, 8)
    jcfg, jl = _jax_learner(d, False)
    jstate = _mid_training(jcfg)
    _, sub = jax.random.split(jl._key)
    idx = np.array(jax.random.randint(sub, (K, B * d), 0, FILL))
    jax_out = {}
    for fu in (False, True):
        jcfg, jl = _jax_learner(d, fu)
        jl.state = jax.device_put(jstate, jl._state_sharding)
        jrep = JaxReplay(CAP, OBS, ACT, mesh=jl.mesh, block_size=BLOCK,
                         replay_sharding="sharded")
        jrep.add_packed(inputs["rows"])
        jax_out[fu] = jax.tree.map(np.asarray, jl.run_sample_chunk(jrep))
    results = run_ranks(tmp_path_factory.mktemp("two"), _spec(), dict(
        idx=idx, **inputs, **state_arrays(jstate)), world=d)
    return d, inputs, jax_out, results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = 4
    inputs = _suite_inputs(d, 9)
    return d, inputs, None, run_ranks(tmp_path_factory.mktemp("four"), _spec(), inputs,
                                      world=d)


def _jax_sharded_draw(d, prios, n_live, uniform_key, shape):
    mesh = jax_mesh.make_mesh(d, 1, devices=jax.devices()[:d])
    draw = jax_device.make_sharded_per_draw(mesh)
    scalar = NamedSharding(mesh, P())
    fn = jax.jit(lambda k, p, s: draw(k, p, s, shape, jnp.float32(BETA)),
                 in_shardings=(scalar, NamedSharding(mesh, P("data")), scalar),
                 out_shardings=(scalar, scalar))
    # The JAX priorities live at its strided physical layout.
    phys = prios.reshape(-1, d).T.reshape(-1)
    return fn(uniform_key, jax.device_put(jnp.asarray(phys), NamedSharding(mesh, P("data"))),
              jnp.int32(n_live))


@pytest.mark.parametrize("fused_update", [False, True], ids=["stock", "k2"])
def test_sharded_chunk_matches_jax_sharded_chunk(two_ranks, fused_update):
    d, _, jax_out, results = two_ranks
    jout = jax_out[fused_update]
    pre = f"jax{int(fused_update)}/"
    for r, res in enumerate(results):
        assert str(res[pre + "route"]) == "scan"
        for key, want in state_arrays(jout.state).items():
            if key.endswith("count") or key == "state/step":
                assert int(res[pre + key]) == int(want), (r, key)
            else:
                _close(f"rank {r} {key}", res[pre + key], want)
        _close(f"rank {r} td", res[pre + "td"], jout.td_errors)
        for i, name in enumerate(METRIC_KEYS):
            _close(f"rank {r} {name}", res[pre + "metrics"][i], jout.metrics[name],
                   METRIC_RTOL, ATOL)


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
@pytest.mark.parametrize("fused_update", [False, True], ids=["stock", "k2"])
def test_sharded_chunk_is_the_replicated_chunk_bit_for_bit(world, fused_update, request):
    _, _, _, results = request.getfixturevalue(world)
    pre = f"bitid{int(fused_update)}/"
    for res in results:
        np.testing.assert_array_equal(res[pre + "sharded_state"], res[pre + "replicated_state"])
        np.testing.assert_array_equal(res[pre + "sharded_td"].view(np.int32),
                                      res[pre + "replicated_td"].view(np.int32))
    for res in results[1:]:
        np.testing.assert_array_equal(res[pre + "sharded_state"], results[0][pre + "sharded_state"])


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_sharded_per_draw_matches_jax_on_exact_sums(world, request):
    """The ranks drew with the uniforms JAX's draw makes from the key (the
    same on every rank), on integer priorities: JAX's indices, its weights
    within 1e-6."""
    d, inputs, _, results = request.getfixturevalue(world)
    jidx, jw = _jax_sharded_draw(d, inputs["prios"], int(inputs["n_live"]),
                                 jax.random.PRNGKey(int(inputs["key"])),
                                 inputs["uniform"].shape)
    for res in results:
        np.testing.assert_array_equal(res["draw/idx"], np.array(jidx))
        _close("weights", res["draw/weights"], np.array(jw), 1e-6, 0.0)


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_sharded_per_chunk_writes_the_replicated_priorities_owner_only(world, request):
    _, _, _, results = request.getfixturevalue(world)
    for res in results:
        np.testing.assert_array_equal(res["per/sharded_prios"].view(np.int32),
                                      res["per/replicated_prios"].view(np.int32))
        assert res["per/sharded_maxp"].tobytes() == res["per/replicated_maxp"].tobytes()
        np.testing.assert_array_equal(res["per/sharded_state"], res["per/replicated_state"])
        np.testing.assert_array_equal(res["per/sharded_td"], res["per/replicated_td"])


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_reward_sample_is_the_same_across_placements(world, request):
    _, _, _, results = request.getfixturevalue(world)
    for res in results:
        for max_n in (100000, 37):
            np.testing.assert_array_equal(res[f"reward/sharded_{max_n}"],
                                          res[f"reward/replicated_{max_n}"])


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_sharded_draws_stay_live_and_follow_the_mass(world, request):
    d, _, _, results = request.getfixturevalue(world)
    for res in results:
        assert res["clamp/idx"].min() >= 0 and res["clamp/idx"].max() < 57
        assert (res["mass/idx"] == 37).mean() > 0.9
        w = res["mass/weights"]
        assert np.isfinite(w).all() and w.max() == 1.0
        assert int(res["bytes/storage"]) == CAP * WIDTH * 4 // d
        assert int(res["bytes/prios"]) == CAP * 4 // d
    for res in results[1:]:
        np.testing.assert_array_equal(res["clamp/idx"], results[0]["clamp/idx"])


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_the_owner_masked_gather_keeps_negative_zeros(world, request):
    """Non-owners contribute -0.0, so the summed gather is every row bit for
    bit, -0.0 included (a +0.0 fill, the JAX gather's psum of where(owner,
    rows, 0.0), turns an owner's -0.0 into +0.0)."""
    _, _, _, results = request.getfixturevalue(world)
    for res in results:
        assert (np.signbit(res["gather/want"]) & (res["gather/want"] == 0)).any()
        np.testing.assert_array_equal(res["gather/rows"].view(np.int32),
                                      res["gather/want"].view(np.int32))
