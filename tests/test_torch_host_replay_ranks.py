"""The host replay on more than one rank (train.py, ShardedLearner.share_chunk)
and the configurations that come with it, on the CPU against the JAX
package.

- (a) Host-fed rows: at D = 2 and on a (1, 2) grid, rank 0's host replay
  and prefetcher draw the chunk and every rank gets it through
  share_chunk; each rank's columns are bit for bit the shard JAX's
  ChunkPrefetcher + put_chunk place on that device (P(None, 'data')) for
  the same replay contents and generator state. The chunk's end state and
  td match JAX's run_chunk_async on the same mesh within
  tests/test_torch_mesh.py's scan-route tolerance (rtol 2e-5, atol 1e-6),
  with the fused update (K2's plain version here) and without.
- (b) Host PER at D = 2: the priorities, max priority and beta after a
  chunk are JAX's _host_per_update's (its train.py:2154-2163, replayed
  here on JAX's replay with its td): the same slots, priorities within the
  td's tolerance, beta exact.
- (c) train() on two gloo ranks with --host_replay (uniform with K2, PER,
  guarded, and on a 1 x 2 grid) ends with identical replicas; a resume
  from rank 0's checkpoint (which carries the host replay) finishes too.
- (f) The config matrix: {host_replay, serve_actors, serve_backend,
  prioritized, strict_sync, guardrails, fused_update} with data_axis=2 or
  model_axis=2: the port accepts exactly what the JAX DDPGConfig accepts
  and refuses the rest with its message, string for string.

The rank jobs are tests/torch_mesh_child.py's (kinds "host_chunk" and
"train"; the host chunk's case in tests/torch_ranks_child.py).
"""

from __future__ import annotations

import itertools
import json
import math

import jax
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.parallel.prefetch import ChunkPrefetcher as JaxPrefetcher
from distributed_ddpg_tpu.replay import make_replay as jax_make_replay

from distributed_ddpg_tpu_torch.config import DDPGConfig
from torch_mesh_child import run_ranks, state_arrays

torch.set_num_threads(1)

OBS, ACT, B, K = 3, 2, 8, 3
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, FILL = 300, 200
BETA = 0.55
RTOL, ATOL = 2e-5, 1e-6          # tests/test_torch_mesh.py's scan route
FIELDS = ("obs", "action", "reward", "discount", "next_obs")


def _fields(seed=11):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.standard_normal((FILL, OBS)).astype(np.float32),
                action=rng.uniform(-2, 2, (FILL, ACT)).astype(np.float32),
                reward=(3.0 * rng.standard_normal(FILL)).astype(np.float32),
                discount=np.where(rng.random(FILL) < 0.1, 0.0, 0.99).astype(np.float32),
                next_obs=rng.standard_normal((FILL, OBS)).astype(np.float32))


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _jax_chunk(common, data, model, per):
    """JAX's side: its replay and prefetcher at the same seed, its
    put_chunk's per-device shards and run_chunk_async's output on a
    (data, model) mesh, and under PER _host_per_update replayed."""
    jcfg = JaxConfig(replay_capacity=CAP, **common)
    mesh = jax_mesh.make_mesh(data, model, devices=jax.devices()[:data * model])
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=mesh, chunk_size=K, unroll=1)
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, OBS, ACT, seed=jcfg.seed))
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rep = jax_make_replay(jcfg, OBS, ACT)
    fields = _fields()
    rep.add_batch(*(fields[f] for f in FIELDS))
    extra = {}
    if per:
        extra = dict(prio_idx=np.arange(40), prio_td=np.linspace(0.2, 3.0, 40))
        rep.update_priorities(extra["prio_idx"], extra["prio_td"])
    drawn = JaxPrefetcher(rep, jl.put_chunk, jl.global_batch, K)._sample_chunk()
    indices = drawn.pop("indices")
    device_chunk = jl.put_chunk(drawn)
    shards = {d.id: np.asarray(s.data) for s in device_chunk.addressable_shards
              for d in [s.device]}
    per_device = [shards[d.id] for d in mesh.devices.reshape(-1)]
    out = jax.tree.map(np.asarray, jl.run_chunk_async(device_chunk))
    if per:
        rep.update_priorities(indices.reshape(-1), np.asarray(out.td_errors).reshape(-1))
        rep.set_beta(BETA)
    arrays = dict(**fields, **extra, **state_arrays(jstate))
    return dict(indices=indices, per_device=per_device, out=out, replay=rep, arrays=arrays)


@pytest.mark.parametrize("grid,extra", [
    ((2, 1), dict(fused_update=True)),
    ((2, 1), dict(prioritized=True)),
    ((1, 2), dict(fused_update=True)),
], ids=["d2-k2", "d2-per", "grid-1x2-k2"])
def test_host_fed_rows_and_chunk_match_jax(grid, extra, tmp_path):
    data, model = grid
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=4,
                  fused_chunk="off", model_axis=model, data_axis=data, **extra)
    per = bool(extra.get("prioritized"))
    ref = _jax_chunk(common, data, model, per)
    spec = dict(kind="host_chunk", config=dict(common, replay_capacity=CAP), obs=OBS,
                act=ACT, k=K, scale=SCALE, offset=OFFSET, beta=BETA)
    results = run_ranks(tmp_path, spec, ref["arrays"])
    np.testing.assert_array_equal(results[0]["indices"], ref["indices"])
    # Rank r sits at device r of JAX's mesh (devices.reshape(data, model));
    # a device's shard is its data index's B columns of the [K, B * D] chunk.
    assert all(a.shape == (K, B, 2 * OBS + ACT + 3) for a in ref["per_device"])
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["cols"], ref["per_device"][r], err_msg=f"rank {r}")
        assert str(res["route"]) == "scan" and bool(res["replicas"])
    jout = ref["out"]
    want = state_arrays(jout.state)
    for r, res in enumerate(results):
        for key, value in want.items():
            if key.endswith("count") or key == "state/step":
                assert int(res[key]) == int(value), (r, key)
            else:
                _close(f"rank {r} {key}", res[key], value)
        _close(f"rank {r} td", res["td"], jout.td_errors)
    if per:
        jsd = ref["replay"].state_dict()
        _close("priorities", results[0]["priorities"], jsd["priorities"])
        _close("max_priority", results[0]["max_priority"], jsd["max_priority"])
        assert float(results[0]["beta"]) == ref["replay"].beta == BETA


_TINY = dict(total_env_steps=1200, replay_min_size=200, batch_size=16,
             actor_hidden=[16, 16], critic_hidden=[16, 16], learner_chunk=4,
             eval_every=0, eval_episodes=1, shm_ring_rows=128, host_replay=True)


@pytest.mark.parametrize("extra", [
    dict(data_axis=2, fused_update=True),
    dict(data_axis=2, prioritized=True),
    dict(data_axis=2, guardrails=True),
    dict(model_axis=2, fused_update=True),
], ids=["uniform-k2", "per", "guarded", "grid-1x2"])
def test_train_with_the_host_replay_on_two_ranks(extra, tmp_path):
    results = run_ranks(tmp_path, dict(kind="train", config=dict(_TINY, **extra)), {})
    lead, other = (json.loads(str(res["summary"])) for res in results)
    for s in (lead, other):
        assert s["host_replay"] is True and s["replicas_identical"] is True
        assert s["route"] == "scan" and s["chunks"] >= 2
        assert s["learner_steps"] == 4 * s["chunks"] and math.isfinite(s["critic_loss"])
    assert lead["chunks"] == other["chunks"] and lead["env_steps"] == other["env_steps"]
    if extra.get("prioritized"):
        assert lead["max_priority"] == other["max_priority"] > 0


def test_resume_from_the_lead_checkpoint_on_two_ranks(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = dict(_TINY, data_axis=2, prioritized=True, checkpoint_dir=ck, checkpoint_every=4)
    first = run_ranks(tmp_path, dict(kind="train", config=cfg), {}, name="first")
    steps = json.loads(str(first[0]["summary"]))["learner_steps"]
    resumed = run_ranks(tmp_path, dict(kind="train", config=dict(
        cfg, total_env_steps=2000, resume=True)), {}, name="second")
    lead, other = (json.loads(str(res["summary"])) for res in resumed)
    for s in (lead, other):
        assert s["replicas_identical"] is True and s["learner_steps"] > steps
        # It went on from a checkpoint of the first run (every 4 steps).
        start = s["learner_steps"] - 4 * s["chunks"]
        assert 0 < start <= steps and start % 4 == 0, (start, steps)
    # Rank 0 wrote the host replay with its checkpoints; the other rank none.
    import glob
    assert glob.glob(f"{ck}/step_*/replay.npz")


_AXES = [dict(data_axis=2), dict(model_axis=2)]
_KNOBS = ("host_replay", "serve_actors", "serve_backend", "prioritized", "strict_sync",
          "guardrails", "fused_update")


def _outcome(cls, kw):
    try:
        cls(**kw)
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("axis", _AXES, ids=["data_axis=2", "model_axis=2"])
@pytest.mark.parametrize("host_replay", [False, True])
def test_config_matrix_matches_jax(axis, host_replay):
    seen = set()
    for values in itertools.product([False, True], ["numpy", "jax"], *[[False, True]] * 4):
        kw = dict(zip(_KNOBS, (host_replay, *values)), **axis)
        ours, theirs = _outcome(DDPGConfig, kw), _outcome(JaxConfig, kw)
        assert ours == theirs, kw
        seen.add(ours == "ok")
    assert seen == {True, False}   # the matrix holds both outcomes
