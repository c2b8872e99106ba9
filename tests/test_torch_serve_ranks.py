"""Serving beside a learner on more than one rank: the tensor-parallel
serve apply (serve/server.py `mesh=`, ServeFollower), the serve groups
(parallel/mesh.serve_group), the pod's refusals, and train() serving on
two ranks, on the CPU against the JAX package.

- (d) On a (1, 2) grid the TP apply (rank 0 serves, rank 1 follows) matches
  JAX's InferenceServer(mesh=make_mesh(4, 2)) and the numpy oracle at
  JAX's own tolerance (rtol 1e-5, atol 1e-6, tests/test_partition.py:313),
  DDPG and SAC heads; each rank holds its shards only (less than the
  whole policy's bytes, the two together more).
- (e) A lost follower (its process killed) fails the server's next apply
  with ServeGroupLost at once, every later one too, and a worker's
  request through the batcher typed, with no hang.
- (c) train() on two gloo ranks with --serve_actors: numpy and jax
  backends at D = 2, and the jax backend's TP apply at 1 x 2: the run
  finishes with identical replicas, requests served and no fallback.
- The pod refuses what the JAX trainer cannot run there (train.py
  check_pod_config): the TP serve apply, the host replay, and (JAX's own
  message) the host replay's auto C51 support. On a pod of two one-rank
  nodes each node's lead serves its own workers and binds the same front
  port (JAX's rule): both runs finish with requests served, and the node
  that finds the port taken says so and runs on without its front.

Each rank job is tests/torch_mesh_child.py (kinds "serve_tp" and "train";
the cases in tests/torch_ranks_child.py) with its 120 s join timeout.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.actors.policy import layout_size as jax_layout_size
from distributed_ddpg_tpu.actors.policy import param_layout as jax_param_layout
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.serve.server import InferenceServer as JaxServer

from distributed_ddpg_tpu_torch.actors.policy import layout_size, param_layout
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.serve import InferenceServer
from distributed_ddpg_tpu_torch.train import check_pod_config
from test_torch_pod import launch_pod, summary_of
from torch_mesh_child import run_ranks

torch.set_num_threads(1)

OBS, ACT, HIDDEN, MAX_BATCH = 3, 2, (32, 32), 8
RTOL, ATOL = 1e-5, 1e-6      # tests/test_partition.py:313


def _inputs(sac: bool, seed: int = 0):
    head = 2 * ACT if sac else ACT
    layout = param_layout(OBS, head, HIDDEN)
    assert layout == jax_param_layout(OBS, head, HIDDEN)
    rng = np.random.default_rng(seed)
    flat = (0.1 * rng.standard_normal(layout_size(layout))).astype(np.float32)
    obs = rng.standard_normal((MAX_BATCH - 2, OBS)).astype(np.float32)
    return layout, flat, obs


def _spec(layout, sac, **extra):
    return dict(kind="serve_tp", layout=[list(map(list, l)) for l in layout], sac=sac,
                scale=[2.0] * ACT, max_batch=MAX_BATCH, timeout_s=10.0, **extra)


@pytest.mark.parametrize("sac", [False, True], ids=["ddpg", "sac"])
def test_tp_serve_apply_matches_jax_tp_and_the_oracle(sac, tmp_path):
    layout, flat, obs = _inputs(sac)
    scale = np.full(ACT, 2.0, np.float32)
    jax_tp = JaxServer(layout, scale, backend="jax", max_batch=MAX_BATCH,
                       mesh=jax_mesh.make_mesh(4, 2), sac=sac)
    jax_tp.refresh(flat)
    want = jax_tp._compute(obs)
    oracle = InferenceServer(layout, scale, backend="numpy", max_batch=MAX_BATCH, sac=sac)
    oracle.refresh(flat)
    results = run_ranks(tmp_path, _spec(layout, sac), dict(flat=flat, obs=obs))
    got = results[0]["actions"]
    assert got.shape == (len(obs), 2 * ACT if sac else ACT)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle._compute(obs), rtol=RTOL, atol=ATOL)
    whole = 4 * jax_layout_size(layout)
    shards = [int(r["shard_bytes"]) for r in results]
    assert all(0 < b < whole for b in shards) and sum(shards) > whole, shards
    # The follower took part in the warm apply and the real one.
    assert int(results[1]["applies"]) == 2


def test_a_lost_follower_fails_the_dispatch_typed(tmp_path):
    layout, flat, obs = _inputs(False)
    codes = run_ranks(tmp_path, _spec(layout, False, lose_follower=True),
                      dict(flat=flat, obs=obs), check=False)
    assert codes[0] == 0 and codes[1] == -9, codes
    res = dict(np.load(tmp_path / "job.rank0.npz"))
    assert res["actions"].shape == (len(obs), ACT)
    kinds = [str(k) for k in res["kinds"]]
    assert kinds == ["lost", "lost", "ServeDispatchError/ServeGroupLost"], kinds
    # Within the group's deadline (10 s), the later ones at once.
    assert res["waits"][0] < 10.0 and max(res["waits"][1:]) < 1.0, res["waits"]


def test_the_numpy_backend_refuses_a_mesh_with_jaxs_message():
    layout, _, _ = _inputs(False)
    with pytest.raises(ValueError) as ours:
        InferenceServer(layout, 1.0, backend="numpy", mesh=object())
    with pytest.raises(ValueError) as theirs:
        JaxServer(layout, np.ones(ACT, np.float32), backend="numpy",
                  mesh=jax_mesh.make_mesh(4, 2))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("over,match", [
    (dict(serve_actors=True, serve_backend="jax", model_axis=2), "cannot serve there"),
    (dict(host_replay=True), "cannot run it"),
    (dict(host_replay=True, distributional=True, v_min=float("nan"), v_max=float("nan")),
     "v_min/v_max=auto with --host_replay is not supported multi-process"),
], ids=["tp-serve", "host-replay", "host-replay-auto-support"])
def test_the_pod_refuses_what_jax_cannot_run_there(over, match):
    with pytest.raises(ValueError, match=match):
        check_pod_config(DDPGConfig(**over))
    # What the JAX trainer runs on a pod passes: serving on each node lead.
    check_pod_config(DDPGConfig(serve_actors=True, serve_backend="jax"))
    check_pod_config(DDPGConfig(serve_actors=True, model_axis=2))


@pytest.mark.parametrize("extra", [
    dict(data_axis=2),
    dict(data_axis=2, serve_backend="jax"),
    dict(model_axis=2, serve_backend="jax", fused_update=True),
], ids=["numpy-d2", "jax-d2", "jax-tp-1x2"])
def test_train_serving_on_two_ranks(extra, tmp_path):
    cfg = dict(total_env_steps=1500, replay_min_size=200, batch_size=16, num_actors=2,
               actor_hidden=[16, 16], critic_hidden=[16, 16], learner_chunk=4,
               eval_every=0, eval_episodes=1, serve_actors=True, **extra)
    results = run_ranks(tmp_path, dict(kind="train", config=cfg), {})
    lead, other = (json.loads(str(res["summary"])) for res in results)
    for s in (lead, other):
        assert s["replicas_identical"] is True and s["learner_steps"] > 0
        # Every rank ships inline, a grid's model group too: ranks that
        # shipped on threads of their own drew from rings that differed.
        assert s["ingest_async_active"] is False
    assert lead["serve_requests"] > 0 and lead["serve_errors"] == 0
    assert lead["serve_client_fallbacks"] == 0
    assert "serve_requests" not in other     # one server, on the actor host


def test_serving_on_a_pod_of_two_nodes(tmp_path):
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    runs = launch_pod(tmp_path, "serve", ["--total_env_steps=1200", "--serve_actors=true",
                                          f"--front_port={port}"])
    assert [code for code, _, _ in runs] == [0, 0], [err[-2000:] for _, _, err in runs]
    for _, out, _ in runs:
        s = summary_of(out)
        assert s["serve_requests"] > 0 and s["serve_errors"] == 0
        assert s["replicas_identical"] is True
    errs = [err for _, _, err in runs]
    assert sum("[front] serving ingress on tcp:" in e for e in errs) == 1, errs
    assert sum("[front] ingress disabled (bind failed" in e for e in errs) == 1, errs
