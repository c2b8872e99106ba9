"""The elastic half of the port's sharded replay on the CPU: the pod's
sharded beats, the all-writer slices (checkpoint.py), the slice election
(parallel/multihost.py), the `slice` faults and the shrink (exit 78) and
grow of a pod under tools/supervise.py, after the JAX package's
tests/test_pod.py:565-680 and tests/test_chaos.py:252-380.

- The pod's sharded beats (tests/torch_pod_child.py, gloo processes): two
  nodes of one rank (synchronous and background beats) and two nodes of
  two ranks; every rank's slots read in logical order are the layout the
  JAX replay's _sync_ship_collective leaves (test_torch_multihost.py's
  jax_layout), each row landed once, and the background beats rode the
  scheduler's shard_exchange class, not lockstep.
- The slices on one directory through both packages: a set written by
  the port loads with the JAX functions and the other way round, and
  write_replay_slice, slice_status, verify_replay_slices,
  latest_complete_slice_step, load_replay_slices and elect_slice_step
  (one process) give JAX's answers; _prune keeps the newest complete set.
- `slice` specs parse to JAX's FaultPlan; `corrupt` tears one slice,
  which verification quarantines while the set falls back to an older
  one; `kill` dies (SIGKILL, in a child) before any byte lands.
- The drill: a sharded two-node pod under tools.supervise, pod:1:kill@3 in
  generation 1; node 1 dies by SIGKILL, node 0 exits 78 with a complete
  slice set on disk; generation 2 runs one node, adopts the two-writer set
  (pod_shrinks 1, pod_state_degraded 1) and finishes; a later two-node
  launch on the same directory adopts the one-writer set (pod_grows 1,
  pod_state_degraded 0). Tiny widths, a short pod deadline.
- Both CLIs run one tiny sharded config to the same record kinds and the
  same replay_* keys.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import checkpoint as jax_ckpt
from distributed_ddpg_tpu import faults as jax_faults
from distributed_ddpg_tpu.parallel import multihost as jax_multihost
from distributed_ddpg_tpu.replay import device as jax_device

from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch import faults
from distributed_ddpg_tpu_torch.exits import EXIT_POD_SHRINK
from distributed_ddpg_tpu_torch.parallel import multihost
from distributed_ddpg_tpu_torch.replay.device import merge_slice_states, split_slice_state
from test_torch_faults import run_cli
from test_torch_multihost import BLOCK, CAPACITY, COALESCE, SCHEDULE, SEED, jax_layout, run_pod
from test_torch_pod import FLAGS, NODE, _base_env, launch_pod, summary_of

torch.set_num_threads(1)

WIDTH = 10
# The kill is seen at once (the closed connection), so a long deadline costs
# the drill nothing and keeps a loaded host's slow beat from reading as a
# lost peer.
DEADLINE_S = 15.0


def _logical(outs):
    parts = [o["storage"] for o in outs]
    return np.stack(parts, 0).swapaxes(0, 1).reshape(-1, parts[0].shape[-1])


# --- the pod's sharded beats ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["synchronous", "background"])
def test_sharded_beats_land_the_jax_layout_on_their_owners(mode, tmp_path):
    spec = dict(kind="beat", mode=mode, per=True, capacity=CAPACITY, block_size=BLOCK,
                max_coalesce=COALESCE, seed=SEED, schedule=SCHEDULE, sharding="sharded")
    outs = run_pod(tmp_path, spec, nodes=2)
    want, ptr, size = jax_layout(SCHEDULE, 2, background=mode == "background")
    np.testing.assert_array_equal(_logical(outs), want)
    for out in outs:
        assert out["storage"].shape == (CAPACITY // 2, WIDTH)
        assert (int(out["ptr"]), int(out["size"])) == (ptr, size)
        np.testing.assert_array_equal(out["priorities"], np.ones(CAPACITY // 2, np.float32))
        if mode == "background":
            assert int(out["shard_exchange"]) > 0 and int(out["lockstep"]) == 0
    assert sum(int(o["local_fill"]) for o in outs) == size


def test_sharded_beats_on_two_nodes_of_two_ranks(tmp_path):
    spec = dict(kind="beat", mode="synchronous", per=False, capacity=CAPACITY,
                block_size=BLOCK, max_coalesce=COALESCE, seed=SEED, schedule=SCHEDULE,
                sharding="sharded")
    outs = run_pod(tmp_path, spec, nodes=2, ranks_per_node=2)
    want, ptr, size = jax_layout(SCHEDULE, 2, background=False)
    np.testing.assert_array_equal(_logical(outs), want)
    for out in outs:
        assert out["storage"].shape == (CAPACITY // 4, WIDTH)


# --- the slices on disk, both packages ------------------------------------------------


def _state(n=45, cap=64, seed=2):
    rng = np.random.default_rng(seed)
    return {"packed": rng.standard_normal((n, WIDTH)).astype(np.float32),
            "ptr": np.asarray(n % cap), "size": np.asarray(n),
            "priorities": rng.uniform(0.5, 2.0, n).astype(np.float32),
            "max_priority": np.asarray(2.5, np.float32)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_slice_set_crosses_between_the_packages(writer, tmp_path):
    st, cap = _state(), 64
    write = ckpt.write_replay_slice if writer == "port" else jax_ckpt.write_replay_slice
    for k, sl in enumerate(split_slice_state(st, 3, cap)):
        write(str(tmp_path), 16, k, 3, sl)
    for mod in (ckpt, jax_ckpt):
        assert mod.slice_status(str(tmp_path), 16)[:2] == (True, 3)
        assert mod.latest_complete_slice_step(str(tmp_path)) == 16
    ours = merge_slice_states(ckpt.load_replay_slices(str(tmp_path), 16))
    theirs = jax_device.merge_slice_states(jax_ckpt.load_replay_slices(str(tmp_path), 16))
    for key in st:
        np.testing.assert_array_equal(ours[key], st[key], err_msg=key)
        np.testing.assert_array_equal(theirs[key], st[key], err_msg=key)


def test_slice_verification_election_and_prune_match_jax(tmp_path):
    d = str(tmp_path)
    st = _state()
    for step, n in ((8, 2), (16, 2), (24, 2)):
        for k, sl in enumerate(split_slice_state(st, n, 64)):
            if (step, k) != (24, 1):              # step 24 misses its second writer
                ckpt.write_replay_slice(d, step, k, n, sl)
    for mod in (ckpt, jax_ckpt):
        assert mod.latest_complete_slice_step(d) == 16
        assert mod.latest_complete_slice_step(d, at_or_below=12) == 8
        assert mod.slice_status(d, 24)[:2] == (False, 2)
    # A torn slice: quarantined by both verifiers alike, the set falls back.
    path = os.path.join(d, "replay_slices", "step_16", "slice_1_of_2.npz")
    with open(path, "r+b") as f:
        f.truncate(100)
    assert ckpt.verify_replay_slices(d, 16) == (False, 2)
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert ckpt.latest_complete_slice_step(d) == jax_ckpt.latest_complete_slice_step(d) == 8
    with pytest.raises(RuntimeError, match="incomplete"):
        ckpt.load_replay_slices(d, 16)
    # One process: the election is the local answer, as JAX's.
    for v in (None, 8, 0):
        assert multihost.elect_slice_step(v) == jax_multihost.elect_slice_step(v)
    # _prune keeps the newest complete set's step while it deletes its peers.
    for step in (8, 16, 24, 32):
        os.makedirs(os.path.join(d, f"step_{step}"), exist_ok=True)
    ckpt._prune(d, keep=1, current=32)
    assert ckpt._slice_steps(d) == [8] and ckpt._steps(d) == [8, 32]


@pytest.mark.parametrize("seed", [0, 4])
def test_slice_specs_parse_as_jax(seed):
    text = "slice:1:corrupt@2;slice:0:kill@3;pod:1:kill@4"
    ours, theirs = faults.FaultPlan.parse(text, seed), jax_faults.FaultPlan.parse(text, seed)
    assert [s.describe() for s in ours.specs] == [s.describe() for s in theirs.specs]
    assert [tuple(vars(s).values()) for s in ours.specs] == \
        [tuple(vars(s).values()) for s in theirs.specs]
    for spec in ("slice:x:kill@2", "slice:1:crash@2", "slice:1:hang@2"):
        with pytest.raises(ValueError) as a:
            faults.FaultPlan.parse(spec)
        with pytest.raises(ValueError) as b:
            jax_faults.FaultPlan.parse(spec)
        assert str(a.value) == str(b.value)


def test_slice_corrupt_tears_one_write_and_kill_dies_before_a_byte(tmp_path):
    d = str(tmp_path)
    st = _state()
    site = faults.FaultPlan.parse("slice:1:corrupt@2").slice_site(1)
    for step in (8, 16):
        for k, sl in enumerate(split_slice_state(st, 2, 64)):
            ckpt.write_replay_slice(d, step, k, 2, sl, fault=site if k == 1 else None)
    assert site.fired == ["slice:1:corrupt@2"]
    # Torn after its sidecar landed: the set at 16 reads corrupt, 8 stands.
    assert ckpt.verify_replay_slices(d, 16) == (False, 2)
    assert ckpt.latest_complete_slice_step(d) == 8
    # kill: SIGKILL at the tick, before the file exists.
    code = ("import numpy as np; from distributed_ddpg_tpu_torch import checkpoint as c, faults;"
            "s = faults.FaultPlan.parse('slice:0:kill@1').slice_site(0);"
            f"c.write_replay_slice({d!r}, 40, 0, 1, {{'positions': np.arange(3)}}, fault=s)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, env=_base_env())
    assert res.returncode == -signal.SIGKILL, res.stderr[-2000:]
    assert "[chaos] slice:0:kill@1 fired at" in res.stderr
    assert not os.path.exists(os.path.join(d, "replay_slices", "step_40"))


def test_a_learner_collective_that_fails_on_a_pod_is_a_peer_loss():
    """multihost.typed_peer_loss: on a pod a transport error (RuntimeError,
    OSError) in a learner collective is a PodPeerLost, other errors pass
    through; without a pod it is a direct call."""
    from types import SimpleNamespace

    def boom(exc):
        def fn():
            raise exc
        return fn

    assert multihost.typed_peer_loss(lambda: 3) == 3
    with pytest.raises(RuntimeError):
        multihost.typed_peer_loss(boom(RuntimeError("no pod")))
    multihost.use_group(SimpleNamespace(process_count=2, process_index=0))
    try:
        with pytest.raises(multihost.PodPeerLost, match="failed mid-flight"):
            multihost.typed_peer_loss(boom(RuntimeError("Connection closed by peer")))
        with pytest.raises(ValueError):
            multihost.typed_peer_loss(boom(ValueError("a bug, not a peer")))
    finally:
        from distributed_ddpg_tpu_torch.obs import health

        multihost.use_group(None)
        multihost._lost = None
        health.get().reset()   # the loss noted pod_peer_lost: no later test reads it


# --- the drill: shrink under the supervisor, then grow ---------------------------------


# Paced by the learner (--max_ingest_ratio): the kill at the 3rd beat comes
# long before the budget, whatever the host's speed.
SHARDED = ["--replay_sharding=sharded", "--fused_update=true", "--checkpoint_every=8",
           "--learner_chunk=8", "--max_ingest_ratio=16",
           f"--pod_collective_timeout_s={DEADLINE_S}"]


def test_supervised_sharded_pod_shrinks_on_exit_78_then_grows(tmp_path):
    ckdir, log = tmp_path / "ckpt", tmp_path / "supervisor.jsonl"
    flags = [*FLAGS, *SHARDED, f"--checkpoint_dir={ckdir}"]
    cmd = [sys.executable, "-m", "distributed_ddpg_tpu_torch.tools.supervise", "--procs", "2",
           "--backoff-base", "0.1", "--drain-grace", "5", "--kill-grace", "5",
           "--event-log", str(log), "--child-logs", str(tmp_path / "children"),
           "--env-first", "POD_FAULTS=pod:1:kill@3", "--", *NODE, *flags,
           "--total_env_steps=3000"]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=_base_env(), capture_output=True,
                         text=True, timeout=120)
    children = tmp_path / "children"
    assert res.returncode == 0, (res.stderr[-2000:], [
        (p.name, p.read_text()[-2500:]) for p in sorted(children.iterdir())])
    events = [json.loads(line) for line in log.read_text().splitlines()]
    exits_ = sorted((e["gen"], e["code"]) for e in events if e["event"] == "exit")
    assert exits_ == [(1, -signal.SIGKILL), (1, EXIT_POD_SHRINK), (2, 0)], exits_
    gen1 = (children / "gen1_proc0.log").read_text()
    assert "shrink-ready, exiting 78" in gen1 and "omitted from checkpoints" in gen1
    shrunk = summary_of((children / "gen2_proc0.log").read_text())
    assert shrunk["pod_slices_adopted"] == 1 and shrunk["pod_shrinks"] == 1
    assert shrunk["pod_state_degraded"] == 1 and shrunk["replay_shard_count"] == 1
    assert "written by 2 process(es), resharded to 1" in (children / "gen2_proc0.log").read_text()
    # The grow: two nodes again on the directory the shrunk run left.
    grown = launch_pod(tmp_path, "grow", [*SHARDED, f"--checkpoint_dir={ckdir}",
                                          f"--total_env_steps={shrunk['env_steps'] + 600}"])
    for code, out, err in grown:
        assert code == 0, err[-3000:]
        s = summary_of(out)
        assert s["pod_grows"] == 1 and s["pod_state_degraded"] == 0
        assert s["pod_slices_adopted"] == 1 and s["replay_shard_count"] == 2
        assert s["replicas_identical"] and s["route"] == "scan"
        assert "written by 1 process(es), resharded to 2" in err


# --- both CLIs ---------------------------------------------------------------------------


def test_both_clis_run_a_sharded_config_to_the_same_records(tmp_path, monkeypatch):
    # The JAX child on one CPU device, one shard, as the port's one rank.
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    flags = ["--actor_hidden=16,16", "--critic_hidden=16,16", "--batch_size=16",
             "--learner_chunk=4", "--replay_min_size=200", "--eval_every=0",
             "--eval_episodes=1", "--num_actors=1", "--total_env_steps=1200",
             # Paced by the learner, so both runs learn (and log) whatever
             # their start-up costs.
             "--max_ingest_ratio=4", "--replay_sharding=sharded", "--fused_update=true"]
    keys, kinds = {}, {}
    for pkg in ("distributed_ddpg_tpu_torch", "distributed_ddpg_tpu"):
        rc, records, err = run_cli(pkg, flags, tmp_path / f"{pkg}.jsonl")
        assert rc == 0, (pkg, err[-3000:])
        kinds[pkg] = {r["kind"] for r in records}
        keys[pkg] = {k for r in records if r["kind"] in ("train", "final") for k in r
                     if k.startswith("replay_")}
        assert records[-1]["replay_shard_count"] == 1
    assert kinds["distributed_ddpg_tpu_torch"] == kinds["distributed_ddpg_tpu"]
    assert keys["distributed_ddpg_tpu_torch"] == keys["distributed_ddpg_tpu"]
