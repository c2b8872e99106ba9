"""The port's pod through its CLI on the CPU: two nodes of one rank, each a
process of the trainer's CLI (train.main, through tests/torch_pod_child.py
--train, which reads the harness's POD_FAULTS and POD_EXIT_LINGER_S) with
the environment torchrun would give it (RANK, WORLD_SIZE, LOCAL_RANK,
GROUP_RANK, GROUP_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
DDPG_DIST_BACKEND=gloo, at tiny widths (16x16 nets, batch 16, K = 8).

- A hung peer (pod:1:hang@3, the pod deadline 3 s): node 0 sees the lost
  beat within the deadline plus a slack that holds under load, writes its
  emergency checkpoint and exits 76 (the hung node's own beat misses the
  same deadline, so it exits 76 too, with its checkpoint in proc1).
- A killed peer (pod:1:kill@3): node 0 sees the closed connection at once
  (a transport error) and exits 76; then both relaunched with the same
  checkpoint directory elect the same resume step and finish with exit 0,
  their replicas bit-identical.
- Under tools/supervise.py --procs 2 with POD_FAULTS=pod:1:hang@3 in
  generation 1 only: the generation exits 76 on both nodes, the
  supervisor relaunches the pod, generation 2 resumes at the elected step
  and both exit 0; the supervisor exits 0 with spawn, exit, relaunch,
  spawn and final in its event log.
"""

import ast
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch.exits import EXIT_POD_DEGRADED

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = [sys.executable, os.path.join(REPO, "tests", "torch_pod_child.py"), "--train"]
FLAGS = ["--device=cpu", "--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
         "--batch_size=16", "--replay_min_size=200", "--replay_capacity=20000",
         "--learner_chunk=8", "--eval_every=0", "--eval_episodes=1"]
DEADLINE_S = 3.0
# Detection past the deadline: a beat's lane dispatch and the two nodes'
# skew at the beat, on a loaded host (six test workers).
SLACK_S = 6.0
POD_TIMEOUT_S = 35.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DDPG_DIST_BACKEND="gloo", POD_EXIT_LINGER_S="1", OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                "GROUP_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "POD_FAULTS"):
        env.pop(key, None)
    return env


def launch_pod(tmp_path, tag: str, flags, env_extra=None, per_node: int = 1):
    """Two nodes of the CLI trainer, `per_node` ranks each; returns
    [(code, stdout, stderr)] by rank. A rank still running POD_TIMEOUT_S
    after the start is killed."""
    port = _free_port()
    procs, files = [], []
    world = 2 * per_node
    for p in range(world):
        env = _base_env()
        env.update(RANK=str(p), WORLD_SIZE=str(world), LOCAL_RANK=str(p % per_node),
                   LOCAL_WORLD_SIZE=str(per_node), GROUP_RANK=str(p // per_node),
                   GROUP_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), **(env_extra or {}))
        out = open(tmp_path / f"{tag}.p{p}.out", "w+")
        err = open(tmp_path / f"{tag}.p{p}.err", "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(
            [*NODE, *FLAGS, *flags],
            cwd=str(tmp_path), env=env, stdout=out, stderr=err))
    deadline = time.monotonic() + POD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results


def summary_of(stdout: str) -> dict:
    """The summary dict main() prints last on each node's lead."""
    lines = [line for line in stdout.splitlines() if line.startswith("{'")]
    assert lines, stdout[-2000:]
    return ast.literal_eval(lines[-1])


def _stamp(pattern: str, text: str) -> float:
    m = re.search(pattern + r" ([0-9.]+)", text)
    assert m, text[-3000:]
    return float(m.group(1))


def test_hung_peer_exits_76_within_the_deadline(tmp_path):
    ckdir = tmp_path / "ckpt"
    (c0, out0, err0), (c1, out1, err1) = launch_pod(
        tmp_path, "hang", ["--total_env_steps=100000000", "--faults=pod:1:hang@3",
                           f"--pod_collective_timeout_s={DEADLINE_S}",
                           f"--checkpoint_dir={ckdir}", "--checkpoint_every=16"])
    assert c0 == EXIT_POD_DEGRADED, err0[-3000:]
    fired = _stamp(r"\[chaos\] pod:1:hang@3 fired at", err1)
    seen = _stamp(r"\[train\] pod peer lost at", err0)
    assert DEADLINE_S - 0.5 <= seen - fired <= DEADLINE_S + SLACK_S, (seen - fired, err0[-2000:])
    assert "missed its" in err0 and "deadline" in err0
    s0 = summary_of(out0)
    assert s0["pod_degraded"] and not s0["preempted"]
    assert s0["pod_aborts"] == 1 and s0["pod_peer_lost"] >= 1 and s0["emergency_ckpt"] == 1
    # Node 0's emergency checkpoint at the step it stopped at; the hung
    # node's own beat missed the deadline too, and node 1 wrote into proc1.
    assert ckpt.latest_step(str(ckdir)) == s0["learner_steps"] > 0
    assert c1 == EXIT_POD_DEGRADED, err1[-3000:]
    assert ckpt.valid_steps(ckpt.pod_dir(str(ckdir), 1)) == [s0["learner_steps"]]


def test_killed_peer_exits_76_then_the_relaunch_elects_the_common_step(tmp_path):
    ckdir = tmp_path / "ckpt"
    common = [f"--pod_collective_timeout_s={DEADLINE_S}", f"--checkpoint_dir={ckdir}",
              "--checkpoint_every=16"]
    (c0, out0, err0), (c1, _, err1) = launch_pod(
        tmp_path, "kill", ["--total_env_steps=100000000", "--faults=pod:1:kill@3", *common])
    assert c1 == -9, err1[-2000:]
    assert c0 == EXIT_POD_DEGRADED, err0[-3000:]
    fired = _stamp(r"\[chaos\] pod:1:kill@3 fired at", err1)
    seen = _stamp(r"\[train\] pod peer lost at", err0)
    # The transport error of the closed connection, well inside the deadline.
    assert seen - fired < DEADLINE_S, err0[-2000:]
    assert "failed mid-flight" in err0
    stopped = summary_of(out0)["learner_steps"]
    assert ckpt.valid_steps(str(ckdir))[-1] == stopped
    # The relaunch: both nodes elect node 0's emergency step (node 1 reads
    # it from the shared directory) and finish the budget.
    relaunch = launch_pod(tmp_path, "relaunch", ["--total_env_steps=6000", *common])
    summaries = []
    for code, out, err in relaunch:
        assert code == 0, err[-3000:]
        summaries.append(summary_of(out))
    for s in summaries:
        assert s["pod_resume_step_elected"] == stopped
        assert s["resumed_from"] == stopped and s["learner_steps"] > stopped
        assert s["replicas_identical"] and s["route"] == "mesh"
        assert s["process_count"] == 2 and not s["pod_degraded"]
    assert [s["process_index"] for s in summaries] == [0, 1]
    assert summaries[0]["learner_steps"] == summaries[1]["learner_steps"]


@pytest.mark.parametrize("per_node", [2, 1])
def test_killed_peer_under_model_axis_checkpoints_from_a_whole_model_group(tmp_path, per_node):
    """--model_axis=2 with node 1 killed (pod:1:kill@3). Two ranks a node:
    each model group lies on one node, and node 0's lead writes its
    emergency checkpoint, the logical state gathered over its group. One
    rank a node: the only model group spans both nodes, so no emergency
    checkpoint is written (the port's deviation from the JAX trainer, which
    writes one on every surviving process): the last cadence checkpoint
    is the resume point. Both exit 76."""
    ckdir = tmp_path / "ckpt"
    ranks = launch_pod(
        tmp_path, "tpkill", ["--total_env_steps=100000000", "--faults=pod:1:kill@3",
                             "--model_axis=2", f"--pod_collective_timeout_s={DEADLINE_S}",
                             f"--checkpoint_dir={ckdir}", "--checkpoint_every=16"],
        per_node=per_node)
    for code, _, err in ranks[per_node:]:
        assert code == -9, err[-2000:]
    for code, _, err in ranks[:per_node]:
        assert code == EXIT_POD_DEGRADED, err[-3000:]
    _, out0, err0 = ranks[0]
    s0 = summary_of(out0)
    assert s0["pod_degraded"] and s0["mesh_model_axis"] == 2
    stopped = s0["learner_steps"]
    if per_node == 2:
        assert s0["emergency_ckpt"] == 1, err0[-3000:]
        assert ckpt.valid_steps(str(ckdir))[-1] == stopped
        with np.load(ckdir / f"step_{stopped}" / ckpt.STATE_FILE) as z:
            # The logical leaves: the column layer's w whole, not a shard.
            assert z["critic_params/0/w"].shape == (3, 16)
            assert z["critic_opt/mu/0/w"].shape == (3, 16)
    else:
        assert s0["emergency_ckpt"] == 0
        assert "model group spans nodes, no emergency checkpoint" in err0
        assert all(s < stopped or s % 16 == 0 for s in ckpt.valid_steps(str(ckdir)))


def test_supervised_pod_relaunches_after_a_hang(tmp_path):
    ckdir, log = tmp_path / "ckpt", tmp_path / "supervisor.jsonl"
    env = _base_env()
    cmd = [sys.executable, "-m", "distributed_ddpg_tpu_torch.tools.supervise", "--procs", "2",
           "--backoff-base", "0.1", "--drain-grace", "5", "--kill-grace", "5",
           "--event-log", str(log), "--child-logs", str(tmp_path / "children"),
           "--env-first", "POD_FAULTS=pod:1:hang@3", "--",
           *NODE, *FLAGS,
           "--total_env_steps=6000", f"--pod_collective_timeout_s={DEADLINE_S}",
           f"--checkpoint_dir={ckdir}", "--checkpoint_every=16"]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=2 * POD_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    events = [json.loads(line) for line in log.read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds == ["start", "spawn", "spawn", "exit", "exit", "relaunch", "backoff",
                     "spawn", "spawn", "exit", "exit", "final"], kinds
    exits_ = [(e["gen"], e["code"]) for e in events if e["event"] == "exit"]
    assert sorted(exits_) == [(1, EXIT_POD_DEGRADED), (1, EXIT_POD_DEGRADED), (2, 0), (2, 0)]
    assert events[-1]["code"] == 0 and events[-1]["supervisor_generations"] == 2
    elected = []
    for p in (0, 1):
        text = (tmp_path / "children" / f"gen2_proc{p}.log").read_text()
        elected.append(summary_of(text)["pod_resume_step_elected"])
    assert elected[0] == elected[1] > 0
