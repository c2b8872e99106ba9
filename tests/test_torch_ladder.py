"""The port's ladder (distributed_ddpg_tpu_torch/ladder.py) against the JAX
package's: the rungs and the smoke overrides field for field, rung 1's
record with the JAX ladder's keys, and rung 2 (LunarLanderContinuous
through gymnasium, 4 actor processes, the plain chunk on the CPU) to a
finite return. The runs are child processes: the actor pool never starts
inside a pytest process."""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_ddpg_tpu import ladder as jax_ladder
from distributed_ddpg_tpu_torch import ladder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 240


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


@pytest.mark.parametrize("rung", sorted(jax_ladder.RUNGS))
def test_rungs_equal_jax_field_for_field(rung):
    ours, theirs = ladder.RUNGS[rung], jax_ladder.RUNGS[rung]
    fields = {f.name for f in dataclasses.fields(theirs)}
    # The port's config adds only its device; every JAX field is there.
    assert {f.name for f in dataclasses.fields(ours)} - fields == {"device"}
    diff = [k for k in fields if not _same(getattr(ours, k), getattr(theirs, k))]
    assert diff == []
    assert ours.device == "cuda"


def test_smoke_overrides_equal_jax():
    assert ladder._SMOKE == jax_ladder._SMOKE
    assert sorted(ladder.RUNGS) == sorted(jax_ladder.RUNGS)


def _start(module, *args, jax=False):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _record(proc):
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return [r for r in recs if r.get("kind") == "ladder"][-1]


def test_rung1_smoke_record_has_jax_keys():
    ours = _start("distributed_ddpg_tpu_torch.ladder", "--rungs=1", "--smoke")
    theirs = _start("distributed_ddpg_tpu.ladder", "--rungs=1", "--smoke", jax=True)
    a, b = _record(ours), _record(theirs)
    assert list(a) == list(b)
    for k in ("kind", "rung", "env_id", "backend", "platform", "num_actors", "prioritized"):
        assert a[k] == b[k], k
    assert a["platform"] == "cpu" and math.isfinite(a["final_return"])


def test_rung2_smoke_on_the_cpu_finishes_with_a_finite_return():
    rec = _record(_start("distributed_ddpg_tpu_torch.ladder", "--rungs=2", "--smoke",
                         "--device=cpu"))
    assert (rec["rung"], rec["env_id"], rec["backend"], rec["platform"]) == (
        2, "LunarLanderContinuous-v2", "jax_tpu", "cpu")
    assert rec["num_actors"] == 4 and rec["learner_steps"] > 0
    assert math.isfinite(rec["final_return"])
    assert rec["fused_chunk_active"] is True
