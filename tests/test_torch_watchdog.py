"""The stall watchdog (watchdog.py) on the CPU, beside the JAX package's.

- It fires on frozen progress, stays quiet while progress advances and
  after stop(), and grant() holds it off until the grant's deadline, with
  beats in between not consuming the allowance: each the same for the JAX
  Watchdog.
- Its stall path latches /healthz to draining and writes the artifacts
  before on_stall runs.
- A child process whose main thread blocks (a wait that releases the GIL,
  as torch's waits on the card do) exits 70, the JAX package's
  EXIT_WATCHDOG_STALL, within a few polls of the timeout, and leaves
  stall_report.json (the main thread's stack in its blocking wait) and
  stall_trace.json (its last spans); the JAX child leaves the same
  artifacts with the same keys.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from distributed_ddpg_tpu import exits as jax_exits
from distributed_ddpg_tpu import watchdog as jax_watchdog
from distributed_ddpg_tpu_torch import exits, trace, watchdog
from distributed_ddpg_tpu_torch.obs import health

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [watchdog, jax_watchdog]


def test_exit_code_is_jax_s():
    assert exits.EXIT_WATCHDOG_STALL == jax_exits.EXIT_WATCHDOG_STALL == 70
    assert exits.NAMES[70] == jax_exits.NAMES[70] == "watchdog_stall"


@pytest.mark.parametrize("mod", MODULES, ids=["port", "jax"])
def test_fires_on_frozen_progress(mod):
    fired = threading.Event()
    w = mod.Watchdog(timeout_s=0.3, progress=lambda: 0, on_stall=fired.set).start()
    try:
        assert fired.wait(timeout=3.0)
    finally:
        w.stop()


@pytest.mark.parametrize("mod", MODULES, ids=["port", "jax"])
def test_quiet_while_progress_advances_and_after_stop(mod):
    fired = threading.Event()
    beat = [0]
    w = mod.Watchdog(timeout_s=0.3, progress=lambda: beat[0], on_stall=fired.set).start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            beat[0] += 1
            time.sleep(0.02)
        assert not fired.is_set()
    finally:
        w.stop()
    assert not fired.wait(timeout=0.8)
    with pytest.raises(ValueError):
        mod.Watchdog(timeout_s=0.0, progress=lambda: 0)


@pytest.mark.parametrize("mod", MODULES, ids=["port", "jax"])
def test_grant_holds_off_until_its_deadline(mod):
    fired = threading.Event()
    beat = [0]
    w = mod.Watchdog(timeout_s=0.2, progress=lambda: beat[0], on_stall=fired.set)
    w.grant(1.2)
    t0 = time.monotonic()
    w.start()
    try:
        beat[0] += 1   # a beat after the grant does not consume it
        assert not fired.wait(timeout=0.9)
        assert fired.wait(timeout=3.0)
        assert time.monotonic() - t0 >= 1.1
    finally:
        w.stop()


def test_stall_path_drains_health_and_writes_artifacts(tmp_path):
    health.get().reset()
    trace.configure(capacity=256)
    try:
        with trace.span("dispatch"):
            pass
        seen = {}

        def on_stall():
            seen["state"] = health.get().state()[0]
            seen["files"] = sorted(os.listdir(tmp_path))

        w = watchdog.Watchdog(timeout_s=0.2, progress=lambda: 0, on_stall=on_stall,
                              stall_dir=str(tmp_path)).start()
        deadline = time.monotonic() + 3.0
        while "state" not in seen and time.monotonic() < deadline:
            time.sleep(0.02)
        w.stop()
    finally:
        trace.disable()
        health.get().reset()
    assert seen["state"] == health.DRAINING
    assert seen["files"] == sorted([trace.STALL_REPORT, trace.STALL_TRACE])
    assert sorted(w.stall_artifacts) == ["report", "trace"]


CHILD = r"""
import sys, time
pkg = sys.argv[1]
if pkg == "port":
    from distributed_ddpg_tpu_torch import trace
    from distributed_ddpg_tpu_torch.watchdog import Watchdog
else:
    from distributed_ddpg_tpu import trace
    from distributed_ddpg_tpu.watchdog import Watchdog
trace.configure(capacity=1024)
for i in range(5):
    with trace.span("dispatch", chunk=i):
        pass
trace.instant("warmup_done")
Watchdog(0.5, progress=lambda: 0, stall_dir=sys.argv[2]).start()
print("armed", time.time(), flush=True)
time.sleep(60)   # the main thread's blocking wait, the interpreter lock released
"""


def test_blocked_child_exits_70_with_both_artifacts(tmp_path):
    child = tmp_path / "blocked_child.py"   # a file, so its stack shows the line
    child.write_text(CHILD)
    procs = {}
    for pkg in ("port", "jax"):
        out = tmp_path / pkg
        procs[pkg] = subprocess.Popen(
            [sys.executable, str(child), pkg, str(out)], cwd=REPO, text=True,
            env={**os.environ, "PYTHONPATH": REPO},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    reports = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=60)
        ended = time.time()
        assert p.returncode == 70, (pkg, stderr[-2000:])
        armed = float(stdout.split()[1])
        # The stall is seen within timeout_s plus one poll (timeout_s / 4),
        # and the exit follows the artifacts.
        assert ended - armed < 30.0
        assert "watchdog: no trainer progress" in stderr
        out = tmp_path / pkg
        assert sorted(os.listdir(out)) == sorted([trace.STALL_REPORT, trace.STALL_TRACE])
        reports[pkg] = json.loads((out / trace.STALL_REPORT).read_text())
        spans = json.loads((out / trace.STALL_TRACE).read_text())["traceEvents"]
        assert [e["name"] for e in spans if e["ph"] != "M"] == ["dispatch"] * 5 + ["warmup_done"]
    ours, theirs = reports["port"], reports["jax"]
    assert sorted(ours) == sorted(theirs)
    assert ours["timeout_s"] == 0.5 and ours["stalled_s"] >= 0.5
    main = next(t for t in ours["threads"] if t["name"] == "MainThread")
    assert "time.sleep(60)" in main["stack"][-1]
