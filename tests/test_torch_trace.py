"""The flight recorder (trace.py) against the JAX package's, on the CPU.

- The same event sequence, on the main thread and a named worker thread,
  exports the same events from both recorders: names, phases, args, order
  and per-thread tracks, with only ts, pid and tid (and a measured span's
  dur) differing; the export's otherData keys and set_meta are the same.
- The ring's wrap keeps the same last events, window_s the same tail.
- The module singleton: off by default (a shared no-op span, no file),
  configure / disable, and SIGUSR2's export, each the same in both.
- stall_report writes the same artifacts with the same keys.
- trace.py, faults.py and the actors' worker module import no torch (a
  spawned actor never does).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from distributed_ddpg_tpu import trace as jax_trace
from distributed_ddpg_tpu_torch import trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(rec, t0: float):
    """One event sequence on recorder `rec`: spans (nested, with args),
    instants, explicit complete events, and a worker thread's spans."""
    with rec.span("dispatch", chunk=1):
        rec.instant("warmup_done", buffer_fill=1024)
        with rec.span("ingest"):
            pass
    # Ends before the script starts: the first event in the sorted export.
    rec.complete("ingest_backpressure", t0 - 1.0, 0.0005, rows=64)

    def worker():
        with rec.span("ingest_ship", rows=1024, blocks=1):
            pass
        rec.instant("shipper_restart", n=1)

    t = threading.Thread(target=worker, name="ingest-ship")
    t.start()
    t.join()
    rec.instant("budget_met", env_steps=3000, learn_steps=800)
    with rec.span("sync"):
        pass


def _strip(events):
    """The events as the comparison sees them: each event's name, phase,
    args and thread name, in order (ts, pid, tid and dur dropped)."""
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    out = []
    for e in events:
        if e["ph"] == "M":
            continue
        out.append((e["name"], e["ph"], e.get("args"), e.get("s"), names[e["tid"]]))
    return out


def test_same_sequence_exports_same_events():
    ours, theirs = trace.TraceRecorder(capacity=64), jax_trace.TraceRecorder(capacity=64)
    t0 = time.perf_counter()
    _script(theirs, t0)
    _script(ours, t0)
    a, b = ours.events(), theirs.events()
    assert _strip(a) == _strip(b)
    assert len(_strip(a)) == 8
    # Thread-name metadata first, one a thread, the same tracks.
    meta = lambda evs: sorted(e["args"]["name"] for e in evs if e["ph"] == "M")
    assert meta(a) == meta(b) == sorted(["MainThread", "ingest-ship"])
    # An explicit complete event keeps its given duration in both.
    dur = lambda evs: [e["dur"] for e in evs if e["name"] == "ingest_backpressure"]
    assert dur(a) == dur(b) == [500.0]
    keys = lambda evs: [sorted(e) for e in evs]
    assert keys(a) == keys(b)


def test_export_wrapper_matches(tmp_path):
    ours, theirs = trace.TraceRecorder(), jax_trace.TraceRecorder()
    for rec, name in ((ours, "ours.json"), (theirs, "theirs.json")):
        rec.set_meta(run="x", rank=0)
        _script(rec, time.perf_counter())
        assert rec.export(str(tmp_path / "sub" / name)) == len(rec.events())
    a = json.loads((tmp_path / "sub" / "ours.json").read_text())
    b = json.loads((tmp_path / "sub" / "theirs.json").read_text())
    assert sorted(a) == sorted(b) == ["displayTimeUnit", "otherData", "traceEvents"]
    assert sorted(a["otherData"]) == sorted(b["otherData"])
    assert a["otherData"]["run"] == "x" and a["displayTimeUnit"] == "ms"
    assert _strip(a["traceEvents"]) == _strip(b["traceEvents"])


def test_ring_wrap_and_window_match():
    ours, theirs = trace.TraceRecorder(capacity=16), jax_trace.TraceRecorder(capacity=16)
    for i in range(40):
        for rec in (theirs, ours):
            rec.instant(f"e{i}", i=i)
    a, b = _strip(ours.events()), _strip(theirs.events())
    assert a == b and [e[0] for e in a] == [f"e{i}" for i in range(24, 40)]
    time.sleep(0.2)
    for rec in (theirs, ours):
        rec.instant("late")
    a, b = _strip(ours.events(window_s=0.1)), _strip(theirs.events(window_s=0.1))
    assert a == b and [e[0] for e in a] == ["late"]
    with pytest.raises(ValueError, match="capacity"):
        trace.TraceRecorder(capacity=8)


def test_singleton_off_on_and_sigusr2(tmp_path):
    try:
        for mod in (trace, jax_trace):
            mod.disable()
            assert not mod.enabled() and mod.get() is None
            assert mod.span("x") is mod.span("y")       # the shared no-op
            with mod.span("x"):
                mod.instant("i")
            assert mod.export(str(tmp_path / "none.json")) == 0
        assert not (tmp_path / "none.json").exists()
        if not hasattr(signal, "SIGUSR2"):
            pytest.skip("no SIGUSR2 on this platform")
        prev = signal.getsignal(signal.SIGUSR2)
        try:
            out = {}
            for mod, name in ((trace, "ours"), (jax_trace, "theirs")):
                mod.configure(capacity=256)
                assert mod.enabled()
                _script(mod, time.perf_counter())
                path = tmp_path / f"{name}_sigusr2.json"
                assert mod.install_signal_export(str(path))
                os.kill(os.getpid(), signal.SIGUSR2)
                deadline = time.monotonic() + 5.0
                while not path.exists() and time.monotonic() < deadline:
                    time.sleep(0.01)
                out[name] = json.loads(path.read_text())["traceEvents"]
                mod.disable()
            assert _strip(out["ours"]) == _strip(out["theirs"])
        finally:
            signal.signal(signal.SIGUSR2, prev)
    finally:
        trace.disable()
        jax_trace.disable()


def test_stall_report_matches(tmp_path):
    reports = {}
    try:
        for mod, name in ((trace, "ours"), (jax_trace, "theirs")):
            mod.configure(capacity=128)
            _script(mod, time.perf_counter())
            paths = mod.stall_report(str(tmp_path / name), reason="test stall",
                                     timeout_s=5.0, window_s=30.0, extra={"stalled_s": 5.1})
            mod.disable()
            assert sorted(paths) == ["report", "trace"]
            assert os.path.basename(paths["report"]) == trace.STALL_REPORT
            assert os.path.basename(paths["trace"]) == trace.STALL_TRACE
            reports[name] = json.loads(open(paths["report"]).read())
            reports[name + "_trace"] = json.loads(open(paths["trace"]).read())
    finally:
        trace.disable()
        jax_trace.disable()
    a, b = reports["ours"], reports["theirs"]
    assert sorted(a) == sorted(b)
    assert a["reason"] == "test stall" and a["stalled_s"] == 5.1 and a["trace_events"] > 0
    main = next(t for t in a["threads"] if t["name"] == "MainThread")
    assert any("test_stall_report_matches" in line for line in main["stack"])
    assert sorted(main) == sorted(next(t for t in b["threads"] if t["name"] == "MainThread"))
    assert _strip(reports["ours_trace"]["traceEvents"]) == \
        _strip(reports["theirs_trace"]["traceEvents"])
    # Without tracing: the report alone, never an exception.
    paths = trace.stall_report(str(tmp_path / "off"), reason="off")
    assert sorted(paths) == ["report"]


def test_actor_side_modules_import_no_torch():
    code = ("import sys; sys.modules['torch'] = None\n"
            "import distributed_ddpg_tpu_torch.trace, distributed_ddpg_tpu_torch.faults\n"
            "import distributed_ddpg_tpu_torch.actors.worker\n"
            "import distributed_ddpg_tpu_torch.obs, distributed_ddpg_tpu_torch.watchdog\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
