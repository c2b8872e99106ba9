"""The port's pod supervisor (supervisor/, tools/supervise.py) against the
JAX package's, on the CPU. Both are stdlib programs, so every case runs
through both packages on the same inputs:

- the exit contract (exits.py): the codes, their names and describe();
- classify_generation's matrix and backoff_for's curve;
- the event log, and the rejoin prober's damping driven synchronously;
- /healthz probing of the port's exporter;
- the same fake-child drills through both supervisors (the crash-loop
  breaker, the numeric refusal and its budget, the breaker's reset by a
  long generation, request_stop, a spawn failure, and the
  shrink -> probe -> grow cycle): the same event kinds in the same order
  (the prober's own transitions, whose count is timing, left out), the
  same exit codes and the same report fields;
- the CLIs: the same parse and errors, and exit 0, 75 and 79 from both;
  the port's also sets each child's torchrun environment.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import pytest
import torch

from distributed_ddpg_tpu import exits as jax_exits
from distributed_ddpg_tpu import metrics as jax_metrics
from distributed_ddpg_tpu import supervisor as jax_supervisor
from distributed_ddpg_tpu.obs import health as jax_health
from distributed_ddpg_tpu.obs import probe as jax_probe
from distributed_ddpg_tpu.obs.exporter import ObsExporter as JaxExporter
from distributed_ddpg_tpu.supervisor import core as jax_core
from distributed_ddpg_tpu.tools import supervise as jax_cli
from distributed_ddpg_tpu_torch import exits, metrics, supervisor
from distributed_ddpg_tpu_torch.obs import health, probe
from distributed_ddpg_tpu_torch.obs.exporter import ObsExporter
from distributed_ddpg_tpu_torch.supervisor import core
from distributed_ddpg_tpu_torch.tools import supervise as cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "jax": types.SimpleNamespace(exits=jax_exits, stats=jax_metrics.SupervisorStats,
                                 sup=jax_supervisor, core=jax_core, cli=jax_cli,
                                 health=jax_health, probe=jax_probe, exporter=JaxExporter,
                                 module="distributed_ddpg_tpu"),
    "torch": types.SimpleNamespace(exits=exits, stats=metrics.SupervisorStats,
                                   sup=supervisor, core=core, cli=cli, health=health,
                                   probe=probe, exporter=ObsExporter,
                                   module="distributed_ddpg_tpu_torch"),
}


@pytest.fixture(autouse=True)
def _healthy_singletons():
    """Both packages' health state healthy around each test: a stand-in
    peer's /healthz must not read a state an earlier test in this process
    left degraded."""
    for p in PACKAGES.values():
        p.health.get().reset()
    yield
    for p in PACKAGES.values():
        p.health.get().reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# --------------------------------------------------------------------------
# the exit contract, the classifier and the backoff
# --------------------------------------------------------------------------


def test_exit_contract_matches_jax():
    for name in ("EXIT_OK", "EXIT_WATCHDOG_STALL", "EXIT_PREEMPTED", "EXIT_POD_DEGRADED",
                 "EXIT_NUMERIC", "EXIT_POD_SHRINK", "EXIT_SUPERVISOR_GAVE_UP"):
        assert getattr(exits, name) == getattr(jax_exits, name), name
    assert (exits.EXIT_POD_DEGRADED, exits.EXIT_POD_SHRINK, exits.EXIT_SUPERVISOR_GAVE_UP) \
        == (76, 78, 79)
    assert exits.NAMES == jax_exits.NAMES
    assert len(set(exits.NAMES.values())) == len(exits.NAMES) == 7
    for code in (0, 70, 75, 76, 77, 78, 79, 1, 2, 255, -signal.SIGKILL, -signal.SIGTERM,
                 -signal.SIGABRT, -200, None):
        assert exits.describe(code) == jax_exits.describe(code), code


CLASSIFY_CASES = [
    ([0, 0], False, "success"), ([0, 77], False, "numeric"), ([77, 78], False, "numeric"),
    ([77], True, "numeric"), ([75], True, "resize"), ([78, -signal.SIGKILL], False, "shrink"),
    ([78, None, 0], False, "shrink"), ([78, 78], False, "relaunch"), ([70, 0], False, "relaunch"),
    ([75, 0], False, "relaunch"), ([76, 0], False, "relaunch"), ([1, 0], False, "relaunch"),
    ([-signal.SIGKILL, -signal.SIGKILL], False, "relaunch"), ([76, 76], False, "relaunch"),
    ([0], True, "resize"), ([78, -9, -9], False, "shrink"), ([78, -9], True, "resize"),
]


@pytest.mark.parametrize("codes,grow,want", CLASSIFY_CASES)
def test_classify_generation_matrix_matches_jax(codes, grow, want):
    assert core.classify_generation(codes, grow) == want
    assert jax_core.classify_generation(codes, grow) == want


def test_backoff_for_matches_jax():
    for n in (-1, 0, 1, 2, 3, 4, 7, 50):
        for base, cap in ((1.0, 60.0), (0.25, 5.0), (2.0, 1.0)):
            assert core.backoff_for(n, base, cap) == jax_core.backoff_for(n, base, cap)
    assert [core.backoff_for(n, 1.0, 60.0) for n in (0, 1, 2, 4, 50)] == [0, 1, 2, 8, 60]


def test_supervisor_stats_snapshot_keys_match_jax():
    ours, theirs = metrics.SupervisorStats(), jax_metrics.SupervisorStats()
    for s in (ours, theirs):
        s.record_generation(2)
        s.record_relaunch()
        s.record_backoff(0.5)
        s.record_breaker_trip()
        s.record_probe_flap()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.snapshot()["supervisor_gave_up"] == 1


# --------------------------------------------------------------------------
# the event log and the prober
# --------------------------------------------------------------------------


def test_event_log_round_trips_jsonl(pkg, tmp_path):
    path = str(tmp_path / "sup.jsonl")
    log = pkg.sup.EventLog(path)
    log.emit("spawn", gen=1, proc=0, members=2)
    log.emit("exit", gen=1, proc=0, code=78, code_name="pod_shrink_ready")
    log.emit("shrink", gen=1, members=2, target=1)
    log.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["event"] for r in recs] == ["spawn", "exit", "shrink"]
    assert all(r["kind"] == "supervisor" and "wall_time" in r and "t_unix" in r for r in recs)
    assert log.by_event("shrink")[0]["target"] == 1
    mem = pkg.sup.EventLog("")
    mem.emit("start", target=2)
    assert mem.by_event("start")[0]["target"] == 2
    mem.close()


class _ScriptedProbe:
    def __init__(self, pkg, verdicts):
        self.pkg, self.verdicts = pkg, list(verdicts)

    def __call__(self, host, port):
        healthy = self.verdicts.pop(0) if self.verdicts else True
        return self.pkg.probe.ProbeResult(healthy, healthy, "healthy" if healthy else "down")


def _prober(pkg, verdicts, k=3, hysteresis=0.0, transitions=None):
    p = pkg.sup.HealthProber(
        {1: ("127.0.0.1", 1)}, interval_s=0.01, healthy_k=k, hysteresis_s=hysteresis,
        probe_fn=_ScriptedProbe(pkg, verdicts),
        on_transition=(lambda s, t, r: transitions.append((s, t)))
        if transitions is not None else None)
    p.set_watched([1])
    return p


def test_prober_requires_k_consecutive_healthy(pkg):
    transitions = []
    p = _prober(pkg, [True, True, False, True, True, True], transitions=transitions)
    for _ in range(2):
        p.poll_once()
    assert p.ready_slots() == []
    p.poll_once()
    assert p.ready_slots() == []
    for _ in range(3):
        p.poll_once()
    assert p.ready_slots() == [1]
    assert transitions == [(1, "up"), (1, "flap"), (1, "up"), (1, "ready")]


def test_prober_hysteresis_and_unwatch(pkg):
    p = _prober(pkg, [True] * 10, k=2, hysteresis=3600.0)
    for _ in range(5):
        p.poll_once()
    assert p.ready_slots() == []
    with p._lock:
        p._watched[1].last_unhealthy -= 7200.0
    assert p.ready_slots() == [1]
    p.set_watched([])
    assert p.ready_slots() == []
    p.set_watched([1])
    p.poll_once()
    assert p.ready_slots() == []


def test_probe_healthz_reads_the_ports_exporter():
    ex = ObsExporter(0).start()
    try:
        for probe_fn in (probe.probe_healthz, jax_probe.probe_healthz):
            r = probe_fn("127.0.0.1", ex.port)
            assert r.reachable and r.healthy and r.state == "healthy"
        health.get().drain("pod abort (exit 76)")
        for probe_fn in (probe.probe_healthz, jax_probe.probe_healthz):
            r = probe_fn("127.0.0.1", ex.port)
            assert r.reachable and not r.healthy and r.state == "draining"
    finally:
        ex.stop()
        health.get().reset()
    r = probe.probe_healthz("127.0.0.1", ex.port)
    assert not r.reachable and not r.healthy and r.state == "down"


# --------------------------------------------------------------------------
# the fake-child drills, through both supervisors
# --------------------------------------------------------------------------


def _cmd(code_or_script):
    script = (f"import sys; sys.exit({code_or_script})"
              if isinstance(code_or_script, int) else code_or_script)

    def build(proc, nprocs, port, gen):
        return [sys.executable, "-c", script], {}

    return build


def _cfg(pkg, tmp_path, **kw):
    base = dict(procs=1, backoff_base_s=0.01, backoff_max_s=0.05, breaker_failures=3,
                breaker_window_s=60.0, healthy_run_s=60.0, drain_grace_s=5.0,
                kill_grace_s=2.0, event_log=str(tmp_path / "sup.jsonl"),
                report_path=str(tmp_path / "gave_up.json"))
    base.update(kw)
    return pkg.sup.SupervisorConfig(**base)


_CYCLE_CHILD = textwrap.dedent("""\
    import os, signal, sys, time
    proc, gen = int(sys.argv[1]), int(sys.argv[2])
    if gen == 1:
        if proc == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.4)
        sys.exit(78)
    elif gen == 2:
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
        time.sleep(60)   # the grow's SIGTERM ends it within seconds
        sys.exit(75)
    else:
        sys.exit(0)
""")


def _drill(name, pkg, tmp_path):
    """Run one drill; returns (outcome, event kinds without the prober's,
    report or None, counters, the event log)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    kw, build, targets, ex = {}, None, None, None
    if name == "crash_loop":
        build = _cmd(1)
    elif name == "numeric_refusal":
        build = _cmd(77)
    elif name == "numeric_budget":
        kw, build = dict(max_numeric=2), _cmd(77)
    elif name == "breaker_reset":
        kw, build = dict(healthy_run_s=0.0, max_generations=6), _cmd(1)
    elif name == "spawn_failure":
        def build(proc, nprocs, port, gen):
            return ["/nonexistent/binary/for/this/drill"], {}
    elif name == "request_stop":
        kw, build = dict(kill_grace_s=5.0), _cmd("import time; time.sleep(600)")
    elif name == "shrink_grow":
        child = tmp_path / "child.py"
        child.write_text(_CYCLE_CHILD)

        def build(proc, nprocs, port, gen):
            return [sys.executable, str(child), str(proc), str(gen)], {}

        kw = dict(procs=2, drain_grace_s=10.0, kill_grace_s=5.0, probe_interval_s=0.05,
                  probe_healthy_k=2, probe_hysteresis_s=0.1, grow_defer_s=0.5,
                  max_generations=6)
        ex = pkg.exporter(0).start()
        targets = {1: ("127.0.0.1", ex.port)}
    cfg = _cfg(pkg, tmp_path, **kw)
    sup = pkg.sup.PodSupervisor(cfg, build, probe_targets=targets)
    report = None
    try:
        if name == "request_stop":
            rc = {}
            t = threading.Thread(target=lambda: rc.update(v=sup.run()))
            t.start()
            deadline = time.monotonic() + 10.0
            while not sup.events.by_event("spawn"):
                assert time.monotonic() < deadline, "child never spawned"
                time.sleep(0.02)
            sup.request_stop()
            t.join(timeout=15.0)
            assert not t.is_alive()
            outcome = ("exit", rc["v"])
        else:
            try:
                outcome = ("exit", sup.run())
            except pkg.sup.SupervisorGaveUp as e:
                outcome = ("gave_up", e.reason)
                report = e.report
                assert e.report_path == cfg.report_path
                assert json.loads(open(cfg.report_path).read()) == e.report
    finally:
        if ex is not None:
            ex.stop()
    kinds = [e["event"] for e in sup.events.events if e["event"] != "probe"]
    file_kinds = [json.loads(line)["event"] for line in open(cfg.event_log)]
    assert [k for k in file_kinds if k != "probe"] == kinds
    return outcome, kinds, report, sup.stats.snapshot(), sup.events


DRILLS = ["crash_loop", "numeric_refusal", "numeric_budget", "breaker_reset",
          "spawn_failure", "request_stop", "shrink_grow"]


@pytest.mark.parametrize("drill", DRILLS)
def test_drill_matches_jax_supervisor(drill, tmp_path):
    ours = _drill(drill, PACKAGES["torch"], tmp_path / "torch")
    theirs = _drill(drill, PACKAGES["jax"], tmp_path / "jax")
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    if theirs[2] is None:
        assert ours[2] is None
    else:
        keep = ("reason", "generation", "members", "target", "last_exit_codes",
                "last_exit_names")
        assert {k: ours[2][k] for k in keep} == {k: theirs[2][k] for k in keep}
        assert set(ours[2]) == set(theirs[2])
        strip = ("supervisor_backoff_wait_s",)
        assert {k: v for k, v in ours[2]["counters"].items() if k not in strip} == \
            {k: v for k, v in theirs[2]["counters"].items() if k not in strip}
    timing = ("supervisor_backoff_wait_s", "supervisor_probe_ready", "supervisor_probe_flaps")
    assert {k: v for k, v in ours[3].items() if k not in timing} == \
        {k: v for k, v in theirs[3].items() if k not in timing}
    # What each drill must show (tests/test_supervisor.py's assertions).
    outcome, kinds, report, snap, events = ours
    if drill == "crash_loop":
        assert outcome == ("gave_up", "crash_loop")
        assert report["last_exit_names"] == ["exit:1"]
        assert kinds.count("spawn") == 3 and kinds[-1] == "final"
        assert "breaker" in kinds and "gave_up" in kinds
        assert events.by_event("final")[0]["code"] == exits.EXIT_SUPERVISOR_GAVE_UP
    elif drill == "numeric_refusal":
        assert outcome == ("gave_up", "numeric_abort")
        assert snap["supervisor_numeric_refusals"] == 1 and snap["supervisor_generations"] == 1
        assert "guardrail_" in report["detail"]
    elif drill == "numeric_budget":
        assert outcome == ("gave_up", "numeric_abort") and snap["supervisor_generations"] == 3
        assert [e["reason"] for e in events.by_event("relaunch")] == \
            ["numeric_abort (1/2)", "numeric_abort (2/2)"]
    elif drill == "breaker_reset":
        assert outcome == ("gave_up", "generation_budget")
        assert snap["supervisor_generations"] == 6 and snap["supervisor_backoffs"] == 0
    elif drill == "spawn_failure":
        assert outcome == ("gave_up", "crash_loop")
        assert any(e["code_name"].startswith("spawn_error") for e in events.by_event("exit"))
    elif drill == "request_stop":
        assert outcome == ("exit", exits.EXIT_PREEMPTED)
        assert events.by_event("exit")[0]["code_name"] == "signal:SIGTERM"
    else:
        assert outcome == ("exit", 0)
        (shrink,), (grow,) = events.by_event("shrink"), events.by_event("grow")
        assert (shrink["members"], shrink["target"]) == (2, 1)
        assert (grow["members"], grow["target"]) == (1, 2)
        assert events.by_event("grow_initiated")[0]["slots"] == [1]
        transitions = [e["transition"] for e in events.by_event("probe")]
        assert "up" in transitions and "ready" in transitions
        assert len([e for e in events.by_event("spawn") if e["gen"] == 3]) == 2


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def test_cli_parses_as_jax():
    argv = ["--procs", "3", "--backoff-base", "0.5", "--breaker-failures", "2",
            "--drain-grace", "7", "--probe-port-base", "9400", "--env", "A=1",
            "--env-first", "B={gen}", "--", "python", "x.py", "{proc}"]
    ours, theirs = vars(cli.build_parser().parse_args(argv)), \
        vars(jax_cli.build_parser().parse_args(argv))
    assert ours == theirs
    assert ours["procs"] == 3 and ours["command"] == ["--", "python", "x.py", "{proc}"]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_cli_rejects_missing_command_and_bad_env(which):
    mod = PACKAGES[which].cli
    assert mod.main(["--procs", "1"]) == 2
    with pytest.raises(SystemExit):
        mod.main(["--procs", "1", "--env", "NOEQUALS", "--", "true"])
    with pytest.raises(SystemExit):
        mod.build_parser().parse_args(["--", "true"])   # --procs is required


def test_cli_children_get_the_torchrun_environment(tmp_path):
    """The port's CLI sets each child's torchrun rendezvous (RANK, WORLD_SIZE,
    LOCAL_RANK, GROUP_RANK, GROUP_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) for
    a pod of one-rank nodes; --env overrides it; {gen} expands in --env
    values; the children exit 0, so the supervisor does."""
    out = tmp_path / "env"
    out.mkdir()
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""\
        import json, os, sys
        keys = ["RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                "GROUP_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "DDPG_DIST_BACKEND", "GEN"]
        with open(os.path.join({str(out)!r}, sys.argv[1] + ".json"), "w") as f:
            json.dump(dict((k, os.environ.get(k)) for k in keys), f)
    """))
    rc = cli.main(["--procs", "2", "--env", "DDPG_DIST_BACKEND=gloo", "--env", "GEN={gen}",
                   "--event-log", str(tmp_path / "cli.jsonl"), "--",
                   sys.executable, str(child), "{proc}"])
    assert rc == exits.EXIT_OK
    envs = [json.load(open(out / f"{p}.json")) for p in (0, 1)]
    port = envs[0]["MASTER_PORT"]
    for p, env in enumerate(envs):
        assert env == {"RANK": str(p), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                       "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(p), "GROUP_WORLD_SIZE": "2",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                       "DDPG_DIST_BACKEND": "gloo", "GEN": "1"}


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_cli_gives_up_typed_79(which, tmp_path):
    rc = PACKAGES[which].cli.main([
        "--procs", "1", "--backoff-base", "0.01", "--breaker-failures", "2",
        "--breaker-window", "60", "--event-log", str(tmp_path / "cli.jsonl"),
        "--report", str(tmp_path / "cli_report.json"),
        "--child-logs", str(tmp_path / "children"), "--env", "SUPERVISE_TEST_GEN={gen}",
        "--", sys.executable, "-c",
        "import os, sys; sys.exit(int(os.environ['SUPERVISE_TEST_GEN']) * 0 + 1)"])
    assert rc == exits.EXIT_SUPERVISOR_GAVE_UP == 79
    assert json.loads(open(tmp_path / "cli_report.json").read())["reason"] == "crash_loop"
    assert sorted(os.listdir(tmp_path / "children")) == ["gen1_proc0.log", "gen2_proc0.log"]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_cli_sigterm_drains_and_exits_75(which, tmp_path):
    """The supervisor itself SIGTERMed: it forwards the signal to the running
    generation and exits 75 (both CLIs, as processes of their own)."""
    log = tmp_path / "cli.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGES[which].module}.tools.supervise", "--procs", "1",
         "--kill-grace", "5", "--event-log", str(log), "--",
         sys.executable, "-c", "import time; time.sleep(600)"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60.0
        while not (log.exists() and "spawn" in log.read_text()):
            assert time.monotonic() < deadline and proc.poll() is None, "no child spawned"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == exits.EXIT_PREEMPTED == 75, err[-2000:]
    events = [json.loads(line)["event"] for line in log.read_text().splitlines()]
    assert events == ["start", "spawn", "exit", "final"]
