"""The telemetry plane and the records' operations fields, against the JAX
package's modules on the same inputs, on the CPU.

- Health: the same note / drain / probe sequence gives the same state()
  and snapshot keys.
- render_prometheus on the same latest records, counters and health gives
  the same text.
- The exporter answers /metrics, /healthz (200, then 503 once draining),
  /trace and a 404 on an ephemeral port, and probe_healthz reads it (as
  the JAX probe does).
- PhaseTimers: with time.perf_counter patched to the same sequence in both
  modules, snapshot() is equal key by key; each phase is a trace span.
- MetricsLogger: the header record, latest(), the JSONL fields' coercion
  (_jsonable) and the TensorBoard sink, as the JAX logger's.
- Staleness: on the same broadcast and version sequence, the pool's
  staleness() equals the JAX pool's.
- --profile_dir writes its Chrome trace (a CLI run in a child process).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import metrics as jax_metrics
from distributed_ddpg_tpu import trace as jax_trace
from distributed_ddpg_tpu.actors.policy import decode_version as jax_decode
from distributed_ddpg_tpu.actors.policy import encode_version as jax_encode
from distributed_ddpg_tpu.actors.pool import ActorPool as JaxActorPool
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs.registry import EnvSpec as JaxEnvSpec
from distributed_ddpg_tpu.obs import exporter as jax_exporter
from distributed_ddpg_tpu.obs import health as jax_health
from distributed_ddpg_tpu.obs import probe as jax_probe
from distributed_ddpg_tpu_torch import metrics, trace
from distributed_ddpg_tpu_torch.actors.policy import decode_version, encode_version
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
from distributed_ddpg_tpu_torch.obs import ObsExporter, health, probe_healthz, render_prometheus

torch.set_num_threads(1)


def _health_sequence(mod):
    h = mod.HealthState()
    states = [h.state()]
    h.note("guardrail_quarantine")
    states.append(h.state())
    h.register_probe("serve_overloaded", lambda: True)
    states.append(h.state())
    h.register_probe("broken", lambda: 1 / 0)
    states.append(h.state())
    h.register_probe("serve_overloaded", lambda: False)
    h.note("guardrail_quarantine", False)
    states.append(h.state())
    h.drain("watchdog stall")
    h.drain("preempted (SIGTERM)")        # the first reason wins
    h.note("late_condition")
    states.append(h.state())
    snap = h.snapshot()
    h.reset()
    states.append(h.state())
    return states, sorted(snap), snap["state"], snap["code"]


def test_health_sequence_matches_jax():
    assert _health_sequence(health) == _health_sequence(jax_health)
    assert health.CODES == jax_health.CODES
    assert health.get() is health.get()


LATEST = {
    "header": {"kind": "header", "step": 0, "wall_time": 0.0, "t_unix_base": 1.7e9, "pid": 7},
    "train": {"kind": "train", "step": 3000, "learner_steps": 1600,
              "learner_steps_per_sec": 2345.6, "fused_chunk_active": True,
              "episode_return": None, "transport": "shm", "t_dispatch_p95": 0.41,
              "staleness_max": 2, "weird-name.x": 3.5, "9lives": 1},
    "final": {"kind": "final", "step": 5000, "final_return": -150.25},
}
COUNTERS = {"t_unix_base": 1.7e9, "process_index": 0, "preempt": 0, "note": "text"}


def test_render_prometheus_matches_jax():
    for note in (False, True):
        h, jh = health.HealthState(), jax_health.HealthState()
        if note:
            h.note("guardrail_quarantine")
            jh.note("guardrail_quarantine")
        ours = render_prometheus(LATEST, COUNTERS, h)
        theirs = jax_exporter.render_prometheus(LATEST, COUNTERS, jh)
        assert ours == theirs
    assert 'ddpg_learner_steps_per_sec{kind="train"} 2345.6' in ours
    assert "ddpg_health_code 1" in ours
    assert render_prometheus(None) == jax_exporter.render_prometheus(None)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _verdict(result):
    """A probe's verdict (its detail holds the scrape's own timestamp)."""
    return result.reachable, result.healthy, result.state


def test_exporter_answers_and_probe_reads_it(tmp_path):
    h = health.HealthState()
    log = metrics.MetricsLogger(echo=False)
    log.log("train", 3000, learner_steps_per_sec=1234.5)
    server = ObsExporter(0, health=h, latest_fn=log.latest,
                         counters_fn=lambda: {"t_unix_base": log.t_unix_base},
                         trace_dir=str(tmp_path)).start()
    try:
        assert server.port > 0
        status, body = _get(server.url("/metrics"))
        assert status == 200
        assert 'ddpg_learner_steps_per_sec{kind="train"} 1234.5' in body
        assert "ddpg_obs_scrapes_total 1" in body and "ddpg_t_unix_base" in body
        status, body = _get(server.url("/healthz"))
        assert status == 200 and json.loads(body)["state"] == "healthy"
        ours = probe_healthz("127.0.0.1", server.port)
        theirs = jax_probe.probe_healthz("127.0.0.1", server.port)
        assert ours and _verdict(ours) == _verdict(theirs) and ours.state == "healthy"
        status, body = _get(server.url("/trace"))
        assert status == 200 and json.loads(body) == {"enabled": False, "events": 0}
        trace.configure(capacity=64)
        try:
            trace.instant("scrape")
            status, body = _get(server.url("/trace"))
        finally:
            trace.disable()
        reply = json.loads(body)
        assert reply["enabled"] and reply["events"] >= 1
        assert json.loads(open(reply["path"]).read())["traceEvents"]
        assert _get(server.url("/nope"))[0] == 404
        h.drain("preempted (SIGTERM)")
        status, body = _get(server.url("/healthz"))
        assert status == 503 and json.loads(body)["reasons"] == ["preempted (SIGTERM)"]
        ours = probe_healthz("127.0.0.1", server.port)
        assert not ours and ours.state == "draining"
        assert _verdict(ours) == _verdict(jax_probe.probe_healthz("127.0.0.1", server.port))
    finally:
        server.stop()
    down = probe_healthz("127.0.0.1", server.port, timeout_s=0.5)
    assert not down.reachable and down.state == "down"


def _phase_run(mod, monkeypatch, seed):
    ticks = iter(np.cumsum(np.random.default_rng(5).uniform(1e-4, 3e-2, 4000)).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    pt = mod.PhaseTimers(seed=seed)
    snaps = []
    for interval in range(3):
        for i in range(300 + 50 * interval):
            with pt.phase("ingest"):
                pass
            if i % 3 == 0:
                with pt.phase("dispatch"):
                    pass
            if i % 50 == 0:
                with pt.phase("sync"):
                    pass
        snaps.append(pt.snapshot())
    monkeypatch.undo()
    return snaps


@pytest.mark.parametrize("seed", [0, 11])
def test_phase_timers_match_jax(monkeypatch, seed):
    ours = _phase_run(metrics, monkeypatch, seed)
    theirs = _phase_run(jax_metrics, monkeypatch, seed)
    assert ours == theirs
    assert set(ours[0]) == {f"{p}_{s}" for p in ("t_ingest", "t_dispatch", "t_sync")
                            for s in ("ms", "p50", "p95", "max")} | {
        "n_ingest", "n_dispatch", "n_sync"}
    assert ours[2]["n_ingest"] == 400        # more calls than the reservoir's 256
    assert metrics.PhaseTimers.RESERVOIR_K == metrics.RESERVOIR_K == 256 == \
        jax_metrics.PhaseTimers.RESERVOIR_K
    assert metrics.PhaseTimers().snapshot() == {}


def test_phase_is_a_trace_span():
    trace.configure(capacity=64)
    try:
        pt = metrics.PhaseTimers()
        with pt.phase("dispatch"):
            pass
        names = [e["name"] for e in trace.get().events() if e["ph"] == "X"]
    finally:
        trace.disable()
    assert names == ["dispatch"]


VALUES = [True, False, 3, -7, 2.123456789, np.float32(0.1), np.float64(1e-9), np.int64(12),
          np.bool_(True), np.int32(-4), None, "shm", [1, 2], float("inf"), torch.tensor(2.5)]


def test_jsonable_matches_jax():
    for v in VALUES:
        ours, theirs = metrics._jsonable(v), jax_metrics._jsonable(v)
        assert repr(ours) == repr(theirs) and type(ours) is type(theirs), v


def test_logger_header_latest_and_tensorboard(tmp_path, capsys):
    for mod, name in ((metrics, "ours"), (jax_metrics, "theirs")):
        log = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"), echo=True,
                                tb_dir=str(tmp_path / f"tb_{name}"))
        log.log("train", 100, learner_steps=4, rate=np.float32(2.5), flag=True)
        log.log("train", 200, learner_steps=8, rate=3.0, flag=False)
        log.log("final", 200, final_return=None)
        latest = log.latest()
        log.close()
        assert sorted(latest) == ["final", "header", "train"]
        assert latest["train"]["learner_steps"] == 8
        assert latest["header"]["t_unix_base"] == log.t_unix_base
    strip = lambda r: {k: v for k, v in r.items() if k not in ("wall_time", "t_unix_base",
                                                               "pid")}
    read = lambda n: [strip(json.loads(x)) for x in (tmp_path / f"{n}.jsonl").read_text()
                      .splitlines()]
    assert read("ours") == read("theirs")
    assert [r["kind"] for r in read("ours")] == ["header", "train", "train", "final"]
    assert len(capsys.readouterr().out.splitlines()) == 8
    assert any(f.name.startswith("events.out.tfevents") for f in (tmp_path / "tb_ours").iterdir())
    timer = metrics.Timer()
    timer.tick(10)
    assert timer.rate() > 0.0


def _pools(tmp_path):
    common = dict(num_actors=3, transport="queue", actor_hidden=(8, 8))
    spec_args = (3, 1, np.array([-2.0], np.float32), np.array([2.0], np.float32))
    ours = ActorPool(DDPGConfig(device="cpu", **common), EnvSpec(*spec_args))
    theirs = JaxActorPool(JaxConfig(**common), JaxEnvSpec(*spec_args))
    return ours, theirs


def test_staleness_matches_jax(tmp_path):
    ours, theirs = _pools(tmp_path)
    layout = ours.layout
    rng = np.random.default_rng(0)
    # The workers report the version that acted; each broadcast bumps it
    # by 2 (the seqlock). A worker reporting an old version is stale by the
    # learner steps since that version's broadcast.
    versions = []
    for step in (0, 40, 80, 120, 160, 200, 240):
        params = [{"w": rng.standard_normal(w).astype(np.float32),
                   "b": rng.standard_normal(b).astype(np.float32)} for w, b in layout]
        flat = np.concatenate([np.concatenate([p["w"].ravel(), p["b"].ravel()])
                               for p in params])
        ours.broadcast(flat, learner_step=step)
        theirs.broadcast(params, learner_step=step)
        assert ours._version.value == theirs._version.value
        versions.append(ours._version.value)
        for wid, lag in ((0, 0), (1, 1), (2, 3)):
            v = versions[max(0, len(versions) - 1 - lag)]
            # The version column's round trip, as the shm ring carries it.
            tag = encode_version(v)
            assert decode_version(tag) == jax_decode(jax_encode(v)) == v
            ours._note_version(wid, decode_version(tag))
            theirs._note_version(wid, v)
        assert ours.staleness() == theirs.staleness()
    assert ours.staleness() == {"staleness_mean": (0 + 40 + 120) / 3, "staleness_max": 120}
    # An unknown version counts from step 0, as in JAX.
    ours._note_version(1, 99999)
    theirs._note_version(1, 99999)
    assert ours.staleness() == theirs.staleness()


def test_throttle_check_matches_jax():
    spec_args = (3, 1, np.array([-2.0], np.float32), np.array([2.0], np.float32))
    common = dict(num_actors=1, transport="queue", actor_throttle_s=31.0)
    with pytest.raises(ValueError) as theirs:
        JaxActorPool(JaxConfig(**common), JaxEnvSpec(*spec_args))
    with pytest.raises(ValueError) as ours:
        ActorPool(DDPGConfig(device="cpu", **common), EnvSpec(*spec_args))
    assert str(ours.value) == str(theirs.value)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    """--profile_dir on the CPU: the loop under torch.profiler, written to
    profile_dir/profile.json (the CPU's activities only; the card's
    kernels are checked by chip_smoke.py)."""
    from test_torch_slice import train_in_subprocess

    records = train_in_subprocess([
        "--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--learner_chunk=4", "--replay_min_size=200",
        "--total_env_steps=400", "--eval_every=0", "--eval_episodes=1",
        f"--profile_dir={tmp_path / 'prof'}"], tmp_path / "m.jsonl")
    assert records[-1]["kind"] == "final" and records[-1]["chunks"] >= 1
    events = json.loads((tmp_path / "prof" / "profile.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
