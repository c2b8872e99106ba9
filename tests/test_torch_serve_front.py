"""The port's network serving front (distributed_ddpg_tpu_torch/serve/front/)
against the JAX package's (distributed_ddpg_tpu/serve/front/):

- `encode_frame` byte for byte and `validate_request` code for code; the
  framing errors of `read_frame`; the error codes and HTTP statuses;
- `parse_tenants`, `TokenBucket` and `QosGate` on a fake clock;
- `SnapshotStore` routing and lifecycle, and `CanaryGate` verdicts on the
  same latency sequences;
- the front fault grammar against JAX's FaultPlan;
- TCP and HTTP end to end on localhost (numpy and device engines, the
  latter on the CPU), typed errors that never kill the acceptor, the
  injected frame and accept faults, priority-ordered shedding and the
  rate cap, the canary lifecycle over one connection, and SAC's served
  samples bit for bit JAX's;
- serve_bench's socket digest keys.

Where JAX's tests measure wall time the checks here use injected latencies
far from the thresholds, or fake clocks.
"""

import http.client
import json
import random
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import faults as jax_faults
from distributed_ddpg_tpu.serve import InferenceServer as JaxInferenceServer
from distributed_ddpg_tpu.serve import front as jax_front
from distributed_ddpg_tpu.serve.front import ingress as jax_ingress
from distributed_ddpg_tpu.serve.front import wire as jax_wire
from distributed_ddpg_tpu_torch import faults
from distributed_ddpg_tpu_torch.actors.policy import (
    NumpyPolicy,
    actor_head_dim,
    layout_size,
    param_layout,
)
from distributed_ddpg_tpu_torch.serve import InferenceServer
from distributed_ddpg_tpu_torch.serve import front
from distributed_ddpg_tpu_torch.serve.batcher import Batcher
from distributed_ddpg_tpu_torch.serve.front import (
    CanaryGate,
    FrontClient,
    FrontError,
    FrontServer,
    QosGate,
    SnapshotStore,
    TokenBucket,
    parse_tenants,
)
from distributed_ddpg_tpu_torch.serve.front import ingress, wire

torch.set_num_threads(1)

OBS, ACT, HIDDEN = 5, 2, (16, 16)
LAYOUT = param_layout(OBS, ACT, HIDDEN)
SAC_LAYOUT = param_layout(OBS, actor_head_dim(ACT, sac=True), HIDDEN)
SAC_SEED = 11


def _flat(seed=0, layout=LAYOUT):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(layout_size(layout)) * 0.3).astype(np.float32)


def _obs(seed=1):
    return np.random.default_rng(seed).standard_normal(OBS).astype(np.float32)


def _engine(backend="numpy", **kw):
    def make():
        return InferenceServer(LAYOUT, np.ones(ACT, np.float32), backend=backend,
                               max_batch=kw.get("max_batch", 8), max_latency_s=0.002,
                               max_queue=kw.get("max_queue", 64),
                               **({"device": "cpu"} if backend == "jax" else {}))
    return make


def _start(make=None, **kw):
    f = FrontServer(make or _engine(), **kw)
    f.publish("v1", _flat(1))
    return f.start()


def _local(flat=None):
    pol = NumpyPolicy(LAYOUT, np.ones(ACT, np.float32))
    pol.load_flat(_flat(1) if flat is None else flat)
    return pol


# --- the wire ---------------------------------------------------------------------

FRAMES = [
    {"tenant": "t", "request_id": 1, "obs": [0.5]},
    {"request_id": 7, "action": [0.25, -1.0, 3e-08], "version": "live-0"},
    {"request_id": None, "error": "bad_frame", "message": "ünïcode ✓"},
    {"tenant": "a b", "request_id": -3, "obs": [1, 2.5, -0.0], "version": "v2"},
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_encode_frame_byte_for_byte(i):
    ours = wire.encode_frame(FRAMES[i])
    assert ours == jax_wire.encode_frame(FRAMES[i])
    (n,) = struct.unpack(">I", ours[:4])
    assert n == len(ours) - 4
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, FRAMES[i])
        assert jax_wire.read_frame(b) == FRAMES[i]
        jax_wire.send_frame(a, FRAMES[i])
        assert wire.read_frame(b) == FRAMES[i]
    finally:
        a.close()
        b.close()


def test_wire_constants_and_statuses_are_jaxs():
    assert wire.ERROR_CODES == jax_wire.ERROR_CODES
    assert wire.MAX_FRAME == jax_wire.MAX_FRAME == 1 << 20
    assert ingress._HTTP_STATUS == jax_ingress._HTTP_STATUS
    for code in wire.ERROR_CODES:
        assert wire.error_response(4, code, "m") == jax_wire.error_response(4, code, "m")
    for mod in (wire, jax_wire):
        with pytest.raises(ValueError):
            mod.error_response(1, "not_a_code", "m")
        with pytest.raises(ValueError):
            mod.WireError("not_a_code", "m")
    with pytest.raises(wire.WireError) as e:
        wire.encode_frame({"obs": [0.0] * (wire.MAX_FRAME // 4)})
    assert e.value.code == "bad_frame"


REQUESTS = [
    {"tenant": "t", "request_id": 3, "obs": [1, 2.5]},
    {"tenant": "t", "request_id": 3, "obs": [1.0], "version": "v1"},
    {},
    {"tenant": 7, "request_id": 1, "obs": [1.0]},
    {"tenant": "t", "obs": [1.0]},
    {"tenant": "t", "request_id": True, "obs": [1.0]},
    {"tenant": "t", "request_id": 1},
    {"tenant": "t", "request_id": 1, "obs": []},
    {"tenant": "t", "request_id": 1, "obs": [1.0, "x"]},
    {"tenant": "t", "request_id": 1, "obs": [True]},
    {"tenant": "t", "request_id": 1, "obs": [1.0], "version": 4},
]


def _validated(mod, obj):
    try:
        return mod.validate_request(obj)
    except mod.WireError as e:
        return (e.code, str(e))


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_validate_request_code_for_code(i):
    assert _validated(wire, REQUESTS[i]) == _validated(jax_wire, REQUESTS[i])


READ_CASES = {
    "oversized_length": struct.pack(">I", (1 << 20) + 1),
    "not_json": struct.pack(">I", 8) + b"not json",
    "not_a_dict": struct.pack(">I", 5) + b"[1,2]",
    "torn_body": struct.pack(">I", 100) + b"{",
    "torn_header": b"\x00\x00",
    "clean_eof": b"",
}


def _read(mod, raw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.close()
        try:
            return ("ok", mod.read_frame(b))
        except mod.WireError as e:
            return (e.code, str(e))
    finally:
        b.close()


@pytest.mark.parametrize("case", list(READ_CASES))
def test_read_frame_errors_as_jax(case):
    assert _read(wire, READ_CASES[case]) == _read(jax_wire, READ_CASES[case])


# --- QoS -----------------------------------------------------------------------------

TENANT_SPECS = ["gold:0;silver:1:10;bronze:3:5:20", "", " ; ", "gold", "gold:0:1:2:3", ":0",
                "gold:x", "gold:-1", "gold:0:-2", "gold:0:5:0.5", "gold:0;gold:1",
                "a:2:0.5; b:0 ;c:1:3:4"]


def _tenants(mod, spec):
    try:
        return {k: tuple(v) for k, v in mod.parse_tenants(spec).items()}
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("spec", TENANT_SPECS)
def test_parse_tenants_as_jax(spec):
    assert _tenants(front, spec) == _tenants(jax_front, spec)


def test_token_bucket_and_qos_gate_on_a_fake_clock_as_jax():
    rng = random.Random(0)
    times = np.cumsum([rng.choice([0.0, 0.0, 0.1, 0.25, 0.5, 2.0]) for _ in range(200)])
    ours, theirs = TokenBucket(rate=2.0, burst=3.0), jax_front.TokenBucket(rate=2.0, burst=3.0)
    seq = [ours.allow(t) for t in times]
    assert seq == [theirs.allow(t) for t in times]
    assert True in seq and False in seq
    table = "gold:0;capped:1:1:1;silver:1;bronze:2"
    clock = [0.0]
    gates = [mod.QosGate(mod.parse_tenants(table), default_priority=2, shed_start=0.5,
                         clock=lambda: clock[0]) for mod in (front, jax_front)]
    for gate in gates:
        assert gate.threshold(0) == 1.0
    assert [gates[0].threshold(p) for p in range(5)] == [gates[1].threshold(p) for p in range(5)]
    verdicts = [[], []]
    for k in range(400):
        clock[0] = float(times[k % 200]) + 100.0 * (k // 200)
        tenant = rng.choice(["gold", "capped", "silver", "bronze", "stranger"])
        depth = rng.randrange(0, 101)
        for j, gate in enumerate(gates):
            verdicts[j].append(gate.admit(tenant, depth, 100))
    assert verdicts[0] == verdicts[1]
    assert {"rate", "priority", None} <= set(verdicts[0])


# --- snapshots and the canary gate ----------------------------------------------------


def test_snapshot_store_routing_and_lifecycle_as_jax():
    stores = (SnapshotStore(), jax_front.SnapshotStore())
    for s in stores:
        with pytest.raises(RuntimeError):
            s.route("t", 1)
        s.publish("v1", _flat(1))
        s.publish("v2", _flat(2))
        with pytest.raises(ValueError):
            s.publish("v1", _flat(3))
        with pytest.raises(ValueError):
            s.get("v1")[0] = 9.0
        with pytest.raises(ValueError):
            s.start_canary("v1", 0.5)
        with pytest.raises(KeyError):
            s.start_canary("v9", 0.5)
        with pytest.raises(ValueError):
            s.start_canary("v2", 1.0)
        s.start_canary("v2", 0.3)
    keys = [(t, rid) for t in ("alice", "bob", "0", "tenant") for rid in range(300)]
    routes = [[s.route(t, rid) for t, rid in keys] for s in stores]
    assert routes[0] == routes[1]
    share = sum(c for _, c in routes[0]) / len(keys)
    assert 0.2 < share < 0.4
    for s in stores:
        assert s.promote() == "v2" and (s.stable, s.candidate) == ("v2", None)
        assert s.rollback() is None
        s.publish("v3", _flat(3))
        s.start_canary("v3", 0.5)
        assert s.rollback() == "v3" and s.stable == "v2"
        with pytest.raises(ValueError):
            s.promote()


def _latency_sequence(kind, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        out.append((False, rng.uniform(0.004, 0.006), False))
        if kind == "clean":
            out.append((True, rng.uniform(0.004, 0.006), False))
        elif kind == "slow":
            out.append((True, rng.uniform(0.012, 0.02), False))
        else:   # errors
            out.append((True, rng.uniform(0.004, 0.006), rng.random() < 0.3))
    return out


@pytest.mark.parametrize("kind", ["clean", "slow", "errors"])
def test_canary_gate_verdicts_on_the_same_sequences_as_jax(kind):
    gates = (CanaryGate(min_requests=5, threshold=0.5, seed=3),
             jax_front.CanaryGate(min_requests=5, threshold=0.5, seed=3))
    trail = [[], []]
    for arm, lat, err in _latency_sequence(kind, seed=len(kind)):
        for g, t in zip(gates, trail):
            g.record(arm, lat, error=err)
            t.append(g.verdict())
    assert trail[0] == trail[1]
    assert gates[0].stats() == gates[1].stats()
    want = {"clean": "promote", "slow": "rollback", "errors": "rollback"}[kind]
    assert trail[0][-1] == want and trail[0][0] is None
    gates[0].reset()
    assert gates[0].verdict() is None


# --- the front fault grammar --------------------------------------------------------------

GOOD_FRONT_SPECS = ["front:accept:stall@1~0.01;front:frame:corrupt@2;front:canary:regress@3~0.05",
                    "front:canary:regress@4", "front:accept:slow@2;front:accept:hang@3"]
BAD_FRONT_SPECS = ["front:accept:corrupt@1", "front:canary:stall@1", "front:frame:stall@1",
                   "front:unknown:stall@1", "front:regress@1"]


@pytest.mark.parametrize("spec", GOOD_FRONT_SPECS)
def test_front_fault_grammar_as_jax(spec):
    ours, theirs = faults.FaultPlan.parse(spec, seed=5), jax_faults.FaultPlan.parse(spec, seed=5)
    assert [(s.describe(), s.duration_s) for s in ours.specs] == \
        [(s.describe(), s.duration_s) for s in theirs.specs]
    assert ours.front_canary_regressions() == theirs.front_canary_regressions()
    for target in ("accept", "frame"):
        assert sorted(ours.site("front", target)._by_at) == \
            sorted(theirs.site("front", target)._by_at)


@pytest.mark.parametrize("spec", BAD_FRONT_SPECS)
def test_bad_front_fault_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as theirs:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        faults.FaultPlan.parse(spec)
    assert str(ours.value).split(" (grammar")[0] == str(theirs.value).split(" (grammar")[0]


# --- the front end to end --------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_front_tcp_end_to_end_and_typed_errors(backend):
    f = _start(_engine(backend))
    try:
        pol = _local()
        with FrontClient(f.port, tenant="t0") as cli:
            for seed in range(6):
                action, version = cli.act(_obs(seed))
                assert action.shape == (ACT,) and version == "v1"
                want = pol(_obs(seed)).reshape(-1)
                if backend == "numpy":
                    assert np.array_equal(action, want)
                else:
                    np.testing.assert_allclose(action, want, rtol=0, atol=1e-5)
            assert cli.act(_obs(), version="v1")[1] == "v1"
            with pytest.raises(FrontError) as e:
                cli.act(_obs(), version="nope")
            assert e.value.code == "bad_frame"
            assert cli.request({"tenant": "", "request_id": 1, "obs": [1.0]})["error"] == \
                "bad_frame"
            assert cli.act(_obs())[0].shape == (ACT,)   # the connection still serves
        bad = socket.create_connection(("127.0.0.1", f.port), timeout=5.0)
        bad.sendall(struct.pack(">I", wire.MAX_FRAME + 7))
        assert wire.read_frame(bad)["error"] == "bad_frame"
        assert bad.recv(1) == b""     # only this connection was torn down
        bad.close()
        with FrontClient(f.port, tenant="t1") as cli:
            assert cli.act(_obs())[0].shape == (ACT,)
        snap = f.snapshot()
        assert snap["front_requests"] >= 10 and snap["front_bad_frames"] >= 2
        assert snap["tenant_served"] >= 9 and snap["front_wire_p95_ms"] > 0.0
    finally:
        f.stop()


def test_front_http_adapter_statuses():
    f = _start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", f.http_port, timeout=5.0)
        body = json.dumps({"tenant": "h", "request_id": 1, "obs": _obs().tolist()})
        cases = [("/act", body, 200), ("/act", "not json", 400), ("/elsewhere", body, 404),
                 ("/act", json.dumps({"request_id": 1, "obs": [1.0]}), 400)]
        for path, payload, status in cases:
            conn.request("POST", path, payload, {"Content-Type": "application/json"})
            r = conn.getresponse()
            obj = json.loads(r.read())
            assert r.status == status, (path, payload, obj)
            if status == 200:
                assert obj["version"] == "v1"
                assert np.array_equal(np.asarray(obj["action"], np.float32),
                                      _local()(_obs()).reshape(-1))
            else:
                assert obj["error"] == "bad_frame"
        conn.close()
        assert f.snapshot()["front_http_requests"] >= 1
    finally:
        f.stop()


def test_injected_frame_and_accept_faults_leave_the_acceptor_serving():
    plan = faults.FaultPlan.parse("front:frame:corrupt@2;front:accept:stall@1~0.05")
    f = _start(fault_frame=plan.site("front", "frame"), fault_accept=plan.site("front", "accept"))
    try:
        with FrontClient(f.port, tenant="t") as cli:
            cli.act(_obs())                       # the first connection ate the stall
            with pytest.raises(FrontError) as e:
                cli.act(_obs())                   # frame 2: injected corrupt
            assert e.value.code == "bad_frame"
            assert cli.act(_obs())[0].shape == (ACT,)   # the same connection
        with FrontClient(f.port, tenant="u") as cli:
            assert cli.act(_obs())[0].shape == (ACT,)
        assert f.snapshot()["front_bad_frames"] == 1
    finally:
        f.stop()


class _ParkedEngine:
    """An engine whose apply parks until released: its queue depth is the
    test's to set."""

    sac = False

    def __init__(self, max_queue):
        self.entered, self.release = threading.Event(), threading.Event()

        def apply(batch):
            self.entered.set()
            self.release.wait(10.0)
            return batch[:, :ACT].copy()

        self.batcher = Batcher(apply, max_batch=1, max_latency_s=0.0, max_queue=max_queue)

    def refresh(self, flat):
        pass

    def start(self):
        self.batcher.start()
        return self

    def close(self, timeout=5.0):
        self.release.set()
        self.batcher.close(timeout=timeout)


def test_shed_ordering_strictly_lowest_priority_first():
    engines = []

    def make():
        engines.append(_ParkedEngine(max_queue=20))
        return engines[-1]

    f = FrontServer(make, tenants="gold:0;silver:1;bronze:2", shed_start=0.5, timeout_s=0.05,
                    http_port=None)
    f.publish("v1", _flat(1))
    f.start()
    try:
        def req(tenant, rid):
            return f.handle_request({"tenant": tenant, "request_id": rid,
                                     "obs": _obs().tolist()})

        assert req("gold", 1)["error"] == "timeout"
        eng = engines[0]
        assert eng.entered.wait(5.0)

        def fill_to(depth):
            while eng.batcher.depth() < depth:
                eng.batcher.submit(np.zeros(OBS, np.float32), lambda r: None)

        fill_to(10)    # bronze sheds at depth >= 10, silver at >= 15, gold never
        assert [req(t, i)["error"] for i, t in enumerate(("bronze", "silver", "gold"), 2)] == \
            ["shed", "timeout", "timeout"]
        fill_to(16)
        assert [req(t, i)["error"] for i, t in enumerate(("bronze", "silver", "gold"), 5)] == \
            ["shed", "shed", "timeout"]
        per = f.tenant_stats.per_tenant()
        assert [per[t]["shed_priority"] for t in ("bronze", "silver", "gold")] == [2, 1, 0]
        snap = f.snapshot()
        assert (snap["front_sheds"], snap["tenant_shed_priority"], snap["front_timeouts"]) == \
            (3, 3, 4)
    finally:
        f.stop()


def test_tenant_rate_cap_is_the_rate_cause():
    f = _start(tenants="capped:1:0.001:1", http_port=None)
    try:
        def req(rid):
            return f.handle_request({"tenant": "capped", "request_id": rid,
                                     "obs": _obs().tolist()})
        assert "action" in req(1)
        resp = req(2)
        assert resp["error"] == "shed" and "rate" in resp["message"]
        per = f.tenant_stats.per_tenant()["capped"]
        assert (per["shed_rate"], per["shed_priority"]) == (1, 0)
    finally:
        f.stop()


def test_canary_rollback_then_repromote_over_one_connection():
    """An injected 0.2 s regression on every candidate request (some 40x
    the stable arm's latency here) is rolled back, never promoted; with it
    cleared and the latency gate opened wide (the gate's latency verdicts
    are held against JAX's on fixed sequences above), the same version
    re-canaries and promotes, and the connection that drove it all serves
    the new stable version."""
    plan = faults.FaultPlan.parse("front:canary:regress@1~0.2")
    f = FrontServer(_engine(), canary_fraction=0.5, canary_min_requests=5,
                    canary_threshold=0.5, http_port=None,
                    canary_regressions=plan.front_canary_regressions())
    f.publish("v1", _flat(1))
    f.publish("v2", _flat(2))
    f.start()
    try:
        cli = FrontClient(f.port, tenant="drill", timeout_s=10.0)

        def drive_until(pred, budget=300):
            for _ in range(budget):
                cli.act(_obs())
                if pred(f.snapshot()):
                    return True
            return False

        f.start_canary("v2")
        assert drive_until(lambda s: s["front_rollbacks"] >= 1)
        snap = f.snapshot()
        assert snap["front_promotes"] == 0 and snap["front_canary_requests"] > 0
        assert (f.store.stable, f.store.candidate) == ("v1", None)
        f._canary_regs = ()
        f.gate.threshold = 1e6
        f.start_canary("v2")
        assert drive_until(lambda s: s["front_promotes"] >= 1)
        assert f.snapshot()["front_rollbacks"] == 1 and f.store.stable == "v2"
        action, version = cli.act(_obs())
        assert version == "v2"
        assert np.array_equal(action, _local(_flat(2))(_obs()).reshape(-1))
        cli.close()
    finally:
        f.stop()


def _sac_engine():
    return InferenceServer(SAC_LAYOUT, np.ones(ACT, np.float32), sac=True, seed=SAC_SEED,
                           max_batch=8, max_latency_s=0.002, max_queue=64)


def test_sac_samples_over_the_front_bit_for_bit_as_jax():
    flat = _flat(5, SAC_LAYOUT)
    ref = JaxInferenceServer(SAC_LAYOUT, np.ones(ACT, np.float32), sac=True, seed=SAC_SEED)
    ref.refresh(flat)
    f = FrontServer(_sac_engine, http_port=None)
    f.publish("v1", flat)
    f.start()
    try:
        obs = _obs(9)
        head = ref._compute(obs[None, :])[0]
        with FrontClient(f.port, tenant="alice") as cli:
            for rid in (10, 11):
                action, _ = cli.act(obs, request_id=rid)
                assert np.array_equal(action, ref.sample(head, tenant="alice", request_id=rid))
            replay, _ = cli.act(obs, request_id=10)
        with FrontClient(f.port, tenant="bob") as cli:
            other, _ = cli.act(obs, request_id=10)
        assert np.array_equal(replay, ref.sample(head, tenant="alice", request_id=10))
        assert not np.array_equal(replay, other)
    finally:
        f.stop()


def test_socket_bench_digest_keys_are_jaxs():
    from distributed_ddpg_tpu.tools.serve_bench import run_socket_bench as jax_bench
    from distributed_ddpg_tpu_torch.tools.serve_bench import main, run_socket_bench

    kw = dict(clients=2, duration_s=0.3, obs_dim=4, act_dim=2, hidden=(8, 8), max_batch=4,
              max_latency_ms=2.0, tenants="gold:0;bronze:3")
    ours = run_socket_bench(backend="jax", device="cpu", **kw)
    assert set(ours) == set(jax_bench(**kw))
    assert ours["transport"] == "socket" and ours["served_rps"] > 0
    assert ours["front_requests"] > 0 and ours["wire_p95_ms"] > 0 and ours["tenant_count"] == 2
    assert main(["--transport=socket", "--clients=1", "--duration_s=0.2", "--obs_dim=3",
                 "--act_dim=1", "--hidden=8,8", "--max_batch=4"]) == 0
