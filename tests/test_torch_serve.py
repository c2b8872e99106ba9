"""The port's policy-inference service (distributed_ddpg_tpu_torch/serve/)
against the JAX package's (distributed_ddpg_tpu/serve/), on seeded numpy
inputs:

- the batcher's composition (a full batch at once, a partial one at its
  deadline, the flush on close), its typed overload and its typed errors,
  scenario by scenario the same outcome as JAX's Batcher;
- the numpy backend's actions bit for bit JAX's server's and local act()'s
  (DDPG and SAC's head rows);
- the device backend on device='cpu' against JAX's backend='jax' server,
  DDPG and SAC's head, n < and = max_batch, at atol 1e-5; padded rows
  never reach an answer;
- `sample()` bit for bit JAX's; the seqlock refresh as JAX's;
- the transfer scheduler's serve class (the device apply waited for off
  its dispatch thread), a dead scheduler, the client's deadline, all
  typed; tools/serve_checks (the on-card checks) on the CPU;
- the serve fault grammar against JAX's FaultPlan (durations included);
- the 16 serve and front fields' defaults, and JAX's messages for bad
  values; serving on more than one rank accepted as JAX accepts it, and
  mesh= on a group of one rank against the numpy oracle (the TP apply
  on ranks: tests/test_torch_serve_ranks.py);
- serve_bench's digest keys; a served CLI run at tiny width, healthy;
- the served worker's fallbacks: a missed deadline counted as JAX's
  worker counts it, a wait cut short by the pool's stop not counted (JAX
  counts it: a deviation);
- the repaired device defaults (DeviceReplay, DevicePrioritizedReplay,
  the vector envs, make_vector_env) on the card, raising without one.

Fake clocks and injected latencies stand where a check would otherwise
depend on wall time.
"""

import dataclasses
import json
import multiprocessing as mp
import threading
import time

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import config as jax_config
from distributed_ddpg_tpu import faults as jax_faults
from distributed_ddpg_tpu import serve as jax_serve
from distributed_ddpg_tpu.actors import policy as jax_policy
from distributed_ddpg_tpu.metrics import ServeStats as JaxServeStats
from distributed_ddpg_tpu_torch import faults, serve
from distributed_ddpg_tpu_torch.actors.policy import (
    NumpyPolicy,
    actor_head_dim,
    layout_size,
    param_layout,
)
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.metrics import ServeStats

torch.set_num_threads(1)

OBS, ACT, HIDDEN = 5, 2, (16, 16)
LAYOUT = param_layout(OBS, ACT, HIDDEN)
SAC_LAYOUT = param_layout(OBS, actor_head_dim(ACT, sac=True), HIDDEN)
ATOL = 1e-5
BOTH = {"jax": (jax_serve, JaxServeStats), "port": (serve, ServeStats)}


def _flat(layout=LAYOUT, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(layout_size(layout)) * 0.3).astype(np.float32)


def _obs(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, OBS)).astype(np.float32)


def _collect(n):
    results = [None] * n
    done = threading.Event()
    left = [n]
    lock = threading.Lock()

    def cb_for(i):
        def cb(result):
            results[i] = result
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return cb

    return cb_for, results, done


# --- the batcher ----------------------------------------------------------------

# scenario -> (max_batch, max_latency_s, requests, close before waiting)
COMPOSITION = {
    "full": (4, 30.0, 4, False),       # a full batch goes at once
    "deadline": (64, 0.05, 3, False),  # one partial batch at the deadline
    "flush": (1024, 3600.0, 5, True),  # only the close's flush dispatches
}


def _composition(which, scenario):
    mod, stats_cls = BOTH[which]
    max_batch, latency, n, close_first = COMPOSITION[scenario]
    sizes = []

    def echo(batch):
        sizes.append(len(batch))
        return batch[:, :ACT].copy()

    stats = stats_cls(max_batch=max_batch)
    b = mod.Batcher(echo, max_batch=max_batch, max_latency_s=latency, max_queue=64,
                    stats=stats).start()
    cb_for, results, done = _collect(n)
    obs = _obs(n)
    try:
        for i in range(n):
            b.submit(obs[i], cb_for(i))
        if close_first:
            b.close()
        assert done.wait(5.0)
        closed = None
        if close_first:
            try:
                b.submit(obs[0], lambda r: None)
            except mod.ServeClosed:
                closed = "ServeClosed"
    finally:
        b.close()
    snap = stats.snapshot()
    return dict(sizes=sizes, results=[r.tolist() for r in results], closed=closed,
                **{k: snap[k] for k in ("serve_batches", "serve_requests", "serve_fill_mean")})


@pytest.mark.parametrize("scenario", list(COMPOSITION))
def test_batcher_composition_matches_jax(scenario):
    ours, theirs = _composition("port", scenario), _composition("jax", scenario)
    assert ours == theirs
    assert sum(ours["sizes"]) == COMPOSITION[scenario][2] and ours["serve_batches"] == 1


def _overload(which):
    mod, stats_cls = BOTH[which]
    gate, entered = threading.Event(), threading.Event()

    def blocking(batch):
        entered.set()
        gate.wait(10.0)
        return batch[:, :ACT].copy()

    stats = stats_cls(max_batch=1)
    b = mod.Batcher(blocking, max_batch=1, max_latency_s=0.0, max_queue=3,
                    stats=stats).start()
    outcome = []
    try:
        b.submit(_obs(1)[0], lambda r: None)   # dispatched, parked in the apply
        assert entered.wait(5.0)
        for i in range(5):
            try:
                b.submit(_obs(1)[0], lambda r: None)
                outcome.append("ok")
            except mod.ServeOverload as e:
                outcome.append(f"overload: {e}")
        depth = b.depth()
    finally:
        gate.set()
        b.close()
    return outcome, depth, stats.snapshot()["serve_overloads"]


def test_batcher_overload_is_typed_as_jax():
    ours = _overload("port")
    assert ours == _overload("jax")
    assert ours == (["ok"] * 3 + ["overload: serve request queue full (3 pending)"] * 2, 3, 2)


def _errors(which, case):
    mod, stats_cls = BOTH[which]
    calls = [0]

    def apply(batch):
        calls[0] += 1
        if case == "apply_raises" and calls[0] == 1:
            raise RuntimeError("boom")
        return batch[:, :ACT].copy()

    stats = stats_cls(max_batch=2)
    b = mod.Batcher(apply, max_batch=2, max_latency_s=0.02, max_queue=8, stats=stats).start()
    try:
        cb_for, results, done = _collect(2)
        b.submit(np.zeros(OBS, np.float32), cb_for(0))
        bad = np.zeros(OBS + 1 if case == "malformed" else OBS, np.float32)
        b.submit(bad, cb_for(1))
        assert done.wait(5.0)
        # The thread survived the failed batch: the next request serves.
        cb2, r2, d2 = _collect(1)
        b.submit(np.ones(OBS, np.float32), cb2(0))
        assert d2.wait(5.0)
    finally:
        b.close()
    return ([type(r).__name__ for r in results], r2[0].tolist(),
            stats.snapshot()["serve_errors"])


@pytest.mark.parametrize("case", ["malformed", "apply_raises"])
def test_batcher_typed_errors_match_jax(case):
    ours = _errors("port", case)
    assert ours == _errors("jax", case)
    assert ours == (["ServeDispatchError"] * 2, [1.0, 1.0], 1)


# --- the InferenceServer ----------------------------------------------------------


def _servers(layout, backend, sac=False, max_batch=8, **kw):
    common = dict(max_batch=max_batch, max_latency_s=0.002, max_queue=64, seed=11, sac=sac,
                  log_std_min=-5.0, log_std_max=2.0, **kw)
    scale, offset = np.full(ACT, 1.5, np.float32), np.full(ACT, 0.25, np.float32)
    ours = serve.InferenceServer(layout, scale, offset, backend=backend,
                                 **({"device": "cpu"} if backend == "jax" else {}), **common)
    theirs = jax_serve.InferenceServer(layout, scale, offset, backend=backend, **common)
    return ours, theirs


@pytest.mark.parametrize("sac", [False, True], ids=["ddpg", "sac"])
def test_numpy_backend_bit_identical_to_jax_and_local_act(sac):
    layout = SAC_LAYOUT if sac else LAYOUT
    flat = _flat(layout)
    ours, theirs = _servers(layout, "numpy", sac=sac)
    ours.start()
    try:
        ours.refresh(flat)
        theirs.refresh(flat)
        obs = _obs(24)
        got = ours._compute(obs)
        assert got.dtype == np.float32
        assert np.array_equal(got, theirs._compute(obs))
        local = NumpyPolicy(layout, np.full(ACT, 1.5, np.float32), np.full(ACT, 0.25, np.float32),
                            gaussian=sac)
        local.load_flat(flat)
        jlocal = jax_policy.NumpyPolicy(layout, np.full(ACT, 1.5, np.float32),
                                        np.full(ACT, 0.25, np.float32), gaussian=sac)
        jlocal.load_flat(flat)
        for i in range(len(obs)):
            assert np.array_equal(local.head(obs[i]), jlocal.head(obs[i]))
            if not sac:
                assert np.array_equal(got[i], local(obs[i])[0])
        # Under real batched dispatch from concurrent clients too.
        cli = ours.client(timeout_s=5.0)
        served = [None] * 8
        threads = [threading.Thread(target=lambda i=i: served.__setitem__(i, cli.act(obs[i])))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        if not sac:
            for i in range(8):
                assert np.array_equal(served[i], local(obs[i])[0])
        assert ours.snapshot()["serve_requests"] == 8
    finally:
        ours.close()


@pytest.mark.parametrize("sac", [False, True], ids=["ddpg", "sac"])
@pytest.mark.parametrize("n", [3, 8], ids=["n<max_batch", "n=max_batch"])
def test_device_backend_on_cpu_matches_jax_device_backend(sac, n):
    layout = SAC_LAYOUT if sac else LAYOUT
    flat = _flat(layout, seed=2)
    ours, theirs = _servers(layout, "jax", sac=sac)
    ours.refresh(flat)
    theirs.refresh(flat)
    obs = _obs(n, seed=3)
    got = ours._compute(obs)
    assert got.shape == (n, 2 * ACT if sac else ACT) and got.dtype == np.float32
    np.testing.assert_allclose(got, theirs._compute(obs), rtol=0, atol=ATOL)
    # And the numpy oracle of either package.
    oracle, _ = _servers(layout, "numpy", sac=sac)
    oracle.refresh(flat)
    np.testing.assert_allclose(got, oracle._compute(obs), rtol=0, atol=ATOL)
    assert ours.device.type == "cpu"


def test_padded_rows_never_reach_an_answer():
    """The pad rows are zeroed before every apply and sliced off after it:
    garbage left in the padded buffer changes no answer, and a row's
    answer does not depend on the batch it shares."""
    flat = _flat(seed=4)
    ours, _ = _servers(LAYOUT, "jax")
    oracle, _ = _servers(LAYOUT, "numpy")
    ours.refresh(flat)
    oracle.refresh(flat)
    obs = _obs(8, seed=5)
    full = ours._compute(obs)
    ours._in_host.fill_(1e6)               # stale garbage in the pinned/padded buffer
    for n in (1, 3, 7):
        got = ours._compute(obs[:n])
        assert got.shape == (n, ACT)
        np.testing.assert_allclose(got, full[:n], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, oracle._compute(obs[:n]), rtol=0, atol=ATOL)
        assert not ours._in_host[n:].any()


@pytest.mark.parametrize("key", [("local", 1), ("local", 2), ("0", 7), ("bob", 2 ** 40)])
def test_sample_bit_for_bit_as_jax(key):
    flat = _flat(SAC_LAYOUT, seed=6)
    ours, theirs = _servers(SAC_LAYOUT, "numpy", sac=True)
    ours.refresh(flat)
    theirs.refresh(flat)
    head = ours._compute(_obs(1, seed=8))[0]
    tenant, rid = key
    a = ours.sample(head, tenant=tenant, request_id=rid)
    assert np.array_equal(a, theirs.sample(head, tenant=tenant, request_id=rid))
    assert np.array_equal(ours.sample(head, tenant=tenant, request_id=rid, explore=False),
                          theirs.sample(head, tenant=tenant, request_id=rid, explore=False))
    assert np.array_equal(a, ours.sample(head, tenant=tenant, request_id=rid))  # replayable
    with pytest.raises(RuntimeError):
        serve.InferenceServer(LAYOUT, 1.0).sample(head, tenant="t", request_id=1)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_seqlock_refresh_as_jax(backend):
    """An even version installs; an odd one (a write in progress) keeps the
    old params; the new params serve from the next batch on."""
    ctx = mp.get_context("spawn")
    shared = ctx.Array("f", layout_size(LAYOUT), lock=False)
    version = ctx.Value("l", 0)
    view = np.frombuffer(shared, dtype=np.float32)
    view[:] = _flat()
    version.value = 2
    ours, theirs = _servers(LAYOUT, backend, param_source=(shared, version))
    obs = _obs(2, seed=9)
    got = []
    for server in (ours, theirs):
        seq = [server._apply_batch(obs)]
        view[:] = 0.0
        version.value = 3                      # mid-write: skipped
        seq.append(server._apply_batch(obs))
        version.value = 4                      # consistent: installed
        seq.append(server._apply_batch(obs))
        view[:] = _flat()
        version.value = 2
        got.append((seq, server.snapshot()["serve_param_refreshes"]))
    (ours_seq, ours_n), (theirs_seq, theirs_n) = got
    assert ours_n == theirs_n == 2
    for a, b in zip(ours_seq, theirs_seq):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours_seq[1], ours_seq[0], rtol=0, atol=0)
    assert not np.allclose(ours_seq[2], ours_seq[0])
    np.testing.assert_allclose(ours_seq[2], np.tanh(np.zeros((2, ACT))) * 1.5 + 0.25, atol=ATOL)


def test_serve_rides_the_transfer_schedulers_serve_class():
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    sched = TransferScheduler().start()
    srv = serve.InferenceServer(LAYOUT, 1.0, max_batch=2, max_latency_s=0.01, max_queue=64,
                                scheduler=sched, backend="jax", device="cpu").start()
    try:
        srv.refresh(_flat())
        cli = srv.client(timeout_s=5.0)
        for row in _obs(4):
            cli.act(row)
        snap = sched.snapshot()
        assert snap["transfer_serve_items"] >= 2 and snap["transfer_serve_bytes"] > 0
        assert snap["transfer_dispatches"] >= snap["transfer_serve_items"]
    finally:
        srv.close()
        sched.close()


def test_device_apply_waits_on_its_event_off_the_schedulers_thread():
    """With a scheduler attached, the device backend's `serve` item only
    enqueues the batch; the wait for the apply's event runs on the
    batcher's thread, so a learner chunk that holds the apply back on the
    card does not hold the scheduler's one dispatch thread (every ingest
    ship behind it) too."""
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    sched = TransferScheduler().start()
    oracle, _ = _servers(LAYOUT, "numpy")
    srv = serve.InferenceServer(LAYOUT, oracle._policy.scale, oracle._policy.offset,
                                max_batch=4, max_latency_s=0.01, max_queue=64,
                                scheduler=sched, backend="jax", device="cpu")
    threads = {}
    for step in ("_enqueue_device", "_collect_device"):
        def spy(*a, _fn=getattr(srv, step), _step=step):
            threads[_step] = threading.current_thread().name
            return _fn(*a)
        setattr(srv, step, spy)
    try:
        srv.refresh(_flat())
        oracle.refresh(_flat())
        srv.start()
        obs = _obs(3, seed=11)
        got = np.stack([srv.client(timeout_s=5.0).act(row) for row in obs])
        np.testing.assert_allclose(got, oracle._compute(obs), rtol=0, atol=ATOL)
        assert threads["_enqueue_device"] == "transfer-sched"
        assert threads["_collect_device"] == srv.batcher._thread.name != "transfer-sched"
        assert sched.snapshot()["transfer_serve_items"] >= 1
    finally:
        srv.close()
        sched.close()


@pytest.mark.parametrize("sac", [False, True], ids=["ddpg", "sac"])
@pytest.mark.parametrize("shape", [(3, 1), (17, 6)], ids=["pendulum", "bench"])
def test_shared_serve_checks_pass_on_the_cpu(shape, sac):
    """tools/serve_checks (chip_smoke.py's phase 4f and the on-card tests)
    with the device apply on the CPU: the apply within 1e-5 of the oracle
    with garbage in the pad rows, bit-identical to a full batch's rows; the
    seqlock refresh from the next batch on."""
    from distributed_ddpg_tpu_torch.tools import serve_checks as sc

    obs, act = shape
    err, same, srv = sc.check_apply(obs, act, sac, "cpu", atol=1e-5, seed=obs + 10 * sac)
    assert srv.device.type == "cpu" and err <= 1e-5 and same
    if (shape, sac) == ((3, 1), False):
        assert sc.check_seqlock_refresh("cpu", atol=1e-5).snapshot()[
            "serve_param_refreshes"] == 2


def test_dead_scheduler_and_client_deadline_are_typed():
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    sched = TransferScheduler().start()
    sched.close()
    srv = serve.InferenceServer(LAYOUT, 1.0, max_batch=1, max_latency_s=0.0, max_queue=8,
                                scheduler=sched).start()
    try:
        srv.refresh(_flat())
        with pytest.raises(serve.ServeDispatchError):
            srv.client(timeout_s=5.0).act(_obs(1)[0])
    finally:
        srv.close()
    gate = threading.Event()
    slow = serve.Batcher(lambda b: gate.wait(10.0) and b[:, :ACT], max_batch=1,
                         max_latency_s=0.0, max_queue=8).start()
    srv = serve.InferenceServer(LAYOUT, 1.0, max_batch=1, max_latency_s=0.0, max_queue=8)
    srv.batcher.close()
    srv.batcher = slow
    try:
        with pytest.raises(serve.ServeTimeout):
            srv.client(timeout_s=0.1).act(_obs(1)[0])
    finally:
        gate.set()
        slow.close()


def test_injected_serve_faults_fail_typed_and_delay():
    """serve:dispatch:crash@2 fails the second batch typed;
    serve:batcher:stall@1~0.3 holds the first batch's answer 0.3 s, which
    a client with a 0.1 s deadline sees as ServeTimeout."""
    plan = faults.FaultPlan.parse("serve:dispatch:crash@2;serve:batcher:stall@1~0.3")
    srv = serve.InferenceServer(LAYOUT, 1.0, max_batch=1, max_latency_s=0.0, max_queue=8,
                                fault_batcher=plan.site("serve", "batcher"),
                                fault_dispatch=plan.site("serve", "dispatch")).start()
    try:
        srv.refresh(_flat())
        cli = srv.client(timeout_s=0.1)
        with pytest.raises(serve.ServeTimeout):
            cli.act(_obs(1)[0])
        time.sleep(0.4)
        with pytest.raises(serve.ServeDispatchError):
            cli.act(_obs(1)[0], timeout_s=5.0)
        assert cli.act(_obs(1)[0], timeout_s=5.0).shape == (ACT,)
        assert srv.snapshot()["serve_errors"] == 1
    finally:
        srv.close()


# --- the fault grammar -----------------------------------------------------------

GOOD_SERVE_SPECS = [
    "serve:batcher:stall@2~0.5;serve:dispatch:crash@3",
    "serve:batcher:stall@1",           # a seeded default duration
    "serve:batcher:hang@4;serve:batcher:slow@2",
    "serve:dispatch:slow@5;numeric:grad:nan@3",
]
BAD_SERVE_SPECS = ["serve:batcher:crash@1", "serve:unknown:stall@1",
                   "serve:dispatch:stall@1", "serve:stall@1", "serve:dispatch:crash@0"]


@pytest.mark.parametrize("spec", GOOD_SERVE_SPECS)
def test_serve_fault_grammar_as_jax(spec):
    ours, theirs = faults.FaultPlan.parse(spec, seed=3), jax_faults.FaultPlan.parse(spec, seed=3)
    assert [(s.describe(), s.duration_s) for s in ours.specs] == \
        [(s.describe(), s.duration_s) for s in theirs.specs]
    for target in ("batcher", "dispatch"):
        assert sorted(ours.site("serve", target)._by_at) == \
            sorted(theirs.site("serve", target)._by_at)


@pytest.mark.parametrize("spec", BAD_SERVE_SPECS)
def test_bad_serve_fault_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as theirs:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        faults.FaultPlan.parse(spec)
    assert str(ours.value).split(" (grammar")[0] == str(theirs.value).split(" (grammar")[0]


def test_dispatch_crash_site_raises_on_its_tick():
    site = faults.FaultPlan.parse("serve:dispatch:crash@3").site("serve", "dispatch")
    site.tick()
    site.tick()
    with pytest.raises(faults.InjectedFault):
        site.tick()
    site.tick()
    assert site.fired == ["serve:dispatch:crash@3"] and site.calls == 4


# --- the config --------------------------------------------------------------------

SERVE_FIELDS = ("serve_actors", "serve_max_batch", "serve_max_latency_ms", "serve_queue",
                "serve_timeout_s", "serve_fallback_s", "serve_backend", "front_port",
                "front_http_port", "front_timeout_s", "front_canary_fraction",
                "front_canary_min_requests", "front_canary_threshold", "front_tenants",
                "front_default_priority", "front_shed_start")
BAD_CONFIGS = [
    dict(serve_actors=True, backend="native"),
    dict(serve_actors=True, strict_sync=True, max_learn_ratio=1.0, max_ingest_ratio=1.0),
    dict(serve_max_batch=0), dict(serve_max_latency_ms=-1.0), dict(serve_queue=0),
    dict(serve_timeout_s=0.0), dict(serve_fallback_s=-1.0), dict(serve_backend="torch"),
    dict(front_port=7777), dict(front_port=-1), dict(front_http_port=70000),
    dict(serve_actors=True, front_port=7777, front_http_port=7777),
    dict(front_timeout_s=0.0), dict(front_canary_fraction=1.0),
    dict(front_canary_min_requests=0), dict(front_canary_threshold=0.0),
    dict(front_default_priority=-1), dict(front_shed_start=1.5),
    dict(front_tenants="gold"), dict(front_tenants="a:0;a:1"),
    dict(serve_actors=True, actor_backend="device", num_actors=0),
]


def test_serve_and_front_field_defaults_are_jaxs():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_config.DDPGConfig)}
    assert len(SERVE_FIELDS) == 16
    assert {k: ours[k] for k in SERVE_FIELDS} == {k: theirs[k] for k in SERVE_FIELDS}
    DDPGConfig(serve_actors=True, sac=True, serve_backend="jax", front_port=7777,
               front_http_port=7778, front_tenants="gold:0;bronze:2:5")
    argv = ["--serve_actors=true", "--serve_backend=jax", "--serve_max_batch=16",
            "--front_port=7777", "--front_tenants=gold:0", "--front_shed_start=0.25"]
    cfg = DDPGConfig.from_flags(argv)
    assert (cfg.serve_actors, cfg.serve_backend, cfg.serve_max_batch, cfg.front_port,
            cfg.front_tenants, cfg.front_shed_start) == (True, "jax", 16, 7777, "gold:0", 0.25)


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_bad_serve_and_front_values_raise_jaxs_messages(bad):
    with pytest.raises(ValueError) as theirs:
        jax_config.DDPGConfig(**bad)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**bad)
    assert str(ours.value) == str(theirs.value)


def test_serving_on_more_ranks_and_the_tp_apply_raise_citing_item_10():
    """Both are ported (the name is kept from when they raised): serving on
    more ranks is taken as JAX takes it, and mesh= runs the apply over a
    model group, here one of a single rank (no process group), which is
    the whole policy: the numpy oracle's actions to float tolerance."""
    from distributed_ddpg_tpu_torch.parallel.mesh import DataGroup

    for over in (dict(serve_actors=True, data_axis=2), dict(serve_actors=True, model_axis=2)):
        theirs, ours = jax_config.DDPGConfig(**over), DDPGConfig(**over)
        assert (ours.serve_actors, ours.data_axis, ours.model_axis) == \
            (theirs.serve_actors, theirs.data_axis, theirs.model_axis)
    one = DataGroup(rank=0, world_size=1, device=torch.device("cpu"))
    tp = serve.InferenceServer(LAYOUT, 1.0, backend="jax", device="cpu", mesh=one)
    ref = serve.InferenceServer(LAYOUT, 1.0, backend="numpy")
    flat = (0.1 * np.random.default_rng(3).standard_normal(layout_size(LAYOUT))).astype(
        np.float32)
    obs = np.random.default_rng(4).standard_normal((5, LAYOUT[0][0][0])).astype(np.float32)
    tp.refresh(flat)
    ref.refresh(flat)
    np.testing.assert_allclose(tp._compute(obs), ref._compute(obs), rtol=1e-5, atol=1e-6)
    assert tp.shard_bytes == 4 * layout_size(LAYOUT)
    tp.close()


# --- serve_bench and the CLI ------------------------------------------------------------


def test_serve_bench_digest_keys_are_jaxs():
    from distributed_ddpg_tpu.tools.serve_bench import run_serve_bench as jax_bench
    from distributed_ddpg_tpu_torch.tools.serve_bench import main, run_serve_bench

    kw = dict(clients=2, duration_s=0.3, obs_dim=4, act_dim=2, hidden=(8, 8), max_batch=4,
              max_latency_ms=2.0)
    ours = run_serve_bench(backend="jax", device="cpu", **kw)
    assert set(ours) == set(jax_bench(**kw))
    assert ours["serve_requests"] > 0 and ours["served_rps"] > 0 and ours["serve_errors"] == 0
    assert ours["backend"] == "jax"
    assert main(["--clients=1", "--duration_s=0.2", "--obs_dim=3", "--act_dim=1",
                 "--hidden=8,8", "--max_batch=4"]) == 0


def test_served_cli_run_at_tiny_width(tmp_path):
    """The served actors through train() (the device apply on the CPU): the
    budget completes on served actions, the serve_* fields ride the final
    record and the summary from one snapshot, and JAX's healthy-run
    checks hold (tests/test_serve.py:514-559)."""
    from distributed_ddpg_tpu_torch.train import train

    log = tmp_path / "serve.jsonl"
    cfg = DDPGConfig(actor_hidden=(16, 16), critic_hidden=(16, 16), num_actors=2,
                     total_env_steps=1200, replay_min_size=256, replay_capacity=20_000,
                     eval_every=0, eval_episodes=1, max_learn_ratio=1.0, max_ingest_ratio=1.0,
                     learner_chunk=8, batch_size=16, log_path=str(log), serve_actors=True,
                     serve_max_batch=8, serve_max_latency_ms=1.0, serve_backend="jax",
                     device="cpu")
    out = train(cfg, echo=False)
    assert out["learner_steps"] > 0
    assert out["serve_requests"] > 0 and out["serve_batches"] > 0
    assert out["serve_overloads"] == 0 and out["serve_errors"] == 0
    assert out["serve_p95_ms"] > 0.0 and out["transfer_serve_items"] > 0
    final = [json.loads(x) for x in log.read_text().splitlines() if '"final"' in x][-1]
    for key in ("serve_requests", "serve_batches", "serve_fill_mean", "serve_p50_ms",
                "serve_p95_ms", "serve_max_ms", "serve_queue_depth_p95",
                "serve_client_fallbacks", "transfer_serve_items"):
        assert key in final, key
        assert final[key] == out[key], key
    assert final["serve_client_fallbacks"] <= 8


def _worker_fallbacks(run_worker, stop_on_request: bool) -> int:
    """One served worker on Pendulum-v1, in this process, beside a
    stand-in server that takes the first request and never answers it:
    it sets the stop flag at once (`stop_on_request`), or once the
    worker's 0.2 s deadline has passed and its local act has run for a
    while (60 s at most). After a fallback the worker asks no more (its
    serve_fallback_s is an hour). Returns the worker's counted
    fallbacks."""
    import queue

    layout = param_layout(3, 1, (8, 8))
    stop = mp.Value("b", 0, lock=False)
    fallbacks = mp.Array("l", 1, lock=False)
    requests = queue.Queue()

    def server():
        requests.get(timeout=60)
        deadline = time.monotonic() + 60.0
        while not stop_on_request and fallbacks[0] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.0 if stop_on_request else 0.1)
        stop.value = 1

    thread = threading.Thread(target=server, daemon=True)
    thread.start()
    run_worker(0, "Pendulum-v1", 0, layout, np.array([2.0], np.float32),
               np.array([0.0], np.float32), np.array([-2.0], np.float32),
               np.array([2.0], np.float32), mp.Array("f", layout_size(layout), lock=False),
               mp.Value("l", 0, lock=False), queue.Queue(), mp.Array("d", 1, lock=False),
               stop, ou_theta=0.15, ou_sigma=0.2, ou_dt=1e-2, n_step=1, gamma=0.99,
               ring_buf=None, ring_rows=0, serve_request_queue=requests, serve_response_queue=queue.Queue(),
               serve_fallbacks=fallbacks, serve_timeout_s=0.2, serve_fallback_s=3600.0)
    thread.join(timeout=60)
    return fallbacks[0]


@pytest.mark.parametrize("stop_on_request", [False, True], ids=["deadline", "stop"])
def test_a_served_wait_cut_by_the_stop_is_not_a_fallback(stop_on_request):
    """A request past its deadline is one fallback in both workers. A wait
    that the pool's stop cuts short is none in the port's and one in
    JAX's (actors/worker.py:277): the run ending is not the served path
    failing (a deviation, ROADMAP Queue 3)."""
    from distributed_ddpg_tpu.actors.worker import run_worker as jax_run_worker
    from distributed_ddpg_tpu_torch.actors.worker import run_worker

    assert _worker_fallbacks(jax_run_worker, stop_on_request) == 1
    assert _worker_fallbacks(run_worker, stop_on_request) == (0 if stop_on_request else 1)


# --- the repaired device defaults ---------------------------------------------------------


def _default_device_builders():
    from distributed_ddpg_tpu_torch.envs import vector_envs as ve
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay

    return {
        "DeviceReplay": lambda: DeviceReplay(64, 3, 1, block_size=16).storage.device,
        "DevicePrioritizedReplay":
            lambda: DevicePrioritizedReplay(64, 3, 1, block_size=16).priorities.device,
        "VectorPendulum": lambda: ve.VectorPendulum(4).device,
        "VectorMountainCar": lambda: ve.VectorMountainCar(4).device,
        "make_vector_env": lambda: ve.make_vector_env("Pendulum-v1", 4).device,
        "InferenceServer": lambda: serve.InferenceServer(LAYOUT, 1.0, backend="jax").device,
    }


@pytest.mark.parametrize("name", ["DeviceReplay", "DevicePrioritizedReplay", "VectorPendulum",
                                  "VectorMountainCar", "make_vector_env", "InferenceServer"])
def test_device_defaults_are_the_card_and_raise_without_one(name):
    build = _default_device_builders()[name]
    if torch.cuda.is_available():
        assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            build()
