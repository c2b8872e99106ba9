"""The fault plan and its sites, against the JAX package's, on the CPU.

- Every spec form of the JAX `--faults` grammar parses to the same
  FaultPlan in both packages (each spec's fields and its seeded
  duration, under two seeds), the legacy `actor:<id>:<step>` alias
  included; bad specs are refused by both; `pod` and `slice` parse as
  JAX's (their drills: tests/test_torch_multihost.py,
  tests/test_torch_elastic.py).
- `for_worker` gives each worker's incarnations the same fault tuples, and
  a site fires the same specs at the same call ordinals.
- The `--inject_fault` alias and the eight operations fields of the config
  parse and check as the JAX config does.
- The slice as a whole through the CLIs, each run by both trainers with the
  same tiny config in child processes: with --trace_dir --watchdog_s
  --obs_port --tb_dir --actor_throttle_s and worker:0:crash,
  worker:1:stall with --actor_no_progress_s, shipper:ship:crash,
  transfer:dispatch:crash, ckpt:write:ioerror and pool:broadcast:slow in
  one run, whose record kinds, phase and staleness keys and recovery
  counters must match; prefetch:sample:crash on the host replay, which
  ends both runs with the prefetcher's error; devactor:rollout:crash on
  the device actors, absorbed by one restart in both.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from distributed_ddpg_tpu import faults as jax_faults
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu_torch import faults
from distributed_ddpg_tpu_torch.config import DDPGConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One spec of every component, target and kind the port takes, with and
# without an explicit duration, and the legacy alias.
SPECS = [
    "worker:0:crash@5000", "worker:1:crashloop@20", "worker:2:hang@8000",
    "worker:3:stall@300", "worker:0:slow@100", "worker:1:slow@50~0.3",
    "ckpt:write:ioerror@2", "ckpt:write:slow@1", "ckpt:write:hang@3~1.5",
    "ckpt:ioerror@4", "shipper:ship:crash@1", "shipper:ship:slow@7~0.01",
    "prefetch:sample:hang@3", "prefetch:sample:slow@2~0.2", "prefetch:sample:crash@9",
    "pool:broadcast:slow@2", "pool:monitor:slow@4~0.5", "pool:monitor:hang@6",
    "transfer:dispatch:crash@3", "transfer:dispatch:slow@5",
    "devactor:rollout:crash@2", "devactor:rollout:slow@3~0.1", "devactor:rollout:hang@4",
    "numeric:grad:nan@500", "numeric:replay:inf@42", "numeric:loss:spike@9",
    "serve:batcher:stall@3", "serve:batcher:hang@2~1", "serve:batcher:slow@4",
    "serve:dispatch:crash@2", "serve:dispatch:slow@6",
    "front:accept:stall@1", "front:accept:slow@2", "front:accept:hang@3~0.7",
    "slice:1:corrupt@2", "slice:0:kill@3",
    "front:frame:corrupt@4", "front:canary:regress@10", "front:canary:regress@20~0.05",
    "actor:1:300", "actor:0:7",
]

BAD = ["worker:x:crash@5", "worker:0:ioerror@5", "worker:0:crash@0", "worker:0:crash",
       "ckpt:write:stall@2", "ckpt:write:nan@2", "bogus:x:crash@1", "ckpt:write:crash@x",
       "ckpt:write:slow@2~-1", "ckpt:write:slow@2~x", "actor:x:5", "a:b:c:d",
       "numeric:grad:inf@3", "serve:batcher:crash@1", "front:frame:slow@1"]


def _plan_tuples(plan):
    return [dataclasses.astuple(s) for s in plan.specs]


@pytest.mark.parametrize("seed", [0, 7])
def test_every_spec_parses_as_jax(seed):
    text = ";".join(SPECS)
    ours = faults.FaultPlan.parse(text, seed=seed)
    theirs = jax_faults.FaultPlan.parse(text, seed=seed)
    assert _plan_tuples(ours) == _plan_tuples(theirs)
    assert [s.describe() for s in ours.specs] == [s.describe() for s in theirs.specs]
    assert repr(ours) == repr(theirs)
    # One spec at a time: its seeded duration depends on its index only
    # through the plan string, as in JAX.
    for spec in SPECS:
        assert _plan_tuples(faults.FaultPlan.parse(spec, seed)) == \
            _plan_tuples(jax_faults.FaultPlan.parse(spec, seed))
    assert ours.numeric_steps() == theirs.numeric_steps()
    assert ours.numeric_replay_rows() == theirs.numeric_replay_rows()
    assert ours.front_canary_regressions() == theirs.front_canary_regressions()


def test_legacy_alias_is_a_worker_crash():
    plan = faults.FaultPlan.parse("actor:1:300")
    assert _plan_tuples(plan) == [("worker", "1", "crash", 300, 0.0, 0)]
    assert _plan_tuples(plan) == _plan_tuples(jax_faults.FaultPlan.parse("actor:1:300"))


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_are_refused_by_both(spec):
    with pytest.raises(ValueError):
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(spec)


@pytest.mark.parametrize("spec", ["pod:0:kill@3", "pod:2:slow@1~0.5", "slice:1:kill@2"])
def test_pod_and_slice_raise_citing_item_10(spec):
    """`pod` and `slice` parse as the JAX package's: the pod layer and the
    sharded replay's slices are ported (the name is kept from when
    `slice` still raised, citing ROADMAP item 10)."""
    theirs = jax_faults.FaultPlan.parse(spec)
    assert _plan_tuples(faults.FaultPlan.parse(spec)) == _plan_tuples(theirs)


def test_for_worker_incarnations_match_jax():
    text = ";".join(SPECS)
    ours = faults.FaultPlan.parse(text, seed=3)
    theirs = jax_faults.FaultPlan.parse(text, seed=3)
    for wid in range(5):
        for inc in range(3):
            assert ours.for_worker(wid, inc) == theirs.for_worker(wid, inc)
    # The respawn keeps only the crashloop, re-armed as a crash.
    assert ours.for_worker(1, 1) == [("crash", 20, 0.0)]


def test_site_ordinals_match_jax():
    text = ("ckpt:write:ioerror@2;ckpt:write:slow@3~0;ckpt:write:ioerror@5;"
            "shipper:ship:crash@1;transfer:dispatch:slow@2~0")
    results = []
    for mod in (faults, jax_faults):
        plan = mod.FaultPlan.parse(text, seed=1)
        sites = [plan.site("ckpt", "write"), plan.site("shipper", "ship"),
                 plan.site("transfer", "dispatch"), plan.site("prefetch", "sample")]
        trail = []
        for site in sites:
            for _ in range(6):
                try:
                    site.tick()
                    trail.append("ok")
                except mod.InjectedFault as e:
                    trail.append(str(e))
            trail.append((site.calls, bool(site), list(site.fired)))
        results.append(trail)
    assert results[0] == results[1]
    assert not faults.NULL_SITE and faults.NULL_SITE.calls == 0


def test_inject_fault_alias_folds_into_faults():
    argv = ["--faults=ckpt:write:ioerror@2", "--inject_fault=actor:1:300"]
    ours, theirs = DDPGConfig.from_flags(argv), JaxConfig.from_flags(argv)
    assert ours.faults == theirs.faults == "ckpt:write:ioerror@2;actor:1:300"
    assert _plan_tuples(ours.fault_plan()) == _plan_tuples(theirs.fault_plan())
    assert DDPGConfig.from_flags(["--inject_fault=actor:0:5"]).faults == "actor:0:5"


OPS_FIELDS = ("actor_throttle_s", "watchdog_s", "tb_dir", "profile_dir", "trace_dir",
              "trace_events", "obs_port", "actor_no_progress_s")


def test_operations_fields_have_jax_defaults():
    ours, theirs = DDPGConfig(), JaxConfig()
    for name in OPS_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    argv = ["--trace_dir=/t", "--watchdog_s=20", "--obs_port=9100", "--tb_dir=/b",
            "--profile_dir=/p", "--trace_events=4096", "--actor_throttle_s=0.01",
            "--actor_no_progress_s=3"]
    ours, theirs = DDPGConfig.from_flags(argv), JaxConfig.from_flags(argv)
    for name in OPS_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("override", [
    dict(actor_throttle_s=-0.1), dict(actor_no_progress_s=-1.0), dict(trace_events=8),
    dict(obs_port=70000), dict(obs_port=-1),
])
def test_operations_checks_match_jax(override):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**override)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**override)
    assert str(ours.value) == str(theirs.value)


# --- the CLI drills ------------------------------------------------------------

TINY = ["--actor_hidden=16,16", "--critic_hidden=16,16", "--batch_size=16",
        "--learner_chunk=4", "--replay_min_size=200", "--eval_every=0", "--eval_episodes=1"]


def run_cli(package: str, flags, log_path, timeout=240):
    """`python -m <package>.train <flags>` in a child process (the port's on
    the CPU); returns (returncode, records, stderr)."""
    cmd = [sys.executable, "-m", f"{package}.train", *flags, f"--log_path={log_path}"]
    if package == "distributed_ddpg_tpu_torch":
        cmd.insert(3, "--device=cpu")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    records = ([json.loads(line) for line in log_path.read_text().splitlines()]
               if log_path.exists() else [])
    return res.returncode, records, res.stderr


def run_both(flags, tmp_path, tag):
    return {pkg: run_cli(pkg, flags, tmp_path / f"{tag}_{pkg}.jsonl")
            for pkg in ("distributed_ddpg_tpu_torch", "distributed_ddpg_tpu")}


DRILL = ("worker:0:crash@150;worker:1:stall@150;shipper:ship:crash@2;"
         "transfer:dispatch:crash@2;ckpt:write:ioerror@1;pool:broadcast:slow@2~0.05")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# The t_*, n_* and staleness_* keys of the records that may differ between
# the two trainers, each with its reason. Every other one must match.
ALLOWED_KEY_DIFFERENCES = {
    # The port's whole-run figures of the driver's ingest while chunks ran
    # (train.py), in its final record only; the JAX trainer has no such
    # measurement. Its own t_ingest_ms / t_ingest_max / n_ingest are the
    # ingest phase's, as JAX's are.
    "t_ingest_chunk_ms": "port-only whole-run figure",
    "t_ingest_run_ms": "port-only whole-run figure",
    "t_ingest_run_max": "port-only whole-run figure",
    "n_ingest_run": "port-only whole-run figure",
}


def _phase_keys(records):
    """The t_*, n_* and staleness_* keys over the train and final records
    (which phases an interval holds depends on when its record fell)."""
    keys = set()
    for r in records:
        if r["kind"] in ("train", "final"):
            keys |= {k for k in r if k.startswith(("t_", "n_", "staleness_"))}
    return keys


def test_cli_operations_and_fault_drill_match_jax(tmp_path):
    """Both CLIs, the same tiny config with the operations flags and the
    drill's faults: the same record kinds, the same phase and staleness
    keys, the same recovery counters, and each its trace, actor traces,
    TensorBoard events and exporter."""
    runs = {}
    for pkg in ("distributed_ddpg_tpu_torch", "distributed_ddpg_tpu"):
        out = tmp_path / pkg
        flags = TINY + ["--num_actors=2", "--total_env_steps=2400",
                        "--actor_no_progress_s=1", "--actor_throttle_s=0.002",
                        "--checkpoint_every=40", f"--checkpoint_dir={out / 'ck'}",
                        f"--trace_dir={out / 'trace'}", "--watchdog_s=20",
                        f"--obs_port={free_port()}", f"--tb_dir={out / 'tb'}",
                        f"--faults={DRILL}"]
        runs[pkg] = run_cli(pkg, flags, tmp_path / f"drill_{pkg}.jsonl")
    finals, kinds = {}, {}
    for pkg, (rc, records, err) in runs.items():
        assert rc == 0, (pkg, err[-3000:])
        assert records[-1]["kind"] == "final", pkg
        finals[pkg] = records[-1]
        kinds[pkg] = {r["kind"] for r in records}
        # Worker 0 crashed; the pool respawned it and worker 1.
        assert "InjectedFault: injected crash in worker 0" in err, pkg
        assert "[obs] telemetry ingress on :" in err, pkg
        out = tmp_path / pkg
        assert {"trace.json", "trace_actor0.json", "trace_actor1.json"} <= \
            set(os.listdir(out / "trace")), pkg
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(out / "tb")), pkg
    port_recs = runs["distributed_ddpg_tpu_torch"][1]
    jax_recs = runs["distributed_ddpg_tpu"][1]
    assert kinds["distributed_ddpg_tpu_torch"] == kinds["distributed_ddpg_tpu"] == \
        {"header", "train", "final"}
    ours, theirs = _phase_keys(port_recs), _phase_keys(jax_recs)
    assert ours ^ theirs <= set(ALLOWED_KEY_DIFFERENCES), ours ^ theirs
    train = {k for r in port_recs if r["kind"] == "train" for k in r}
    assert {"staleness_mean", "staleness_max", "t_dispatch_ms", "n_dispatch",
            "t_dispatch_p95", "t_ingest_ms", "t_sync_max", "t_refresh_ms",
            "t_ckpt_ms"} <= train
    ours, theirs = finals["distributed_ddpg_tpu_torch"], finals["distributed_ddpg_tpu"]
    assert "failed (dead)" in runs["distributed_ddpg_tpu_torch"][2]
    assert "failed (no_rows)" in runs["distributed_ddpg_tpu_torch"][2]
    # The recovery counters, the same in both trainers.
    for key in ("actor_respawns", "actor_quarantined", "ckpt_write_retries",
                "ingest_shipper_restarts", "transfer_restarts", "emergency_ckpt"):
        assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    assert ours["actor_respawns"] == 2 and ours["ckpt_write_retries"] == 1
    assert ours["ingest_shipper_restarts"] == 1 and ours["transfer_restarts"] == 1


def test_cli_prefetch_crash_ends_both_runs(tmp_path):
    flags = TINY + ["--num_actors=1", "--total_env_steps=1200", "--host_replay=true",
                    "--faults=prefetch:sample:crash@1"]
    for pkg, (rc, records, err) in run_both(flags, tmp_path, "prefetch").items():
        # No restart for the prefetcher in either: its death surfaces at
        # the driver's next() as PrefetchError.
        assert rc != 0, pkg
        assert "PrefetchError" in err and "prefetch:sample:crash@1" in err, (pkg, err[-2000:])


def test_cli_devactor_crash_is_absorbed_as_in_jax(tmp_path):
    flags = TINY + ["--num_actors=0", "--actor_backend=device", "--device_actor_envs=8",
                    "--device_actor_chunk=8", "--total_env_steps=640",
                    "--faults=devactor:rollout:crash@2"]
    finals = {}
    for pkg, (rc, records, err) in run_both(flags, tmp_path, "devactor").items():
        assert rc == 0, (pkg, err[-3000:])
        finals[pkg] = records[-1]
    ours, theirs = finals["distributed_ddpg_tpu_torch"], finals["distributed_ddpg_tpu"]
    assert ours["devactor_restarts"] == theirs["devactor_restarts"] == 1
    assert ours["devactor_env_steps"] == theirs["devactor_env_steps"]
