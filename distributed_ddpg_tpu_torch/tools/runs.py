"""Run-analysis CLI for the repo's JSONL/JSON artifacts: a stdlib copy of
distributed_ddpg_tpu/tools/runs.py for the port. Its output is byte for
byte the JAX tool's on the same inputs: the port writes the same metrics
JSONL schema (metrics.MetricsLogger), the same flight-recorder traces
(trace.py; `otherData.wall_t0`, offsets from
parallel/multihost.clock_handshake) and reads the same bench.py JSON, and
`lint` renders either lint engine's findings JSON.

`runs/` holds ~100 train/eval/bench files and until this module the only
tooling was hand-diffing them (how the 8-device ingest regression in
BENCH_r05 was found). Four subcommands over the schemas the repo already
produces (metrics.MetricsLogger records; bench.py result JSON — both
documented in docs/OBSERVABILITY.md):

  summarize <run.jsonl> [...]    per-run digest: record counts, steady-
                                 state rates, per-phase breakdown table
                                 (mean + p50/p95/max where recorded),
                                 ingest pipeline table, eval curve.
  compare  <a.jsonl> <b.jsonl>   side-by-side key metrics with % deltas —
                                 the A/B view for "did this PR move
                                 dispatch p95".
  gate <base.json> <cand.json>   CI regression gate over two bench.py
                                 JSONs: exit 2 when any gated key of the
                                 candidate falls more than --threshold
                                 below the baseline (or above, for
                                 lower-is-better keys prefixed '-').
  lint [findings.json]           pretty-print the invariant lint engine's
                                 findings JSON (scripts/lint_gate.sh
                                 artifact; docs/ANALYSIS.md) as the same
                                 digest tables; exit 2 on unsuppressed
                                 findings — the bench gate's contract.
  merge-trace <t0.json> ...      fuse N per-host flight-recorder traces
                                 into ONE Perfetto timeline (process
                                 track per host, clocks aligned by the
                                 startup handshake offsets —
                                 docs/OBSERVABILITY.md §4).

Pure stdlib, no numpy, torch or jax: this must be runnable anywhere,
instantly —
    python -m distributed_ddpg_tpu_torch.tools.runs summarize runs/foo.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import mean
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a metrics JSONL file; non-JSON lines (stray prints interleave
    with echo=True streams) are skipped, not fatal."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def load_bench(path: str) -> Dict[str, Any]:
    """A bench.py result: one JSON object. Driver wrappers (BENCH_r*.json)
    embed the object in a 'tail' string; unwrap when present so both
    shapes gate/compare identically."""
    with open(path) as f:
        obj = json.load(f)
    if "value" not in obj and isinstance(obj.get("tail"), str):
        tail = obj["tail"]
        start = tail.find('{"metric"')
        if start >= 0:
            try:
                obj = json.loads(tail[start:])
            except json.JSONDecodeError:
                pass
    return obj


def by_kind(records: Sequence[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        out.setdefault(str(r.get("kind", "?")), []).append(r)
    return out


def phase_names(records: Sequence[Dict[str, Any]]) -> List[str]:
    names = set()
    for r in records:
        for k in r:
            if k.startswith("t_") and k.endswith("_ms"):
                names.add(k[2:-3])
    return sorted(names)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:,.3f}" if abs(v) < 1000 else f"{v:,.1f}"
    return str(v)


def render_table(headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> str:
    cells = [[_fmt(c) for c in row] for row in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
        for i, h in enumerate(headers)
    ]
    def line(row):
        return "  ".join(
            c.rjust(w) if i else c.ljust(w)
            for i, (c, w) in enumerate(zip(row, widths))
        )
    out = [line(list(headers)), line(["-" * w for w in widths])]
    out += [line(r) for r in cells]
    return "\n".join(out)


def _col(records, key) -> List[float]:
    return [
        r[key] for r in records
        if isinstance(r.get(key), (int, float))
        and not isinstance(r.get(key), bool)
    ]


def _tail_mean(vals: Sequence[float], frac: float = 0.25) -> Optional[float]:
    """Mean of the last `frac` of the series — the steady-state estimate
    (early records carry warmup/compile transients)."""
    if not vals:
        return None
    n = max(1, int(len(vals) * frac))
    return mean(vals[-n:])


# ---------------------------------------------------------------------------
# summarize
# ---------------------------------------------------------------------------

# The headline scalar columns a run summary/compare surfaces, in order.
KEY_METRICS = (
    "learner_steps_per_sec",
    "actor_steps_per_sec",
    "env_steps_per_sec",
    "buffer_fill",
    "staleness_mean",
    "critic_loss",
    "mean_q",
)

# Cumulative recovery counters (train.py recovery_fields; docs/RESILIENCE.md)
# — the run's fault history. `last` is the total; a nonzero anywhere means
# the run survived at least one injected or real failure.
RECOVERY_KEYS = (
    "actor_respawns",
    "actor_quarantined",
    "actor_unquarantined",
    "ckpt_write_retries",
    "emergency_ckpt",
    "ingest_shipper_restarts",
    "transfer_restarts",
)

# Pod-resilience counters (metrics.PodStats; docs/RESILIENCE.md pod rows)
# — present only on multi-process runs. Cumulative/gauge semantics, so the
# digest reports the LAST value; slack is the tune-the-deadline telemetry
# (trending toward 0 = pod_collective_timeout_s too tight).
POD_KEYS = (
    "pod_peer_lost",
    "pod_aborts",
    "pod_resume_step_elected",
    "pod_beats",
    "pod_collective_near_misses",
    "pod_collective_slack_p95_ms",
    # Elastic-pod events (docs/RESILIENCE.md shrink/grow state machine):
    # slice adoptions, membership transitions, and the typed degraded
    # state — also present on single-process runs that adopted a larger
    # world's slice set (the shrink-to-one case).
    "pod_slices_adopted",
    "pod_slice_adopted_step",
    "pod_shrinks",
    "pod_grows",
    "pod_state_degraded",
    # Straggler attribution (obs/aggregate.py; docs/OBSERVABILITY.md §4):
    # cumulative detections plus the last flagged host index (-1 = none).
    "pod_stragglers",
    "pod_straggler_host",
)

# Numerical-health counters (metrics.GuardrailStats; docs/RESILIENCE.md
# 'Numerical health') — present only when guardrails are armed. Cumulative,
# so the digest reports the LAST value; a nonzero rollback count means the
# run repaired itself at least once mid-flight.
GUARDRAIL_KEYS = (
    "guardrail_anomalies",
    "guardrail_nonfinite_steps",
    "guardrail_loss_spikes",
    "guardrail_skipped_updates",
    "guardrail_bad_rows",
    "guardrail_rollbacks",
    "guardrail_last_rollback_step",
    "guardrail_lr_cooldowns",
    "guardrail_source_quarantines",
)


def _drop_probe_failures(
    records: List[Dict[str, Any]], path: str
) -> List[Dict[str, Any]]:
    """Drop records carrying a TPU-probe failure tail (`probe_error` /
    `tpu_error` — the BENCH_r04/r05 shape: the harness recorded a CPU
    fallback after the TPU probe died). Their rates are fallback numbers,
    not the run's, and silently averaging them in would poison every A/B
    against a healthy baseline (BENCH_r03). Warns once per file so the
    exclusion is visible, never manual."""
    kept = [
        r for r in records
        if not (r.get("probe_error") or r.get("tpu_error"))
    ]
    dropped = len(records) - len(kept)
    if dropped:
        print(
            f"warning: {path}: skipped {dropped} record(s) with a "
            "TPU-probe failure tail (probe_error/tpu_error)",
            file=sys.stderr,
        )
    return kept


def summarize_run(path: str) -> Dict[str, Any]:
    """Machine-readable digest of one JSONL run (the CLI renders it; tests
    and future dashboards consume it directly)."""
    records = _drop_probe_failures(load_jsonl(path), path)
    kinds = by_kind(records)
    train = kinds.get("train", [])
    evals = kinds.get("eval", [])
    final = kinds.get("final", [])
    digest: Dict[str, Any] = {
        "path": path,
        "records": {k: len(v) for k, v in kinds.items()},
        "steps": (
            {"first": train[0].get("step"), "last": train[-1].get("step")}
            if train
            else {}
        ),
        "wall_time_s": records[-1].get("wall_time") if records else None,
    }
    metrics = {}
    for key in KEY_METRICS:
        vals = _col(train, key)
        if vals:
            metrics[key] = {
                "steady": _tail_mean(vals),
                "max": max(vals),
                "last": vals[-1],
            }
    digest["metrics"] = metrics

    phases = {}
    for name in phase_names(train + final):
        src = train if _col(train, f"t_{name}_ms") else final
        entry = {
            "mean_ms": _tail_mean(_col(src, f"t_{name}_ms")),
            "calls": sum(int(v) for v in _col(src, f"n_{name}")),
        }
        for q in ("p50", "p95", "max"):
            vals = _col(src, f"t_{name}_{q}")
            if vals:
                # max over intervals: the worst tail any interval saw.
                entry[f"{q}_ms"] = max(vals)
        phases[name] = entry
    digest["phases"] = phases

    ingest = {}
    ingest_keys = sorted(
        {k for r in train for k in r if k.startswith("ingest_")}
    )
    for key in ingest_keys:
        vals = _col(train, key)
        if vals:
            ingest[key] = {"steady": _tail_mean(vals), "max": max(vals)}
    digest["ingest"] = ingest

    # Transfer-scheduler digest (docs/TRANSFER.md): per-class dispatch
    # counters/tails, queue depths, and the adaptive-coalesce trajectory
    # (cap gauge + cumulative grows/shrinks).
    transfer = {}
    transfer_keys = sorted(
        {
            k for r in train for k in r
            if k.startswith("transfer_") and k not in RECOVERY_KEYS
        }
    )
    for key in transfer_keys:
        vals = _col(train, key)
        if vals:
            transfer[key] = {"steady": _tail_mean(vals), "max": max(vals)}
    digest["transfer"] = transfer

    # Pod digest (multi-process runs only): last value of each pod_*
    # counter/gauge across train+final records, plus whatever aggregation
    # keys the rank-0 `kind:"pod"` records carry (obs/aggregate.py emits
    # per-host min/max/spread families; the key set is family-templated,
    # so it is discovered, not enumerated).
    pod = {}
    pod_records = kinds.get("pod", [])
    pod_key_set = set(POD_KEYS) | {
        k for r in pod_records for k in r if k.startswith("pod_")
    }
    for key in sorted(pod_key_set):
        vals = _col(train + pod_records + kinds.get("final", []), key)
        if vals:
            pod[key] = {"last": vals[-1], "max": max(vals)}
    digest["pod"] = pod

    # Numerical-health digest (guardrail-armed runs only): last value of
    # each cumulative guardrail_* counter across train+final records.
    guardrail = {}
    for key in GUARDRAIL_KEYS:
        vals = _col(train + final, key)
        if vals:
            guardrail[key] = {"last": vals[-1], "max": max(vals)}
    digest["guardrail"] = guardrail

    # Serving digest (serve/; docs/SERVING.md): request/batch counters are
    # cumulative (report the last = total), latency/fill/depth tails are
    # interval-scoped (steady + worst interval).
    serve = {}
    serve_keys = sorted(
        {k for r in train + final for k in r if k.startswith("serve_")}
    )
    for key in serve_keys:
        vals = _col(train + final, key)
        if vals:
            serve[key] = {
                "steady": _tail_mean(vals), "max": max(vals),
                "last": vals[-1],
            }
    digest["serve"] = serve

    # Network-front digest (serve/front/; docs/SERVING.md 'Network
    # front'): counters are cumulative (last = total), the wire-latency
    # tails are interval-scoped (steady + worst interval). tenant_*
    # rides in the same section — the QoS view of the same traffic.
    front = {}
    front_keys = sorted(
        {
            k for r in train + final for k in r
            if k.startswith("front_") or k.startswith("tenant_")
        }
    )
    for key in front_keys:
        vals = _col(train + final, key)
        if vals:
            front[key] = {
                "steady": _tail_mean(vals), "max": max(vals),
                "last": vals[-1],
            }
    digest["front"] = front

    # Device-actor digest (actors/device_pool.py; docs/DEVICE_ACTORS.md):
    # rows/s and the per-chunk dispatch tails are interval-scoped
    # (steady + worst interval); env_steps/episodes/restarts are
    # cumulative (the last value is the total).
    devactor = {}
    devactor_keys = sorted(
        {k for r in train + final for k in r if k.startswith("devactor_")}
    )
    for key in devactor_keys:
        vals = _col(train + final, key)
        if vals:
            devactor[key] = {
                "steady": _tail_mean(vals), "max": max(vals),
                "last": vals[-1],
            }
    digest["devactor"] = devactor

    # Fused-megastep digest (parallel/megastep.py FusedBeatStats;
    # docs/FUSED_BEAT.md): beats, grad-steps/s, rows/s, and the per-beat
    # dispatch tails — all interval-scoped (steady + worst interval).
    fused = {}
    fused_keys = sorted(
        {k for r in train + final for k in r if k.startswith("fused_")}
    )
    for key in fused_keys:
        vals = _col(train + final, key)
        if vals:
            fused[key] = {
                "steady": _tail_mean(vals), "max": max(vals),
                "last": vals[-1],
            }
    digest["fused"] = fused

    # Mesh/TP-placement digest (metrics.MeshStats; docs/MESH.md): the
    # mesh shape and the per-device TrainState bytes are gauges — the
    # last value IS the placement fact.
    mesh = {}
    mesh_keys = sorted(
        {k for r in train + final for k in r if k.startswith("mesh_")}
    )
    for key in mesh_keys:
        vals = _col(train + final, key)
        if vals:
            mesh[key] = {"last": vals[-1]}
    digest["mesh"] = mesh

    # Replay-placement digest (replay/device.py ReplayShardStats;
    # docs/REPLAY_SHARDING.md): measured ingest bytes/row, per-device
    # storage bytes, per-shard fill, exchange-dispatch tails.
    replay_shard = {}
    replay_keys = sorted(
        {
            k
            for r in train + final
            for k in r
            if k.startswith(("replay_shard_", "replay_ingest_bytes",
                             "replay_exchange_", "replay_device_storage"))
        }
    )
    for key in replay_keys:
        vals = _col(train + final, key)
        if vals:
            replay_shard[key] = {
                "steady": _tail_mean(vals), "max": max(vals),
                "last": vals[-1],
            }
    digest["replay_sharding"] = replay_shard

    recovery = {}
    for key in RECOVERY_KEYS:
        vals = _col(train + final, key)
        if vals:
            recovery[key] = {"last": vals[-1], "max": max(vals)}
    digest["recovery"] = recovery

    # Supervision digest (supervisor/events.py; docs/OPERATIONS.md
    # supervisor runbook): the event timeline verbatim, plus the
    # cumulative supervisor_* counters off the last record that carries
    # them (the supervisor's `final` event).
    sup_records = kinds.get("supervisor", [])
    if sup_records:
        counters: Dict[str, Any] = {}
        for r in sup_records:
            for k, v in r.items():
                if k.startswith("supervisor_"):
                    counters[k] = v
        digest["supervisor"] = {
            "events": [
                {
                    k: r[k]
                    for k in (
                        "wall_time", "event", "gen", "proc", "code",
                        "code_name", "members", "target", "slots",
                        "backoff_s", "consecutive", "failures",
                        "reason", "transition", "state", "slot",
                    )
                    if k in r
                }
                for r in sup_records
            ],
            "counters": counters,
        }

    ev = _col(evals, "eval_return")
    if ev:
        digest["eval"] = {
            "n": len(ev), "first": ev[0], "best": max(ev), "last": ev[-1],
        }
    if final:
        digest["final"] = {
            k: v for k, v in final[-1].items()
            if k in ("learner_steps", "learner_steps_per_sec",
                     "final_return", "param_checksum")
        }
    return digest


def render_summary(digest: Dict[str, Any]) -> str:
    out = [f"== {digest['path']}"]
    rec = ", ".join(f"{k}:{v}" for k, v in sorted(digest["records"].items()))
    steps = digest.get("steps") or {}
    out.append(
        f"records [{rec}]  steps {steps.get('first', '-')}"
        f"..{steps.get('last', '-')}  wall {_fmt(digest.get('wall_time_s'))}s"
    )
    if digest.get("metrics"):
        out.append("\n-- key metrics (steady = mean of last 25% of records)")
        out.append(render_table(
            ["metric", "steady", "max", "last"],
            [
                [k, m["steady"], m["max"], m["last"]]
                for k, m in digest["metrics"].items()
            ],
        ))
    if digest.get("phases"):
        out.append("\n-- phase breakdown (ms per call)")
        out.append(render_table(
            ["phase", "mean", "p50", "p95", "max", "calls"],
            [
                [name, p.get("mean_ms"), p.get("p50_ms"), p.get("p95_ms"),
                 p.get("max_ms"), p.get("calls")]
                for name, p in digest["phases"].items()
            ],
        ))
    if digest.get("ingest"):
        out.append("\n-- ingest pipeline")
        out.append(render_table(
            ["field", "steady", "max"],
            [
                [k, v["steady"], v["max"]]
                for k, v in digest["ingest"].items()
            ],
        ))
    if digest.get("transfer"):
        out.append("\n-- transfer scheduler (docs/TRANSFER.md)")
        out.append(render_table(
            ["field", "steady", "max"],
            [
                [k, v["steady"], v["max"]]
                for k, v in digest["transfer"].items()
            ],
        ))
    if digest.get("serve"):
        out.append("\n-- inference serving (docs/SERVING.md)")
        out.append(render_table(
            ["field", "steady", "max", "last"],
            [
                [k, v["steady"], v["max"], v["last"]]
                for k, v in digest["serve"].items()
            ],
        ))
    if digest.get("front"):
        out.append("\n-- network front (docs/SERVING.md 'Network front')")
        out.append(render_table(
            ["field", "steady", "max", "last"],
            [
                [k, v["steady"], v["max"], v["last"]]
                for k, v in digest["front"].items()
            ],
        ))
    if digest.get("devactor"):
        out.append("\n-- device actors (docs/DEVICE_ACTORS.md)")
        out.append(render_table(
            ["field", "steady", "max", "last"],
            [
                [k, v["steady"], v["max"], v["last"]]
                for k, v in digest["devactor"].items()
            ],
        ))
    if digest.get("fused"):
        out.append("\n-- fused megastep (docs/FUSED_BEAT.md)")
        out.append(render_table(
            ["field", "steady", "max", "last"],
            [
                [k, v["steady"], v["max"], v["last"]]
                for k, v in digest["fused"].items()
            ],
        ))
    if digest.get("mesh"):
        out.append("\n-- mesh / tensor parallelism (docs/MESH.md)")
        out.append(render_table(
            ["field", "value"],
            [[k, v["last"]] for k, v in digest["mesh"].items()],
        ))
    if digest.get("replay_sharding"):
        out.append("\n-- replay placement (docs/REPLAY_SHARDING.md)")
        out.append(render_table(
            ["field", "steady", "max", "last"],
            [
                [k, v["steady"], v["max"], v["last"]]
                for k, v in digest["replay_sharding"].items()
            ],
        ))
    if digest.get("pod"):
        pod = digest["pod"]
        out.append("\n-- pod resilience (docs/RESILIENCE.md pod rows)")
        out.append(render_table(
            ["field", "last"],
            [[k, v["last"]] for k, v in pod.items()],
        ))
        # Elastic transitions get a one-line verdict above the raw
        # counters: shrink/grow restarts are the record that matters on
        # a membership-change run (docs/RESILIENCE.md state machine).
        def _last(k):
            return pod.get(k, {}).get("last", 0) or 0

        if _last("pod_shrinks") or _last("pod_grows") or _last(
            "pod_slices_adopted"
        ):
            state = "DEGRADED" if _last("pod_state_degraded") else "healthy"
            out.append(
                f"   elastic: {int(_last('pod_slices_adopted'))} slice "
                f"adoption(s) (step {int(_last('pod_slice_adopted_step'))}), "
                f"{int(_last('pod_shrinks'))} shrink(s), "
                f"{int(_last('pod_grows'))} grow(s) -> {state}"
            )
    if digest.get("guardrail"):
        g = digest["guardrail"]
        out.append("\n-- numerical health (docs/RESILIENCE.md; guardrails)")
        out.append(render_table(
            ["field", "last"],
            [[k, v["last"]] for k, v in g.items()],
        ))
    if digest.get("supervisor"):
        sup = digest["supervisor"]
        out.append(
            "\n-- supervision timeline (supervisor/; docs/OPERATIONS.md "
            "runbook)"
        )
        rows = []
        for e in sup["events"]:
            detail_bits = []
            for key in ("code", "code_name", "members", "target", "slots",
                        "slot", "transition", "state", "backoff_s",
                        "consecutive", "failures", "reason"):
                if key in e:
                    detail_bits.append(f"{key}={e[key]}")
            rows.append([
                _fmt(e.get("wall_time")),
                e.get("event", "?"),
                e.get("gen", ""),
                e.get("proc", ""),
                " ".join(detail_bits),
            ])
        out.append(render_table(["t(s)", "event", "gen", "proc", "detail"],
                                rows))
        if sup["counters"]:
            out.append(render_table(
                ["counter", "total"],
                [[k, v] for k, v in sorted(sup["counters"].items())],
            ))
    if digest.get("recovery"):
        rec = digest["recovery"]
        if any(v["max"] for v in rec.values()):
            out.append("\n-- recovery / fault history (cumulative)")
            out.append(render_table(
                ["counter", "total"],
                [[k, v["last"]] for k, v in rec.items()],
            ))
        else:
            out.append("\n-- recovery: clean run (all counters zero)")
    if digest.get("eval"):
        e = digest["eval"]
        out.append(
            f"\n-- eval: n={e['n']} first={_fmt(e['first'])} "
            f"best={_fmt(e['best'])} last={_fmt(e['last'])}"
        )
    if digest.get("final"):
        out.append(
            "-- final: "
            + "  ".join(f"{k}={_fmt(v)}" for k, v in digest["final"].items())
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------


def compare_runs(path_a: str, path_b: str) -> Tuple[str, List[List[Any]]]:
    a, b = summarize_run(path_a), summarize_run(path_b)
    rows: List[List[Any]] = []

    def add(label, va, vb, lower_better=False):
        if va is None and vb is None:
            return
        delta = None
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) and va:
            delta = 100.0 * (vb - va) / abs(va)
        mark = ""
        if delta is not None and abs(delta) >= 5.0:
            worse = delta < 0 if not lower_better else delta > 0
            mark = "!" if worse else "+"
        rows.append([label, va, vb,
                     f"{delta:+.1f}% {mark}" if delta is not None else "-"])

    for key, ma in a.get("metrics", {}).items():
        mb = b.get("metrics", {}).get(key, {})
        add(key, ma.get("steady"), mb.get("steady"))
    names = sorted(set(a.get("phases", {})) | set(b.get("phases", {})))
    for name in names:
        pa = a["phases"].get(name, {})
        pb = b["phases"].get(name, {})
        add(f"t_{name}_ms", pa.get("mean_ms"), pb.get("mean_ms"),
            lower_better=True)
        if pa.get("p95_ms") is not None or pb.get("p95_ms") is not None:
            add(f"t_{name}_p95", pa.get("p95_ms"), pb.get("p95_ms"),
                lower_better=True)
    for key in sorted(set(a.get("ingest", {})) | set(b.get("ingest", {}))):
        ia = a["ingest"].get(key, {})
        ib = b["ingest"].get(key, {})
        add(key, ia.get("steady"), ib.get("steady"),
            lower_better=("stall" in key or "queue" in key or "_ms" in key))
    for key in sorted(
        set(a.get("transfer", {})) | set(b.get("transfer", {}))
    ):
        ta = a.get("transfer", {}).get(key, {})
        tb = b.get("transfer", {}).get(key, {})
        add(key, ta.get("steady"), tb.get("steady"),
            lower_better=(
                "queue" in key or "_ms" in key or "p95" in key
                or "fence" in key
            ))
    for key in sorted(set(a.get("serve", {})) | set(b.get("serve", {}))):
        sa = a.get("serve", {}).get(key, {})
        sb = b.get("serve", {}).get(key, {})
        # Batch fill is a fraction where HIGHER is better (fuller
        # batches), so it is exempt from the latency/backlog heuristics
        # even though serve_fill_p95 matches the 'p95' substring.
        add(key, sa.get("steady"), sb.get("steady"),
            lower_better=(
                "fill" not in key
                and (
                    "_ms" in key or "p95" in key or "overload" in key
                    or "error" in key or "fallback" in key or "depth" in key
                )
            ))
    for key in sorted(set(a.get("front", {})) | set(b.get("front", {}))):
        fa_ = a.get("front", {}).get(key, {})
        fb_ = b.get("front", {}).get(key, {})
        # front_* / tenant_*: request totals and tenant_served are
        # throughput (higher-is-better); wire-latency tails, sheds,
        # overloads, timeouts, bad frames, errors, and rollbacks are all
        # lower-is-better costs. front_promotes is a lifecycle fact —
        # neither direction is a regression — but a delta is still worth
        # seeing, so it rides the default higher-is-better arm.
        add(key, fa_.get("steady"), fb_.get("steady"),
            lower_better=(
                "_ms" in key or "p95" in key or "p50" in key
                or "shed" in key or "overload" in key or "timeout" in key
                or "bad_frame" in key or "error" in key
                or "rollback" in key
            ))
    for key in sorted(
        set(a.get("devactor", {})) | set(b.get("devactor", {}))
    ):
        da = a.get("devactor", {}).get(key, {})
        db = b.get("devactor", {}).get(key, {})
        # Throughput/episode-return are higher-is-better; dispatch-latency
        # tails (mean/p50/p95/max) and the restart counter are
        # lower-is-better.
        add(key, da.get("steady"), db.get("steady"),
            lower_better=("_ms" in key or "p95" in key or "p50" in key
                          or key.endswith("_max") or "restart" in key))
    for key in sorted(set(a.get("fused", {})) | set(b.get("fused", {}))):
        fa = a.get("fused", {}).get(key, {})
        fb = b.get("fused", {}).get(key, {})
        # Beat-dispatch latency tails (fused_beat_ms/p50/p95/max) are
        # lower-is-better; beats and the steps/rows rates are throughput.
        add(key, fa.get("steady"), fb.get("steady"),
            lower_better=("_ms" in key or "p95" in key or "p50" in key
                          or key.endswith("_max")))
    for key in sorted(set(a.get("mesh", {})) | set(b.get("mesh", {}))):
        if key in ("mesh_data_axis", "mesh_model_axis"):
            continue  # mesh shape is context, not a metric to delta
        ma_ = a.get("mesh", {}).get(key, {})
        mb_ = b.get("mesh", {}).get(key, {})
        # Both bytes gauges are lower-is-better: per-device is the
        # placement fact, and an unexplained TOTAL growth (an extra
        # state copy) is a memory regression, never an improvement.
        add(key, ma_.get("last"), mb_.get("last"),
            lower_better=("bytes" in key))
    for key in sorted(
        set(a.get("replay_sharding", {})) | set(b.get("replay_sharding", {}))
    ):
        ra = a.get("replay_sharding", {}).get(key, {})
        rb = b.get("replay_sharding", {}).get(key, {})
        # Shard count / fill / per-device storage bytes are placement
        # facts (context); bytes-per-row and exchange tails are the
        # lower-is-better costs.
        add(key, ra.get("steady"), rb.get("steady"),
            lower_better=("bytes_per_row" in key or "_ms" in key
                          or "p95" in key or "p50" in key))
    for key in sorted(set(a.get("pod", {})) | set(b.get("pod", {}))):
        if key in ("pod_resume_step_elected", "pod_slice_adopted_step",
                   "pod_straggler_host", "pod_agg_hosts"):
            continue  # steps/host indices/world size: context, not deltas
        pa = a.get("pod", {}).get(key, {})
        pb = b.get("pod", {}).get(key, {})
        add(key, pa.get("last"), pb.get("last"),
            lower_better=("slack" not in key and "beats" not in key))
    for key in sorted(
        set(a.get("guardrail", {})) | set(b.get("guardrail", {}))
    ):
        if key == "guardrail_last_rollback_step":
            continue  # a restore step is context, not a metric to delta
        ga = a.get("guardrail", {}).get(key, {})
        gb = b.get("guardrail", {}).get(key, {})
        add(key, ga.get("last"), gb.get("last"), lower_better=True)
    for key in sorted(set(a.get("recovery", {})) | set(b.get("recovery", {}))):
        ra = a.get("recovery", {}).get(key, {})
        rb = b.get("recovery", {}).get(key, {})
        add(key, ra.get("last"), rb.get("last"), lower_better=True)
    ea, eb = a.get("eval", {}), b.get("eval", {})
    add("eval_best", ea.get("best"), eb.get("best"))
    fa, fb = a.get("final", {}), b.get("final", {})
    add("final_return", fa.get("final_return"), fb.get("final_return"))
    add("final_learner_steps_per_sec", fa.get("learner_steps_per_sec"),
        fb.get("learner_steps_per_sec"))
    table = render_table(["metric (steady)", "A", "B", "delta"], rows)
    header = f"A = {path_a}\nB = {path_b}\n('!' = >=5% worse, '+' = >=5% better)"
    return header + "\n" + table, rows


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------

DEFAULT_GATE_KEYS = ("value",)


def _lookup(obj: Dict[str, Any], dotted: str):
    """Resolve 'scaling_cpu_virtual.scaled_batch.8.rows_per_sec' style
    paths into nested bench JSON."""
    cur: Any = obj
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def gate_bench(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    threshold: float,
    keys: Sequence[str] = DEFAULT_GATE_KEYS,
) -> Tuple[bool, List[str]]:
    """True = pass. A key prefixed '-' is lower-is-better (latencies);
    otherwise higher-is-better (rates). A key missing from the CANDIDATE
    while present in the baseline FAILS (a silently dropped metric must
    not read as healthy); missing from both is skipped with a note."""
    ok = True
    lines = []
    for raw in keys:
        lower_better = raw.startswith("-")
        key = raw[1:] if lower_better else raw
        base = _lookup(baseline, key)
        cand = _lookup(candidate, key)
        if not isinstance(base, (int, float)) or isinstance(base, bool):
            lines.append(f"SKIP {key}: not in baseline ({base!r})")
            continue
        if not isinstance(cand, (int, float)) or isinstance(cand, bool):
            ok = False
            lines.append(f"FAIL {key}: missing from candidate ({cand!r})")
            continue
        if base == 0:
            if lower_better and isinstance(base, int):
                # A zero baseline on a lower-is-better COUNTER (e.g.
                # -guardrail_rollbacks) is a real pin: any nonzero
                # candidate is a regression from "never happened", which
                # no relative threshold can express. Int-typed only:
                # latency keys (-ingest_ship_ms, -transfer_*_p95) emit
                # FLOAT 0.0 when their reservoir saw no samples, and
                # "no samples" must keep SKIPping, not fail the first
                # candidate that records any.
                bad = cand > 0
                lines.append(
                    f"{'FAIL' if bad else 'ok':4s} {key}: baseline=0 "
                    f"candidate={cand:g} (zero-baseline pin, "
                    "lower-is-better counter)"
                )
                ok = ok and not bad
            else:
                lines.append(f"SKIP {key}: baseline is 0")
            continue
        ratio = cand / base
        if lower_better:
            bad = ratio > 1.0 + threshold
            rel = ratio - 1.0
        else:
            bad = ratio < 1.0 - threshold
            rel = ratio - 1.0
        verdict = "FAIL" if bad else "ok"
        lines.append(
            f"{verdict:4s} {key}: baseline={base:g} candidate={cand:g} "
            f"({rel:+.1%}, threshold ±{threshold:.0%}, "
            f"{'lower' if lower_better else 'higher'}-is-better)"
        )
        ok = ok and not bad
    return ok, lines


# ---------------------------------------------------------------------------
# merge-trace
# ---------------------------------------------------------------------------


def merge_traces(paths: Sequence[str], out_path: str) -> Tuple[int, int]:
    """Fuse N per-host Chrome-trace files (trace.py export) into ONE
    Perfetto timeline with a process track per host, on an aligned clock.

    Each input's events carry ts relative to that process's own recorder
    start; its `otherData.wall_t0` anchors them to the host's wall clock,
    and `otherData.clock_offset_ms` (the startup clock handshake,
    parallel/multihost.clock_handshake) removes the host's measured skew
    from host 0 — so the merged timeline aligns on HANDSHAKE time, not on
    whatever NTP left each host believing. Events are re-based to the
    earliest aligned anchor, each input's pids are remapped to its host
    index (Perfetto renders one process track per pid), and a
    `process_name` metadata event labels each track with the host index,
    original pid, and source file. Returns (events_written, n_inputs)."""
    loaded = []
    for i, path in enumerate(paths):
        with open(path, encoding="utf-8") as fh:
            obj = json.load(fh)
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(f"{path}: not a Chrome trace (no traceEvents)")
        od = obj.get("otherData") or {}
        wall_t0 = od.get("wall_t0")
        offset_ms = od.get("clock_offset_ms") or 0.0
        # Aligned anchor: this recorder's ts=0 expressed on host 0's
        # clock. A file without wall_t0 (foreign trace) anchors at 0.
        base = (
            float(wall_t0) - float(offset_ms) / 1e3
            if isinstance(wall_t0, (int, float))
            else None
        )
        host = od.get("process_index")
        loaded.append((path, events, od, base,
                       host if isinstance(host, int) else i))
    known = [base for (_, _, _, base, _) in loaded if base is not None]
    t0 = min(known) if known else 0.0

    merged: List[Dict[str, Any]] = []
    for path, events, od, base, host in loaded:
        shift_us = ((base - t0) * 1e6) if base is not None else 0.0
        for ev in events:
            ev = dict(ev)
            if isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = ev["ts"] + shift_us
            ev["pid"] = host
            merged.append(ev)
        label = f"host{host} pid={od.get('pid', '?')}"
        merged.append({
            "name": "process_name", "ph": "M", "pid": host, "ts": 0,
            "args": {"name": f"{label} ({path})"},
        })
        merged.append({
            "name": "process_sort_index", "ph": "M", "pid": host, "ts": 0,
            "args": {"sort_index": host},
        })
    out = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": list(paths),
            "t_unix_base": t0,
        },
    }
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(out, fh)
    return len(merged), len(loaded)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def render_lint(obj: Dict[str, Any]) -> Tuple[bool, str]:
    """Digest tables for an invariant-lint findings JSON (the artifact
    scripts/lint_gate.sh leaves behind; schema: analysis/engine.py
    LintResult.to_json). Returns (clean, text) — clean mirrors the gate's
    PASS/FAIL so CI boxes can render and re-check in one call."""
    counts = obj.get("counts", {})
    findings = obj.get("findings", [])
    live = [f for f in findings if not f.get("suppressed")]
    out = [
        f"lint: {counts.get('files', '?')} files, "
        f"{len(obj.get('rules', []))} rules, "
        f"{counts.get('findings', len(live))} findings "
        f"({counts.get('suppressed', 0)} suppressed) "
        f"in {obj.get('elapsed_s', 0.0):.2f}s"
    ]
    per_rule: Dict[str, List[int]] = {}
    for f in findings:
        row = per_rule.setdefault(f.get("rule", "?"), [0, 0])
        row[1 if f.get("suppressed") else 0] += 1
    if per_rule:
        out.append("")
        out.append(render_table(
            ["rule", "findings", "suppressed"],
            [[r, n, s] for r, (n, s) in sorted(per_rule.items())],
        ))
    if live:
        out.append("")
        out.append(render_table(
            ["location", "rule", "message"],
            [[f"{f.get('path')}:{f.get('line')}", f.get("rule"),
              f.get("message", "")] for f in live],
        ))
    return not live, "\n".join(out)


def render_programs(obj: Dict[str, Any]) -> Tuple[bool, str]:
    """Digest tables for a program-contract analyzer report JSON (the
    artifact scripts/proganalyze_gate.sh leaves behind; schema:
    analysis/programs.py ProgramReport.to_json). Returns (clean, text) —
    clean mirrors the gate's PASS/FAIL."""
    counts = obj.get("counts", {})
    findings = obj.get("findings", [])
    programs = obj.get("programs", [])
    out = [
        f"programs: {counts.get('programs', len(programs))} traced, "
        f"{counts.get('findings', len(findings))} findings "
        f"in {obj.get('elapsed_s', 0.0):.2f}s"
    ]
    if obj.get("updated"):
        out.append(f"updated goldens: {', '.join(obj['updated'])}")
    if programs:
        out.append("")
        out.append(render_table(
            ["program", "collectives", "fingerprint", "donated", "aliased"],
            [[p.get("name"), len(p.get("collectives", [])),
              p.get("fingerprint", "?"), p.get("donated_leaves", 0),
              p.get("aliased_leaves", 0)] for p in programs],
        ))
    if findings:
        out.append("")
        out.append(render_table(
            ["program", "check", "message"],
            [[f.get("program"), f.get("check"), f.get("message", "")]
             for f in findings],
        ))
    return not findings, "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_ddpg_tpu_torch.tools.runs",
        description=__doc__.split("\n\n")[0],
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser("summarize", help="digest one or more JSONL runs")
    p_sum.add_argument("paths", nargs="+")
    p_sum.add_argument("--json", action="store_true",
                       help="emit the digest as JSON instead of tables")

    p_cmp = sub.add_parser("compare", help="A/B two JSONL runs")
    p_cmp.add_argument("path_a")
    p_cmp.add_argument("path_b")

    p_gate = sub.add_parser(
        "gate", help="CI regression gate over two bench JSONs "
        "(exit 2 on regression)",
    )
    p_gate.add_argument("baseline")
    p_gate.add_argument("candidate")
    p_gate.add_argument("--threshold", type=float, default=0.1,
                        help="allowed relative regression (default 0.10)")
    p_gate.add_argument(
        "--keys", default=",".join(DEFAULT_GATE_KEYS),
        help="comma-separated bench keys; prefix '-' for lower-is-better "
        "(e.g. value,-t_dispatch_ms,ingest_rows_per_sec); dotted paths "
        "descend into nested objects",
    )
    p_lint = sub.add_parser(
        "lint", help="pretty-print an invariant-lint findings JSON "
        "(the scripts/lint_gate.sh artifact; exit 2 on unsuppressed "
        "findings, same contract as the bench gate)",
    )
    p_lint.add_argument(
        "path", nargs="?", default="runs/lint_findings.json",
        help="findings JSON (default: runs/lint_findings.json, the "
        "lint_gate.sh default artifact)",
    )
    p_prog = sub.add_parser(
        "programs", help="pretty-print a program-contract analyzer report "
        "JSON (the scripts/proganalyze_gate.sh artifact; exit 2 on "
        "findings, same contract as the lint digest)",
    )
    p_prog.add_argument(
        "path", nargs="?", default="runs/program_findings.json",
        help="report JSON (default: runs/program_findings.json, the "
        "proganalyze_gate.sh default artifact)",
    )
    p_mt = sub.add_parser(
        "merge-trace", help="fuse N per-host Chrome traces (trace.py "
        "export) into one Perfetto timeline with a process track per "
        "host, clock-aligned via the startup handshake offsets",
    )
    p_mt.add_argument("paths", nargs="+",
                      help="per-host trace JSON files, one per process")
    p_mt.add_argument("--out", default="trace_merged.json",
                      help="merged timeline path (default: "
                      "trace_merged.json)")

    args = parser.parse_args(argv)

    if args.cmd == "summarize":
        for i, path in enumerate(args.paths):
            try:
                digest = summarize_run(path)
            except OSError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(digest))
            else:
                if i:
                    print()
                print(render_summary(digest))
        return 0

    if args.cmd == "compare":
        try:
            text, _ = compare_runs(args.path_a, args.path_b)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(text)
        return 0

    if args.cmd == "gate":
        try:
            base = load_bench(args.baseline)
            cand = load_bench(args.candidate)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        keys = [k for k in args.keys.split(",") if k]
        ok, lines = gate_bench(base, cand, args.threshold, keys)
        for line in lines:
            print(line)
        print("GATE PASS" if ok else "GATE FAIL")
        return 0 if ok else 2

    if args.cmd == "merge-trace":
        try:
            n_events, n_hosts = merge_traces(args.paths, args.out)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(
            f"merged {n_events} events from {n_hosts} host trace(s) -> "
            f"{args.out} (load in ui.perfetto.dev)"
        )
        return 0

    if args.cmd == "lint":
        try:
            with open(args.path, encoding="utf-8") as fh:
                obj = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not isinstance(obj, dict):
            print(f"error: {args.path} is not a findings object "
                  "(truncated artifact?)", file=sys.stderr)
            return 1
        clean, text = render_lint(obj)
        print(text)
        print("LINT PASS" if clean else "LINT FAIL")
        return 0 if clean else 2

    if args.cmd == "programs":
        try:
            with open(args.path, encoding="utf-8") as fh:
                obj = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not isinstance(obj, dict):
            print(f"error: {args.path} is not a program report object "
                  "(truncated artifact?)", file=sys.stderr)
            return 1
        clean, text = render_programs(obj)
        print(text)
        print("PROGRAMS PASS" if clean else "PROGRAMS FAIL")
        return 0 if clean else 2

    return 1  # unreachable (subparsers required)


if __name__ == "__main__":
    sys.exit(main())
