"""`python -m distributed_ddpg_tpu_torch.tools.supervise` — run a pod under
the shrink/grow supervisor (supervisor/core.py; counterpart of
distributed_ddpg_tpu/tools/supervise.py, the same CLI):

    python -m distributed_ddpg_tpu_torch.tools.supervise \\
        --procs 2 --event-log runs/supervisor.jsonl \\
        --child-logs runs/children \\
        --env DDPG_DIST_BACKEND=gloo \\
        -- python -m distributed_ddpg_tpu_torch.train --checkpoint_dir=/ckpt/run1 \\
           --log_path=/logs/gen{gen}_proc{proc}.jsonl

Everything after `--` is the per-child command template; `{proc}`,
`{nprocs}`, `{port}` and `{gen}` are substituted per spawn (the same
placeholders work inside --env values, e.g. a per-generation log
directory `POD_LOG_DIR=/logs/gen{gen}`). `--env-first` entries apply to
generation 1 only: that is where fault injection belongs, so a scripted
kill does not fire again in every relaunched generation (the trainer
reads no fault plan from its environment; a drill's child wrapper, such
as `tests/torch_pod_child.py --train`, reads one from POD_FAULTS).

Each child also gets the environment torchrun would set for node {proc}
of a pod of {nprocs} nodes of one rank each, rendezvous at
127.0.0.1:{port}: RANK={proc}, WORLD_SIZE={nprocs}, LOCAL_RANK=0,
LOCAL_WORLD_SIZE=1, GROUP_RANK={proc}, GROUP_WORLD_SIZE={nprocs},
MASTER_ADDR=127.0.0.1, MASTER_PORT={port}. So the port's trainer joins
its pod (parallel/multihost.initialize) with nothing more on its command
line; name the process group's backend with --env DDPG_DIST_BACKEND=gloo
when the nodes share a card. `--env` and `--env-first` entries override
these.

Exit codes (exits.py): 0 when the supervised run completes its budget,
75 when the supervisor itself is SIGTERMed (the running generation is
drained first), 79 with a JSON report on disk when it gives up
(crash-loop breaker, numeric budget or generation budget).
"""

from __future__ import annotations

import argparse
import signal
import sys
from typing import Dict, List, Tuple

from distributed_ddpg_tpu_torch import exits
from distributed_ddpg_tpu_torch.supervisor import (
    PodSupervisor,
    SupervisorConfig,
    SupervisorGaveUp,
)


def _parse_env(pairs: List[str], flag: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for pair in pairs:
        key, sep, val = pair.partition("=")
        if not sep or not key:
            raise SystemExit(f"{flag} wants KEY=VALUE, got {pair!r}")
        out[key] = val
    return out


def torchrun_env(proc: int, nprocs: int, port: int) -> Dict[str, str]:
    """The rendezvous environment torchrun sets for node `proc` of a pod of
    `nprocs` nodes of one rank each, on this host (module docstring)."""
    return {
        "RANK": str(proc), "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
        "GROUP_RANK": str(proc), "GROUP_WORLD_SIZE": str(nprocs),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_ddpg_tpu_torch.tools.supervise",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("--procs", type=int, required=True,
                   help="full-strength pod size N")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first relaunch backoff, seconds (doubles)")
    p.add_argument("--backoff-max", type=float, default=60.0)
    p.add_argument("--breaker-failures", type=int, default=5,
                   help="failing generations within --breaker-window "
                        "that trip the crash-loop breaker (0=off)")
    p.add_argument("--breaker-window", type=float, default=300.0)
    p.add_argument("--healthy-run", type=float, default=60.0,
                   help="generations older than this reset the "
                        "consecutive-failure count")
    p.add_argument("--max-numeric", type=int, default=0,
                   help="exit-77 relaunch budget (default: refuse)")
    p.add_argument("--max-generations", type=int, default=0,
                   help="hard generation cap, 0=unbounded")
    p.add_argument("--drain-grace", type=float, default=60.0,
                   help="after the first child exit, peers get this "
                        "long to take their own typed exits")
    p.add_argument("--kill-grace", type=float, default=10.0,
                   help="SIGTERM -> SIGKILL escalation")
    p.add_argument("--probe-host", default="127.0.0.1")
    p.add_argument("--probe-port-base", type=int, default=0,
                   help="slot i's /healthz probed at base+i "
                        "(0 disables rejoin probing — the pod can "
                        "shrink but never grows back)")
    p.add_argument("--probe-interval", type=float, default=2.0)
    p.add_argument("--probe-healthy-k", type=int, default=3,
                   help="consecutive healthy probes before rejoin")
    p.add_argument("--probe-hysteresis", type=float, default=10.0,
                   help="min continuous-healthy seconds before rejoin")
    p.add_argument("--grow-defer", type=float, default=30.0,
                   help="min running-generation age before a "
                        "stop-the-world grow resize")
    p.add_argument("--event-log", default="",
                   help="supervision JSONL (tools.runs summarize "
                        "renders it)")
    p.add_argument("--report", default="",
                   help="gave-up report path (default: alongside "
                        "--event-log)")
    p.add_argument("--child-logs", default="",
                   help="directory for per-child gen<G>_proc<P>.log")
    p.add_argument("--env", action="append", default=[],
                   metavar="KEY=VAL",
                   help="child environment override, every generation")
    p.add_argument("--env-first", action="append", default=[],
                   metavar="KEY=VAL",
                   help="child environment override, generation 1 ONLY "
                        "(fault injection lives here)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- child command template "
                        "({proc} {nprocs} {port} {gen})")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("supervise: no child command given (after --)",
              file=sys.stderr)
        return 2
    env_all = _parse_env(args.env, "--env")
    env_first = _parse_env(args.env_first, "--env-first")

    def command_builder(
        proc: int, nprocs: int, port: int, gen: int
    ) -> Tuple[List[str], Dict[str, str]]:
        subs = {"proc": proc, "nprocs": nprocs, "port": port, "gen": gen}
        argv_out = [part.format(**subs) for part in command]
        env = torchrun_env(proc, nprocs, port)
        env.update({k: v.format(**subs) for k, v in env_all.items()})
        if gen == 1:
            env.update(
                {k: v.format(**subs) for k, v in env_first.items()}
            )
        return argv_out, env

    cfg = SupervisorConfig(
        procs=args.procs,
        backoff_base_s=args.backoff_base,
        backoff_max_s=args.backoff_max,
        breaker_failures=args.breaker_failures,
        breaker_window_s=args.breaker_window,
        healthy_run_s=args.healthy_run,
        max_numeric=args.max_numeric,
        max_generations=args.max_generations,
        drain_grace_s=args.drain_grace,
        kill_grace_s=args.kill_grace,
        probe_host=args.probe_host,
        probe_port_base=args.probe_port_base,
        probe_interval_s=args.probe_interval,
        probe_healthy_k=args.probe_healthy_k,
        probe_hysteresis_s=args.probe_hysteresis,
        grow_defer_s=args.grow_defer,
        event_log=args.event_log,
        report_path=args.report,
        child_log_dir=args.child_logs,
    )
    sup = PodSupervisor(cfg, command_builder)

    def _on_signal(*_):
        sup.request_stop()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not on the main thread (embedded callers)

    try:
        return sup.run()
    except SupervisorGaveUp as e:
        print(
            f"supervise: gave up ({e.reason}) — report: "
            f"{e.report_path or '(unwritable)'}",
            file=sys.stderr,
        )
        return exits.EXIT_SUPERVISOR_GAVE_UP


if __name__ == "__main__":
    sys.exit(main())
