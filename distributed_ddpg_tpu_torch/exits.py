"""The process exit codes of the port's trainer and supervisor (counterpart
of distributed_ddpg_tpu/exits.py, the same numbers, names and describe()).

A supervisor keys its recovery on nothing but the child's exit
status, so these numbers are a cross-process API: train.py and
watchdog.py exit with them and supervisor/core.py dispatches on them.

    0   EXIT_OK         the run reached its env-step budget.
    70  EXIT_WATCHDOG_STALL  EX_SOFTWARE: no trainer progress for
                        --watchdog_s (watchdog.py): a blocking device
                        call wedged. The stall artifacts (stall_report.json,
                        stall_trace.json) say where; the state on disk is
                        the last cadence checkpoint's. Relaunch in place.
    75  EXIT_PREEMPTED  SIGTERM: the running chunk finished, one emergency
                        checkpoint was written (with --checkpoint_dir),
                        and the run can be resumed from it: relaunch the
                        same command with the same --checkpoint_dir.
    76  EXIT_POD_DEGRADED  a peer node of a pod died or hung in a pod
                        collective (parallel/multihost.PodPeerLost): each
                        survivor wrote one emergency checkpoint (node 0
                        into --checkpoint_dir, node k into its proc<k>
                        directory). Relaunch the whole pod with the same
                        directories: the resume election restores the
                        newest step every node holds.
    77  EXIT_NUMERIC    the guardrails (--guardrails=true) used up their
                        rollback budget, or had no checkpoint to roll
                        back to: the params are presumed poisoned and NO
                        checkpoint was written. Do not relaunch blindly;
                        read the guardrail_* counters first.
    78  EXIT_POD_SHRINK a peer of a sharded-replay pod was lost and a
                        complete, verified replay slice set is on disk
                        (checkpoint.latest_complete_slice_step), so the
                        pod may relaunch smaller: the relaunch adopts the
                        set, resharded to its own size (train.py).
    79  EXIT_SUPERVISOR_GAVE_UP  the supervisor (tools/supervise.py)
                        refused to go on: its crash-loop breaker tripped,
                        a numeric abort went past its budget, or its
                        generation budget ran out. Its JSON report says
                        why; a human decides next.

Negative statuses (as subprocess reports them) are deaths by signal and
are not part of the contract: `describe()` names them for event logs.
"""

from __future__ import annotations

import signal

EXIT_OK = 0
EXIT_WATCHDOG_STALL = 70
EXIT_PREEMPTED = 75
EXIT_POD_DEGRADED = 76
EXIT_NUMERIC = 77
EXIT_POD_SHRINK = 78
EXIT_SUPERVISOR_GAVE_UP = 79

# Event-log and report names of the typed codes (supervisor/events.py).
NAMES = {
    EXIT_OK: "ok",
    EXIT_WATCHDOG_STALL: "watchdog_stall",
    EXIT_PREEMPTED: "preempted",
    EXIT_POD_DEGRADED: "pod_degraded",
    EXIT_NUMERIC: "numeric_abort",
    EXIT_POD_SHRINK: "pod_shrink_ready",
    EXIT_SUPERVISOR_GAVE_UP: "supervisor_gave_up",
}


def describe(code) -> str:
    """The event-log name of a subprocess returncode: the contract's name
    for a typed code, `signal:SIGKILL` and the like for a death by signal
    (negative), `exit:<n>` for an untyped status, `unknown` for a child
    still running (None)."""
    if code is None:
        return "unknown"
    code = int(code)
    if code < 0:
        try:
            return f"signal:{signal.Signals(-code).name}"
        except ValueError:
            return f"signal:{-code}"
    return NAMES.get(code, f"exit:{code}")
