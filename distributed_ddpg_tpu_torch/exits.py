"""The process exit codes of the port's trainer (counterpart of
distributed_ddpg_tpu/exits.py, trimmed to the codes the port can return).

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
    77  EXIT_NUMERIC    the guardrails (--guardrails=true) used up their
                        rollback budget, or had no checkpoint to roll
                        back to: the params are presumed poisoned and NO
                        checkpoint was written. Do not relaunch blindly;
                        read the guardrail_* counters first.

The JAX package's other codes (76 and 78 pods, 79 supervisor) arrive
with the slices that can raise them.
"""

EXIT_OK = 0
EXIT_WATCHDOG_STALL = 70
EXIT_PREEMPTED = 75
EXIT_NUMERIC = 77

NAMES = {
    EXIT_OK: "ok",
    EXIT_WATCHDOG_STALL: "watchdog_stall",
    EXIT_PREEMPTED: "preempted",
    EXIT_NUMERIC: "numeric_abort",
}
