"""The process exit codes of the port's trainer (counterpart of
distributed_ddpg_tpu/exits.py, trimmed to the codes the port can return).

    0   EXIT_OK         the run reached its env-step budget.
    75  EXIT_PREEMPTED  SIGTERM: the running chunk finished, one emergency
                        checkpoint was written (with --checkpoint_dir),
                        and the run can be resumed from it: relaunch the
                        same command with the same --checkpoint_dir.

The JAX package's other codes (70 watchdog stall, 76-79 pods, numeric
abort, supervisor) arrive with the slices that can raise them.
"""

EXIT_OK = 0
EXIT_PREEMPTED = 75

NAMES = {
    EXIT_OK: "ok",
    EXIT_PREEMPTED: "preempted",
}
