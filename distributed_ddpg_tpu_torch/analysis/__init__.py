"""Invariant lint engine of the port: AST rules that enforce the port's
cross-cutting contracts (distributed_ddpg_tpu_torch/docs/ANALYSIS.md).

The counterpart of distributed_ddpg_tpu/analysis/: the same engine (a
stdlib copy, analysis/engine.py) and the JAX rule set retargeted at the
port's tree and its torch idioms (analysis/rules.py). The program-contract
analyzer (analysis/programs.py) imports torch and is not loaded here.

Pure stdlib (ast/re/json): importing this package never imports torch,
jax or the JAX package.

    python -m distributed_ddpg_tpu_torch.tools.lint      # human output
"""

from distributed_ddpg_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    Module,
    Rule,
    RULES,
    register,
    run_lint,
)
from distributed_ddpg_tpu_torch.analysis import rules as _rules  # noqa: F401 (registers RULES)

__all__ = [
    "Finding",
    "LintResult",
    "Module",
    "Rule",
    "RULES",
    "register",
    "run_lint",
]
