"""CLI for the port's program-contract analyzer (analysis/programs.py;
the catalog is distributed_ddpg_tpu_torch/docs/ANALYSIS.md).

    python -m distributed_ddpg_tpu_torch.tools.proganalyze                # check
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --update-golden
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --programs 'learner.*'
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --changed-only HEAD
    python -m distributed_ddpg_tpu_torch.tools.proganalyze --device cpu

Exit codes mirror tools.lint: 0 = clean, 2 = findings, 1 = usage error
(--device cuda without a card among them). Unlike tools.lint this imports
torch: each spec runs its program once at the probe sizes, on the card
with its kernels unless the caller passes --device cpu (then on the CPU,
each kernel's plain version). The port has no counterpart of JAX's
static `recompile-hazard` rule (no trace-cached program; the catalog says
why). `tools.runs programs` renders the JSON report.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

_PACKAGE_ROOT = Path(__file__).resolve().parent.parent
_REPO_ROOT = _PACKAGE_ROOT.parent
_DEFAULT_GOLDEN = _REPO_ROOT / "tests" / "golden_programs_torch"
_PACKAGE = "distributed_ddpg_tpu_torch/"

# What --changed-only watches WITHOUT importing torch: the spec-owner
# modules (kept in sync with programs.SPEC_MODULES — test_torch_programs.py
# pins the correspondence) plus the analyzer itself and the goldens.
_OWNER_FILES = (
    "distributed_ddpg_tpu_torch/parallel/learner.py",
    "distributed_ddpg_tpu_torch/parallel/megastep.py",
    "distributed_ddpg_tpu_torch/parallel/superstep.py",
    "distributed_ddpg_tpu_torch/replay/device.py",
    "distributed_ddpg_tpu_torch/actors/device_pool.py",
    "distributed_ddpg_tpu_torch/serve/server.py",
    "distributed_ddpg_tpu_torch/ondevice.py",
)
_WATCH_PREFIXES = (
    "distributed_ddpg_tpu_torch/analysis/",
    "distributed_ddpg_tpu_torch/tools/proganalyze.py",
    "tests/golden_programs_torch/",
)


def _load_specs(spec_ref: str):
    """Resolve `module:callable` or `path/to/file.py:callable` to a spec
    list — the hook the broken-fixture tests use to point the CLI at a
    registry other than the live tree's."""
    mod_part, _, attr = spec_ref.partition(":")
    attr = attr or "default_specs"
    if mod_part.endswith(".py"):
        import importlib.util

        p = Path(mod_part)
        spec = importlib.util.spec_from_file_location(p.stem, p)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {mod_part}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib

        mod = importlib.import_module(mod_part)
    return getattr(mod, attr)()


def _changed_scope(ref: str) -> Optional[List[str]]:
    """Owner files (package-relative) touched vs `ref`, or None meaning
    'everything' (an analyzer/golden/tooling change invalidates every
    fingerprint). Empty list = nothing relevant changed. Runs BEFORE any
    torch import so the no-op pre-commit path stays sub-second."""
    from distributed_ddpg_tpu_torch.analysis.engine import git_changed_files

    changed = git_changed_files(_REPO_ROOT, ref)
    if changed is None:
        raise ValueError(
            f"--changed-only needs a git checkout and a valid ref "
            f"(git diff --name-only {ref} failed)"
        )
    rel = []
    for c in changed:
        try:
            rel.append(Path(c).resolve().relative_to(_REPO_ROOT).as_posix())
        except ValueError:
            continue
    if any(r.startswith(_WATCH_PREFIXES) for r in rel):
        return None
    return [r for r in rel if r in _OWNER_FILES]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_ddpg_tpu_torch.tools.proganalyze",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument(
        "--golden", type=Path, default=_DEFAULT_GOLDEN, metavar="DIR",
        help="golden fingerprint directory "
             "(default: <repo>/tests/golden_programs_torch)",
    )
    parser.add_argument(
        "--update-golden", action="store_true",
        help="rewrite the golden fingerprints from the current trace and "
             "prune stale ones — review/commit the diff",
    )
    parser.add_argument(
        "--json", type=Path, default=None, metavar="FILE",
        help="also write the machine-readable report JSON here",
    )
    parser.add_argument(
        "--programs", default=None, metavar="NAMES",
        help="comma-separated program names (exact or glob, e.g. "
             "'learner.*'); scoped runs skip the stale-golden sweep",
    )
    parser.add_argument(
        "--specs", default=None, metavar="MODULE:CALLABLE",
        help="alternate spec registry (module path or .py file); default: "
             "the live default_specs() registry",
    )
    parser.add_argument(
        "--changed-only", nargs="?", const="HEAD", default=None,
        metavar="REF",
        help="scope to programs whose owner module changed vs the git ref "
             "(default HEAD); exits 0 without importing torch when nothing "
             "relevant changed",
    )
    parser.add_argument(
        "--list", action="store_true",
        help="print the registered program specs and exit",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the specs run their programs (default: the card, with "
             "their kernels; cpu runs their plain versions on the CPU)",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="suppress per-program detail (summary + exit code only)",
    )
    args = parser.parse_args(argv)

    only: Optional[List[str]] = None
    if args.programs:
        only = [p.strip() for p in args.programs.split(",") if p.strip()]

    if args.changed_only is not None:
        try:
            scope = _changed_scope(args.changed_only)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if scope == []:
            print(
                f"proganalyze: no program-owning module changed vs "
                f"{args.changed_only} — nothing to analyze"
            )
            return 0
        changed_owners = None if scope is None else set(scope)
    else:
        changed_owners = False  # sentinel: no scoping requested

    from distributed_ddpg_tpu_torch.analysis import programs as prog_lib

    try:
        specs = _load_specs(args.specs) if args.specs else (
            prog_lib.default_specs()
        )
    except Exception as e:
        print(f"error: loading specs failed: {e!r}", file=sys.stderr)
        return 1

    if changed_owners not in (False, None):
        # Scope to the changed owners' programs via names, so analyze()
        # knows the run is partial (skips the stale-golden sweep).
        scoped_names = [
            s.name for s in specs
            if _PACKAGE + s.owner in changed_owners
        ]
        if not scoped_names:
            print("proganalyze: changed modules own no registered "
                  "programs — nothing to analyze")
            return 0
        if only is None:
            only = scoped_names
        else:
            # --programs composes as a filter WITHIN the changed scope —
            # fnmatch like everywhere else, and say so when the
            # intersection is empty rather than green-lighting a run
            # that analyzed nothing.
            import fnmatch

            only = [
                n for n in scoped_names
                if any(fnmatch.fnmatch(n, pat) for pat in only)
            ]
            if not only:
                print("proganalyze: no program of the changed modules "
                      "matches --programs — nothing to analyze")
                return 0

    if args.list:
        for s in specs:
            group = f"  [beat:{s.beat_group}]" if s.beat_group else ""
            print(f"{s.name:42s} {s.owner}{group}")
        return 0

    if only is not None:
        import fnmatch

        matched = {
            pat for pat in only
            if any(fnmatch.fnmatch(s.name, pat) for s in specs)
        }
        unmatched = [pat for pat in only if pat not in matched]
        if unmatched:
            print(
                f"error: --programs pattern(s) {', '.join(unmatched)} "
                "match no registered program (see --list)",
                file=sys.stderr,
            )
            return 1

    from distributed_ddpg_tpu_torch.devices import require_device

    try:
        require_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (--device cpu)", file=sys.stderr)
        return 1
    report = prog_lib.analyze(
        specs, args.golden, update_golden=args.update_golden, only=only,
        # An alternate --specs registry knows nothing about the live
        # programs: sweeping (or pruning, under --update-golden) the
        # default golden dir against it would flag/delete every
        # committed golden. Its own golden dir is swept.
        sweep_stale=(args.specs is None
                     or args.golden.resolve() != _DEFAULT_GOLDEN.resolve()),
        device=args.device,
    )

    if args.json is not None:
        prog_lib.write_report(report, args.json)
    text = prog_lib.render_human(report)
    if args.quiet:
        text = text.splitlines()[-1]
    print(text)
    if report.findings:
        print(
            "proganalyze: FAIL — fix the findings, or re-run with "
            "--update-golden and review the golden diff if a collective "
            "reorder is intentional (distributed_ddpg_tpu_torch/docs/ANALYSIS.md)",
            file=sys.stderr,
        )
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
