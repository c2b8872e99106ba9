"""CLI for the port's invariant lint engine (distributed_ddpg_tpu_torch/
analysis/; the catalog is distributed_ddpg_tpu_torch/docs/ANALYSIS.md).

    python -m distributed_ddpg_tpu_torch.tools.lint                  # lint the port
    python -m distributed_ddpg_tpu_torch.tools.lint --json out.json  # + findings file
    python -m distributed_ddpg_tpu_torch.tools.lint --rules timeout-discipline path/

Exit codes: 0 = clean (suppressed findings allowed), 2 = unsuppressed
findings, 1 = usage error. Pure stdlib — never imports torch, jax or the
JAX package. `tools.runs lint` pretty-prints the emitted JSON.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

from distributed_ddpg_tpu_torch.analysis import RULES, run_lint
from distributed_ddpg_tpu_torch.analysis.engine import render_human, write_json
from distributed_ddpg_tpu_torch.analysis.rules import NO_COUNTERPART

_PACKAGE_ROOT = Path(__file__).resolve().parent.parent


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_ddpg_tpu_torch.tools.lint",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to lint (default: the "
             "distributed_ddpg_tpu_torch package)",
    )
    parser.add_argument(
        "--root", type=Path, default=None,
        help="root that rule path-scoping is relative to (default: the "
             "package dir, or the common parent of explicit paths)",
    )
    parser.add_argument(
        "--docs", type=Path, default=None,
        help="docs directory for the cross-file doc rules (default: "
             "<root>/docs or <root>/../docs, the first that holds "
             "OBSERVABILITY.md)",
    )
    parser.add_argument(
        "--json", type=Path, default=None, metavar="FILE",
        help="also write the machine-readable findings JSON here",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated rule subset (default: all); "
             f"known: {', '.join(r.name for r in RULES)}",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--changed-only", nargs="?", const="HEAD", default=None,
        metavar="REF",
        help="lint only files changed vs the git ref (default HEAD) — "
             "the sub-second pre-commit mode; note the cross-file doc "
             "rules see only the changed subset (docs/ANALYSIS.md)",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="suppress per-finding lines (summary + exit code only)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in RULES:
            print(f"{r.name:24s} {r.doc}")
        return 0

    rule_names = None
    if args.rules:
        rule_names = [r.strip() for r in args.rules.split(",") if r.strip()]
        known = {r.name for r in RULES}
        gone = [r for r in rule_names if r in NO_COUNTERPART]
        if gone:
            print("error: " + "; ".join(
                f"rule {r} has no counterpart in the port: {NO_COUNTERPART[r]}"
                for r in gone), file=sys.stderr)
            return 1
        bad = [r for r in rule_names if r not in known]
        if bad:
            print(f"error: unknown rule(s) {', '.join(bad)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 1

    if args.paths:
        paths = args.paths
        if args.root is not None:
            root = args.root
        else:
            # Paths inside the package anchor to the PACKAGE root — the
            # path-scoped rules (typed-error's serve/ prefix, the
            # parallel/multihost.py exemption) key on package-relative
            # paths, so `lint parallel/multihost.py` must not re-anchor
            # to parallel/. Arbitrary external trees fall back to their
            # common parent.
            resolved = [p.resolve() for p in paths]
            if all(r == _PACKAGE_ROOT or r.is_relative_to(_PACKAGE_ROOT)
                   for r in resolved):
                root = _PACKAGE_ROOT
            else:
                root = Path(os.path.commonpath([str(r) for r in resolved]))
        if root.is_file():
            root = root.parent
    else:
        root = args.root or _PACKAGE_ROOT
        paths = [root]
    for p in paths:
        if not p.exists():
            print(f"error: {p} does not exist", file=sys.stderr)
            return 1
        if not p.resolve().is_relative_to(root.resolve()):
            print(f"error: {p} is outside the lint root {root} — pass "
                  "--root (rule path-scoping is root-relative)",
                  file=sys.stderr)
            return 1

    if args.changed_only is not None:
        from distributed_ddpg_tpu_torch.analysis.engine import (
            _is_test_file,
            git_changed_files,
        )

        changed = git_changed_files(root, args.changed_only)
        if changed is None:
            print(
                f"error: --changed-only needs a git checkout and a valid "
                f"ref (git diff --name-only {args.changed_only} failed)",
                file=sys.stderr,
            )
            return 1
        rootr = root.resolve()
        # Explicit path args compose as a FILTER within the changed set
        # (same semantics as proganalyze --programs + --changed-only): a
        # pre-commit hook scoped to one subsystem must not fail on
        # unrelated changed files elsewhere in the tree.
        explicit = [p.resolve() for p in args.paths] if args.paths else None
        selected = []
        for c in changed:
            p = Path(c)
            if p.suffix != ".py" or not p.is_file():
                continue
            r = p.resolve()
            if not r.is_relative_to(rootr) or _is_test_file(rootr, r):
                continue
            if explicit is not None and not any(
                    r == e or r.is_relative_to(e) for e in explicit):
                continue
            selected.append(p)
        if not selected:
            scope = root if explicit is None else ", ".join(
                str(p) for p in args.paths)
            print(
                f"lint: no changed non-test Python files under {scope} vs "
                f"{args.changed_only} — nothing to lint"
            )
            return 0
        paths = selected

    docs = args.docs
    if docs is None:
        # Repo-anchored roots find docs/ directly under themselves; the
        # package root's own docs/ holds only the port's catalog, so it
        # falls back to <repo>/docs via parent. Self-first, so a stray
        # sibling docs dir can never shadow the tree being linted.
        for cand in (root.resolve() / "docs", root.resolve().parent / "docs"):
            if (cand / "OBSERVABILITY.md").is_file():
                docs = cand
                break

    result = run_lint(root, paths, docs_root=docs, rule_names=rule_names)
    if result.files == 0:
        # A gate that lints nothing must not read as green.
        print("error: no Python files found under the given paths",
              file=sys.stderr)
        return 1
    if args.json is not None:
        write_json(result, args.json)
    if args.quiet:
        text = render_human(result).splitlines()[-1]
    else:
        text = render_human(result)
    print(text)
    if result.unsuppressed:
        print(
            "lint: FAIL — fix the findings or suppress each with "
            "`# lint: ok(<rule>): <reason>` "
            "(distributed_ddpg_tpu_torch/docs/ANALYSIS.md)",
            file=sys.stderr,
        )
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
