"""Rule engine core: module loading, rule registry, suppressions, output.

A stdlib copy of distributed_ddpg_tpu/analysis/engine.py for the port: the
same Finding, Module, LintContext, Rule, register and run_lint, the same
suppression grammar and pseudo-rules, the same JSON schema (so
`tools.runs lint` renders either engine's output). It keys path-scoped
rules on the `distributed_ddpg_tpu_torch` package directory, and imports
neither torch, nor jax, nor anything of the JAX package.

The engine is deliberately boring: parse every Python file under the
target root with stdlib `ast`, hand each module to every registered
per-module rule, then hand the whole module set (plus the docs tree) to
the cross-file rules. Rules yield `Finding`s; the engine matches them
against `# lint: ok(<rule>)` suppressions and renders JSON + human text.

Suppression grammar (the port's catalog, distributed_ddpg_tpu_torch/docs/ANALYSIS.md):

    some_call()  # lint: ok(rule-name): reason the invariant holds here
    # lint: ok(rule-a, rule-b): one comment may cover several rules

A suppression covers findings of the named rule(s) whose statement span
includes its physical line (so the comment may sit on any line of a
multi-line call), or — for a comment-only line — findings on the next
non-comment line. The
reason is MANDATORY: a reasonless suppression does not suppress anything
and is itself reported (rule `bad-suppression`), so "silenced because
annoying" can never land without leaving a reviewable sentence behind.
A suppression that matches no finding is reported too (rule
`unused-suppression`): stale escapes must not outlive the code they
excused.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import time
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# The package directory path-scoped rules key on (Module.rulepath).
_PACKAGE = "distributed_ddpg_tpu_torch"

# Engine-level pseudo-rules (not in the registry; always on).
PARSE_ERROR = "parse-error"
BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ok\(\s*([a-z0-9_-]+(?:\s*,\s*[a-z0-9_-]+)*)\s*\)"
    r"\s*(?:[:—-]\s*(\S.*))?\s*$"
)


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location. `suppressed` /
    `suppression_reason` are filled in by the engine after matching
    `# lint: ok(...)` comments; rules never set them."""

    rule: str
    path: str          # relative to the lint root, '/'-separated
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    end_line: int = 0  # last line of the flagged statement (0: same as line)
    suppressed: bool = False
    suppression_reason: str = ""
    # exact=True: suppressions must sit on the flagged node's OWN lines —
    # no widening to the enclosing statement. For findings anchored to one
    # element of a large literal (a *Stats snapshot dict key, a COMPONENTS
    # tuple entry), where statement-span matching would let one per-field
    # suppression silently cover every sibling's future drift.
    exact: bool = False

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        del d["exact"]  # engine-internal matching detail, not schema
        return d

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col} [{self.rule}]{tag} {self.message}"


@dataclasses.dataclass
class Suppression:
    path: str
    line: int           # line the comment sits on
    covers_line: int    # line whose findings it suppresses
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


class Module:
    """One parsed source file: path (relative to the lint root), raw text,
    line list, and the ast.Module tree (None when the file failed to
    parse — the engine reports `parse-error` and rules skip it).

    `relpath` (root-relative) is what findings report; `rulepath` is what
    path-scoped rules key on: the path relative to the innermost
    `distributed_ddpg_tpu_torch` package dir when one appears in relpath, else
    relpath itself. This keeps the parallel/multihost.py exemption, the
    serve/-prefix typed-error scoping, and the metrics.py lookups correct
    under ANY --root (repo root, package dir, or a bare fixture tree)."""

    def __init__(self, root: Path, path: Path):
        self.abspath = path
        self.relpath = path.relative_to(root).as_posix()
        parts = path.relative_to(root).parts
        self.rulepath = self.relpath
        if _PACKAGE in parts[:-1]:
            i = len(parts) - 1 - parts[::-1].index(_PACKAGE)
            self.rulepath = "/".join(parts[i + 1:])
        self.text = path.read_text(encoding="utf-8", errors="replace")
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        self._stmt_spans: Optional[List[Tuple[int, int]]] = None
        try:
            self.tree = ast.parse(self.text, filename=str(path))
        except SyntaxError as e:
            self.parse_error = e

    def stmt_span(self, line: int) -> Tuple[int, int]:
        """(first, last) line of the innermost SIMPLE statement whose span
        contains `line` — the span suppressions match against, so a finding
        anchored to one expression of a multi-line call (donation-safety's
        read node) is still covered by a comment on the closing-paren line
        or a comment-only line above the statement. Simple statements only:
        extending through compound spans (a class or `if` body) would let a
        suppression deep inside the body mask a header-anchored finding —
        exactly what the class-header anchoring of observability-drift
        findings exists to prevent."""
        if self._stmt_spans is None:
            spans: List[Tuple[int, int]] = []
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    if isinstance(node, ast.stmt) and not hasattr(node, "body"):
                        spans.append(
                            (node.lineno, node.end_lineno or node.lineno)
                        )
            self._stmt_spans = spans
        best, best_size = (line, line), None
        for a, b in self._stmt_spans:
            if a <= line <= b and (best_size is None or b - a < best_size):
                best, best_size = (a, b), b - a
        return best

    def finding(self, rule: str, node: ast.AST, message: str,
                exact: bool = False) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.relpath,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            end_line=getattr(node, "end_lineno", None) or line,
            exact=exact,
        )

    def suppressions(self) -> List[Suppression]:
        # Real COMMENT tokens only (tokenize, not a line regex): the
        # grammar documented inside a docstring — like the engine's own —
        # must not register as a live suppression.
        out: List[Suppression] = []
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline
            ))
        except (tokenize.TokenError, IndentationError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                # An ok-marker that doesn't parse (missing colon, empty
                # rule list, junk after the paren): record it with no
                # rules so the engine reports it instead of letting the
                # author believe the line is covered.
                if re.search(r"#\s*lint:\s*ok", tok.string):
                    out.append(Suppression(self.relpath, i, i, (), ""))
                continue
            line = self.lines[i - 1]
            rules = tuple(r.strip() for r in m.group(1).split(","))
            reason = (m.group(2) or "").strip()
            # Comment-only line: the suppression covers the next
            # non-comment line (the statement it annotates).
            covers = i
            if line.strip().startswith("#"):
                j = i + 1
                while j <= len(self.lines) and (
                    not self.lines[j - 1].strip()
                    or self.lines[j - 1].strip().startswith("#")
                ):
                    j += 1
                covers = min(j, len(self.lines))
            out.append(Suppression(self.relpath, i, covers, rules, reason))
        return out


class LintContext:
    """What cross-file rules see: every parsed module plus the docs tree.
    `docs_root` is the directory holding OBSERVABILITY.md / RESILIENCE.md
    (repo `docs/`); None when the caller linted a bare file set with no
    docs alongside — doc-coupled rules then stay silent. `doc_text` also
    reads the port's own catalog, `docs/ANALYSIS.md` beside a module the
    rule names (`package_doc_text`)."""

    def __init__(self, root: Path, modules: Sequence[Module],
                 docs_root: Optional[Path]):
        self.root = root
        self.modules = list(modules)
        self.docs_root = docs_root

    def module(self, rulepath: str) -> Optional[Module]:
        for m in self.modules:
            if m.rulepath == rulepath:
                return m
        return None

    def doc_text(self, name: str) -> Optional[str]:
        if self.docs_root is None:
            return None
        p = self.docs_root / name
        if not p.is_file():
            return None
        return p.read_text(encoding="utf-8", errors="replace")


def package_doc_text(module: "Module", name: str) -> str:
    """`docs/<name>` beside `module`'s file (the port keeps its catalog and
    the rows of port-only fields inside its package); "" when absent."""
    p = module.abspath.parent / "docs" / name
    if not p.is_file():
        return ""
    return p.read_text(encoding="utf-8", errors="replace")


class Rule:
    """Base class: subclass, set `name`/`doc`, implement one (or both) of
    `check_module` / `check_project`, and decorate with @register."""

    name = ""
    doc = ""

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        return ()

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        return ()


RULES: List[Rule] = []


def register(cls):
    """Class decorator: instantiate and add to the global registry. Rule
    names must be unique kebab-case — the suppression grammar and the
    --rules CLI filter key on them."""
    inst = cls()
    if not inst.name or any(r.name == inst.name for r in RULES):
        raise ValueError(f"rule {cls.__name__} needs a unique name")
    RULES.append(inst)
    return cls


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files: int
    elapsed_s: float
    rules: List[str]

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def to_json(self) -> Dict[str, object]:
        return {
            "version": 1,
            "rules": self.rules,
            "counts": {
                "files": self.files,
                "findings": len(self.unsuppressed),
                "suppressed": len(self.findings) - len(self.unsuppressed),
            },
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": [f.to_json() for f in self.findings],
        }


def _is_test_file(root: Path, path: Path) -> bool:
    """Root-relative test-tree check: the rules enforce NON-TEST hot-path
    discipline (a test's `fired.wait(2)` is fine, and the deliberately
    dirty fixture trees under tests/lint_fixtures/ must never gate a
    repo-root run). Relative to the LINT root, so a fixture tree linted
    AS its own root — whose absolute path contains tests/ — still lints
    in full."""
    try:
        rel = path.relative_to(root)
    except ValueError:
        return False
    return (
        "tests" in rel.parts[:-1]
        or rel.name.startswith("test_")
        or rel.name == "conftest.py"
    )


def _collect_files(root: Path, paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            # Directory scans skip test trees; a test file named
            # EXPLICITLY still lints (the author asked for it).
            files.extend(
                q for q in sorted(p.rglob("*.py"))
                if "__pycache__" not in q.parts
                and not _is_test_file(root, q)
            )
        elif p.suffix == ".py":
            files.append(p)
    # De-dup while keeping order (a file passed twice lints once).
    seen = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def run_lint(
    root: Path,
    paths: Optional[Sequence[Path]] = None,
    docs_root: Optional[Path] = None,
    rule_names: Optional[Sequence[str]] = None,
) -> LintResult:
    """Lint every .py under `paths` (default: `root` itself). `root`
    anchors relative paths — rules scope on them (e.g. typed-error only
    fires under serve/, transfer/, ...), so fixture trees replicate the
    package layout under their own root. Returns every finding, matched
    against suppressions; callers decide the exit code from
    `result.unsuppressed`."""
    t0 = time.perf_counter()
    root = root.resolve()
    files = _collect_files(root, [p.resolve() for p in (paths or [root])])
    modules = [Module(root, f) for f in files]

    active = [
        r for r in RULES
        if rule_names is None or r.name in rule_names
    ]
    ctx = LintContext(root, modules, docs_root)

    findings: List[Finding] = []
    suppressions: List[Suppression] = []
    for mod in modules:
        if mod.parse_error is not None:
            findings.append(Finding(
                rule=PARSE_ERROR, path=mod.relpath,
                line=mod.parse_error.lineno or 1, col=0,
                message=f"file does not parse: {mod.parse_error.msg}",
            ))
            continue
        suppressions.extend(mod.suppressions())
        for rule in active:
            findings.extend(rule.check_module(mod, ctx))
    for rule in active:
        findings.extend(rule.check_project(ctx))

    # Match suppressions. Reasonless suppressions never suppress — they
    # become findings themselves, and the finding they failed to cover
    # stays live: the gate holds until a reason is written down.
    mod_by_path = {m.relpath: m for m in modules}
    for f in findings:
        # The flagged node's own span, widened to its innermost simple
        # statement: a finding anchored to one sub-expression must still
        # accept the comment on the statement's closing-paren line (or a
        # comment-only line above the statement). `exact` findings skip
        # the widening — one per-field suppression inside a snapshot dict
        # must not cover its siblings.
        start, end = f.line, max(f.end_line, f.line)
        mod = mod_by_path.get(f.path)
        if mod is not None and not f.exact:
            a, b = mod.stmt_span(f.line)
            start, end = min(start, a), max(end, b)
        for s in suppressions:
            if (
                s.path == f.path
                and start <= s.covers_line <= end
                and f.rule in s.rules
            ):
                if not s.reason:
                    s.used = True  # targeted, but invalid: flag it below
                    continue
                s.used = True
                f.suppressed = True
                f.suppression_reason = s.reason
                break
    all_names = {r.name for r in RULES}
    active_names = {r.name for r in active}
    for s in suppressions:
        unknown = [r for r in s.rules if r not in all_names]
        if not s.rules:
            findings.append(Finding(
                rule=BAD_SUPPRESSION, path=s.path, line=s.line, col=0,
                message=(
                    "malformed suppression — it covers nothing; grammar: "
                    "`# lint: ok(<rule>): <why the invariant holds here>`"
                ),
            ))
        elif unknown:
            findings.append(Finding(
                rule=BAD_SUPPRESSION, path=s.path, line=s.line, col=0,
                message=(
                    f"suppression names unknown rule(s) "
                    f"{', '.join(unknown)} — a typo here silently "
                    "suppresses nothing (known: "
                    f"{', '.join(sorted(all_names))})"
                ),
            ))
        elif not s.reason:
            findings.append(Finding(
                rule=BAD_SUPPRESSION, path=s.path, line=s.line, col=0,
                message=(
                    f"suppression of {', '.join(s.rules)} has no reason — "
                    "grammar: `# lint: ok(<rule>): <why the invariant "
                    "holds here>`"
                ),
            ))
        elif not s.used and all(r in active_names for r in s.rules):
            # Only a FULL-registry run (or one covering every rule the
            # comment names) can prove a suppression stale: under a
            # --rules subset the inactive rule simply never fired.
            findings.append(Finding(
                rule=UNUSED_SUPPRESSION, path=s.path, line=s.line, col=0,
                message=(
                    f"suppression of {', '.join(s.rules)} matches no "
                    "finding — the violation it excused is gone; delete it"
                ),
            ))

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(
        findings=findings,
        files=len(modules),
        elapsed_s=time.perf_counter() - t0,
        rules=[r.name for r in active],
    )


def git_changed_files(root: Path, ref: str) -> Optional[List[str]]:
    """Absolute paths of files changed vs `ref` — working-tree diff plus
    untracked (new files must lint before their first commit). None when
    git is unusable (not a repo, bad ref): callers error loudly, a gate
    that can't see the diff must not read as green. Pure subprocess, so
    the --changed-only fast path never imports anything heavy."""
    import subprocess

    def run(cwd: Path, *cmd: str) -> Optional[str]:
        try:
            proc = subprocess.run(
                ["git", "-C", str(cwd), *cmd],
                capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        return proc.stdout if proc.returncode == 0 else None

    top = run(root, "rev-parse", "--show-toplevel")
    if top is None:
        return None
    repo = Path(top.strip())
    # Both listings must be toplevel-relative to join against `repo`, so
    # both run AT the toplevel: `ls-files --others` always prints
    # cwd-relative paths, and `diff --name-only` does too under
    # `diff.relative=true` (from a `root` deeper in the repo either would
    # silently mis-join and drop every changed file).
    diff = run(repo, "diff", "--name-only", ref)
    untracked = run(repo, "ls-files", "--others", "--exclude-standard")
    if diff is None or untracked is None:
        return None
    names = [
        line.strip()
        for line in (diff + "\n" + untracked).splitlines()
        if line.strip()
    ]
    seen = set()
    out = []
    for n in names:
        p = str(repo / n)
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def render_human(result: LintResult) -> str:
    out = [f.render() for f in result.findings]
    n_bad = len(result.unsuppressed)
    n_sup = len(result.findings) - n_bad
    out.append(
        f"{result.files} files, {len(result.rules)} rules, "
        f"{n_bad} finding{'s' if n_bad != 1 else ''} "
        f"({n_sup} suppressed) in {result.elapsed_s:.2f}s"
    )
    return "\n".join(out)


def write_json(result: LintResult, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result.to_json(), indent=1) + "\n",
                    encoding="utf-8")
