"""The port's rule set (distributed_ddpg_tpu_torch/docs/ANALYSIS.md has the
catalog).

Each rule is the counterpart of one of distributed_ddpg_tpu/analysis/
rules.py, applied to the port's tree and its torch idioms. They are
deliberately narrow: each matches the concrete AST shape of the bug class
it guards, not a general style opinion. Two JAX rules have no counterpart
here (donation-safety and recompile-hazard; the catalog says why), and
`NO_COUNTERPART` names them so the CLI can refuse them with the reason.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from distributed_ddpg_tpu_torch.analysis.engine import (
    Finding,
    LintContext,
    Module,
    Rule,
    package_doc_text,
    register,
)

# JAX rules with no port counterpart, and why (the catalog's words).
NO_COUNTERPART: Dict[str, str] = {
    "donation-safety": (
        "the port donates no buffer (torch has no donate_argnums); the "
        "program analyzer's moved-storage check is its runtime counterpart"
    ),
    "recompile-hazard": (
        "the port compiles no trace-cached program (no torch.compile, no "
        "torch.jit), so no jit cache key can churn"
    ),
}

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as 'a.b.c'; None for anything with a
    non-name root (subscripts, calls)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_FOLDABLE_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b if b else None,
}


def numeric_literal(node: ast.AST) -> Optional[float]:
    """The value of a literal int/float expression (incl. unary minus and
    constant-only arithmetic like `10 * 60` — the natural spelling of a
    600 s deadline must not slip past timeout-discipline); None for
    names, calls, and anything genuinely computed."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = numeric_literal(node.operand)
        return None if inner is None else -inner
    if isinstance(node, ast.BinOp):
        fold = _FOLDABLE_BINOPS.get(type(node.op))
        left = numeric_literal(node.left)
        right = numeric_literal(node.right)
        if fold is None or left is None or right is None:
            return None
        return fold(left, right)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return float(node.value)
    return None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _in_package_dirs(relpath: str, dirs: Sequence[str]) -> bool:
    return any(relpath.startswith(d + "/") for d in dirs)


# ---------------------------------------------------------------------------
# 1. collective-discipline (torch spelling)
# ---------------------------------------------------------------------------

# The two modules that may make torch.distributed collective or group
# calls: the rank grid's data plane and the pod's deadline-guarded entry
# points. Everywhere else a raw call is a collective without the group
# views, the timeouts and the typed peer loss these modules give it.
_COLLECTIVE_MODULES = ("parallel/mesh.py", "parallel/multihost.py")
_TORCH_DIST = "torch.distributed"
_COLLECTIVE_CALLS = frozenset({
    "all_reduce", "broadcast", "gather", "scatter", "reduce",
    "send", "recv", "isend", "irecv", "barrier", "monitored_barrier",
    "all_to_all", "all_to_all_single", "batch_isend_irecv",
    "init_process_group", "new_group",
})
_COLLECTIVE_CALL_RE = re.compile(
    r"^(all_gather\w*|reduce_scatter\w*|\w*_object\w*|all_reduce\w*)$"
)


def _is_collective_name(leaf: str) -> bool:
    return leaf in _COLLECTIVE_CALLS or bool(_COLLECTIVE_CALL_RE.match(leaf))


def torch_dist_bindings(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """(module names bound to torch.distributed, {bare name: function})
    from every import in the module: `import torch.distributed as d`,
    `from torch import distributed`, `from torch.distributed import
    all_reduce as ar` all resolve, so no alias smuggles a collective past
    the spelled-out `torch.distributed.all_reduce` match."""
    mods: Set[str] = {_TORCH_DIST}
    direct: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _TORCH_DIST and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module in (_TORCH_DIST, _TORCH_DIST + ".distributed_c10d"):
                for a in node.names:
                    if _is_collective_name(a.name):
                        direct[a.asname or a.name] = a.name
    return mods, direct


def torch_collective(call: ast.Call, mods: Set[str],
                     direct: Dict[str, str]) -> Optional[str]:
    """The torch.distributed function a call resolves to, when it is a
    collective or group call; None otherwise (queries such as
    is_initialized or get_rank, and everything else)."""
    func = call.func
    if isinstance(func, ast.Name):
        return direct.get(func.id)
    name = dotted(func)
    if not name or "." not in name:
        return None
    prefix, leaf = name.rsplit(".", 1)
    if prefix.endswith(".distributed_c10d"):
        prefix = prefix[: -len(".distributed_c10d")]
    if prefix in mods and _is_collective_name(leaf):
        return leaf
    return None


@register
class CollectiveDiscipline(Rule):
    """Every torch.distributed collective or group call must go through
    parallel/mesh.py (the rank grid's data and control planes) or
    parallel/multihost.py (the pod's deadline-guarded, PodPeerLost-typed
    entry points): a raw call anywhere else runs outside the group views
    and without the deadline that turns a dead peer into a clean abort.
    The counterpart of the JAX rule, which confines multihost_utils and
    jax.distributed to parallel/multihost.py. Queries (is_initialized,
    get_rank, get_world_size) stay allowed."""

    name = "collective-discipline"
    doc = (
        "torch.distributed collective and group calls only in "
        "parallel/mesh.py and parallel/multihost.py"
    )

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.rulepath in _COLLECTIVE_MODULES or module.tree is None:
            return
        mods, direct = torch_dist_bindings(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = torch_collective(node, mods, direct)
            if leaf is None:
                continue
            yield module.finding(
                self.name, node,
                f"torch.distributed {leaf}() outside parallel/mesh.py and "
                "parallel/multihost.py — a raw collective runs without the "
                "group views and the deadline that types a dead peer as "
                "PodPeerLost; route it through the mesh or multihost entry "
                "points",
            )


# ---------------------------------------------------------------------------
# 2. timeout-discipline
# ---------------------------------------------------------------------------

# Literals >= this many seconds are deadlines (must be named knobs);
# smaller literals are poll cadences inside re-checking loops, which are
# the documented idiom (prefetch/batcher condvar ticks).
TIMEOUT_LITERAL_FLOOR_S = 1.0

_BLOCKING_ATTRS = ("result", "get", "wait", "join", "sleep")


_TIMEDELTA_UNITS = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0,
                    "days": 86400.0, "milliseconds": 1e-3}


def _timedelta_seconds(node: Optional[ast.expr]) -> Optional[float]:
    """Seconds of a `timedelta(...)` / `datetime.timedelta(...)` call whose
    arguments are all literals (keywords or the leading `days` positional);
    None for anything else, a named or computed span included."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func) or ""
    if name.rsplit(".", 1)[-1] != "timedelta":
        return None
    total = 0.0
    for i, arg in enumerate(node.args):
        v = numeric_literal(arg)
        if v is None or i > 0:
            return None
        total += v * _TIMEDELTA_UNITS["days"]
    for kw in node.keywords:
        v = numeric_literal(kw.value)
        unit = _TIMEDELTA_UNITS.get(kw.arg or "")
        if v is None or unit is None:
            return None
        total += v * unit
    return total


@register
class TimeoutDiscipline(Rule):
    """No inline literal deadline on a blocking wait (a hardcoded
    `ticket.result(timeout=600)` once stalled a wedged pod for 10 silent
    minutes). Deadlines must be named — a config knob, a multihost-derived
    bound (beat_result_timeout_s), or a documented module constant — so
    every wait's budget is auditable in one place. Sub-second literals are
    poll cadences inside re-checking loops and stay allowed. The torch
    spelling of a group's or collective's deadline, a literal
    `datetime.timedelta(seconds=...)` passed as `timeout=`, is an inline
    deadline too."""

    name = "timeout-discipline"
    doc = (
        "no literal timeout >= 1s in .result()/.get()/.wait()/.join()/"
        "time.sleep() or as a literal timedelta timeout= — route through "
        "a named knob"
    )

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.tree is None:
            return
        # Bare-name bindings of the blocking callables (`from time import
        # sleep`, `from concurrent.futures import wait`): same semantics
        # as their attribute forms, same rule.
        bare: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for a in node.names:
                        if a.name == "sleep":
                            bare[a.asname or a.name] = "sleep"
                elif node.module == "concurrent.futures":
                    for a in node.names:
                        if a.name == "wait":
                            bare[a.asname or a.name] = "futures_wait"
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            delta = _timedelta_seconds(keyword_arg(node, "timeout"))
            if delta is not None and delta >= TIMEOUT_LITERAL_FLOOR_S:
                target = dotted(node.func) or "<expr>"
                yield module.finding(
                    self.name, node,
                    f"literal {delta:g}s timedelta timeout in {target}() — "
                    "name it (config knob, "
                    "multihost.beat_result_timeout_s, or a documented "
                    "module constant); inline deadlines are how the "
                    "600s silent stall shipped",
                )
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id in bare:
                sem = bare[func.id]
                kw = keyword_arg(node, "timeout")
                if kw is not None:
                    value = numeric_literal(kw)
                elif sem == "sleep" and node.args:
                    value = numeric_literal(node.args[0])
                elif sem == "futures_wait" and len(node.args) >= 2:
                    value = numeric_literal(node.args[1])
                else:
                    value = None
                if value is not None and value >= TIMEOUT_LITERAL_FLOOR_S:
                    yield module.finding(
                        self.name, node,
                        f"literal {value:g}s timeout in {func.id}() — "
                        "name it (config knob, "
                        "multihost.beat_result_timeout_s, or a documented "
                        "module constant); inline deadlines are how the "
                        "600s silent stall shipped",
                    )
                continue
            if not isinstance(func, ast.Attribute):
                continue
            attr = func.attr
            if attr not in _BLOCKING_ATTRS:
                continue
            value: Optional[float] = None
            kw = keyword_arg(node, "timeout")
            if kw is not None:
                value = numeric_literal(kw)
            elif attr == "get":
                # queue.get's positionals are (block, timeout): the
                # deadline is args[1], and only when args[0] is a literal
                # bool — `d.get(key, default)` must never read as one.
                if len(node.args) >= 2 and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, bool):
                    value = numeric_literal(node.args[1])
            elif node.args:
                value = numeric_literal(node.args[0])
            if value is not None and value >= TIMEOUT_LITERAL_FLOOR_S:
                target = dotted(func) or f"<expr>.{attr}"
                yield module.finding(
                    self.name, node,
                    f"literal {value:g}s timeout in {target}() — name it "
                    "(config knob, multihost.beat_result_timeout_s, or a "
                    "documented module constant); inline deadlines are how "
                    "the 600s silent stall shipped",
                )


# ---------------------------------------------------------------------------
# 2. typed-error
# ---------------------------------------------------------------------------

_TYPED_ERROR_DIRS: Dict[str, str] = {
    "serve": "ServeOverload / ServeDispatchError / ServeTimeout / "
             "ServeGroupLost",
    "transfer": "TransferError",
    "replay": "IngestError / ReplayUsageError",
    "actors": "DeviceActorError / faults.InjectedFault / ValueError",
    "parallel": "PodPeerLost / PrefetchError / PrefetchTimeout",
}


@register
class TypedErrorContract(Rule):
    """Subsystem code may not raise bare RuntimeError/Exception: every
    subsystem has a typed family that callers catch to pick a recovery
    path (degrade-to-local on ServeTimeout, clean pod abort on
    PodPeerLost, bounded restart past IngestError...). A bare
    RuntimeError is caught by nobody's recovery logic and by everybody's
    blanket handler — the worst of both."""

    name = "typed-error"
    doc = (
        "no `raise RuntimeError/Exception` inside serve/, transfer/, "
        "replay/, actors/, parallel/ — use the subsystem's typed family"
    )

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.tree is None:
            return
        subsystem = module.rulepath.split("/", 1)[0]
        family = _TYPED_ERROR_DIRS.get(subsystem)
        if family is None or "/" not in module.rulepath:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = dotted(exc.func) if isinstance(exc, ast.Call) else dotted(exc)
            if name in ("RuntimeError", "Exception"):
                yield module.finding(
                    self.name, node,
                    f"raise {name} in {subsystem}/ — use the subsystem's "
                    f"typed error family ({family}) so recovery paths can "
                    "catch it",
                )


# ---------------------------------------------------------------------------
# 3. lock-discipline
# ---------------------------------------------------------------------------

_LOCK_NAMES = ("dispatch_lock",)
# Host-side blocking waits. torch.cuda.synchronize and Event.synchronize
# take the place of jax.block_until_ready and are deliberately ABSENT:
# holding dispatch_lock across the device barrier is how the ring's
# inserts and the chunks' gathers stay ordered (replay/device.py
# drain_pending).
_LOCK_BLOCKING_ATTRS = ("result", "wait", "join", "sleep")
# The collective entry points: parallel/multihost.py's pod collectives
# and parallel/mesh.py's data- and control-plane collectives.
_COLLECTIVE_ENTRYPOINTS = (
    "allgather_scalar", "allgather_rows", "beat_allgather",
    "call_with_deadline", "startup_barrier", "elect_resume_step",
    "elect_slice_step", "wait_beat_ticket", "clock_handshake", "sync_ship",
    "all_reduce_mean_", "all_reduce_sum_", "all_gather",
    "gather_env_blocks", "share", "share_rows", "replicas_equal",
    "make_grid", "serve_group", "init_data_group",
)


@register
class LockDiscipline(Rule):
    """dispatch_lock serializes device dispatch against the ingest
    shipper's inserts into the ring. Blocking on a host primitive — or worse,
    issuing a pod collective — while holding it deadlocks the trainer the
    first time the other side of the wait needs the lock (and a
    collective under the lock couples a local wedge to every peer's
    deadline). Collectives run BEFORE taking the lock (sync_ship's
    beat_allgather does exactly this)."""

    name = "lock-discipline"
    doc = (
        "no blocking wait (.result/.wait/.join/sleep/queue-shaped .get) "
        "or pod collective under dispatch_lock"
    )

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.tree is None:
            return
        # Dedupe by location: a dispatch_lock `with` nested inside another
        # one is visited both by the outer scan's recursion and by its own
        # ast.walk hit — the same blocking call must report once.
        seen: Set[Tuple[int, int, str]] = set()
        self._mods, self._direct = torch_dist_bindings(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(self._is_dispatch_lock(i.context_expr)
                       for i in node.items):
                continue
            for f in self._scan_block(module, node.body):
                key = (f.line, f.col, f.message)
                if key not in seen:
                    seen.add(key)
                    yield f

    def _is_dispatch_lock(self, expr: ast.expr) -> bool:
        name = dotted(expr)
        if name and any(name == n or name.endswith("." + n)
                        for n in _LOCK_NAMES):
            return True
        # The learner takes the same lock through its helper
        # (parallel/learner.py _ingest_lock(device_replay)).
        if isinstance(expr, ast.Call):
            fname = dotted(expr.func) or ""
            return fname.endswith("_ingest_lock")
        return False

    def _torch_collective(self, call: ast.Call) -> bool:
        return torch_collective(call, self._mods, self._direct) is not None

    def _scan_block(self, module: Module, stmts) -> Iterable[Finding]:
        for stmt in stmts:
            yield from self._scan_node(module, stmt)

    def _scan_node(self, module: Module, node: ast.AST) -> Iterable[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # deferred execution: not under the lock
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            is_block = False
            bound: Optional[float] = None
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                kw = keyword_arg(node, "timeout")
                if attr in _LOCK_BLOCKING_ATTRS:
                    is_block = True
                    bound = numeric_literal(kw) if kw is not None else (
                        numeric_literal(node.args[0]) if node.args else None
                    )
                elif attr == "get":
                    # queue.get shapes only — a bare call, a literal-bool
                    # block flag, or keyword-only args. dict.get(key, ...)
                    # always passes a non-bool key first and never waits.
                    bool_flag = bool(
                        node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, bool)
                    )
                    is_block = not node.args or bool_flag
                    if bool_flag and node.args[0].value is False:
                        is_block = False  # block=False: a poll
                    blk = keyword_arg(node, "block")
                    if isinstance(blk, ast.Constant) and blk.value is False:
                        is_block = False
                    if kw is not None:
                        bound = numeric_literal(kw)
                    elif bool_flag and len(node.args) >= 2:
                        bound = numeric_literal(node.args[1])
            if is_block:
                # .result(timeout=0.0) / .get(timeout=0.0) is a poll.
                if bound is None or bound != 0.0:
                    yield module.finding(
                        self.name, node,
                        f"blocking {name or leaf}() under dispatch_lock — "
                        "the shipper/learner on the other side of this "
                        "wait needs the lock; wait outside the critical "
                        "section",
                    )
            elif leaf in _COLLECTIVE_ENTRYPOINTS or \
                    name.startswith("multihost.") or \
                    self._torch_collective(node):
                yield module.finding(
                    self.name, node,
                    f"collective {name or leaf}() under dispatch_lock "
                    "— a peer-coupled wait under a local lock wedges "
                    "the pod; gather first, then take the lock "
                    "(sync_ship's beat_allgather ordering)",
                )
        for child in ast.iter_child_nodes(node):
            yield from self._scan_node(module, child)


# ---------------------------------------------------------------------------
# 4. observability-drift
# ---------------------------------------------------------------------------

_FIELD_RE = re.compile(r"^[a-z][a-z0-9_]*_[a-z0-9_]+$")


def _doc_field_patterns(doc_text: str) -> List[re.Pattern]:
    """Compile the doc's field tokens into matchers. Tokens may use the
    doc shorthand `a_b_c/d/e` (suffix alternatives) and `<cls>` template
    segments (match any one field segment)."""
    patterns: List[re.Pattern] = []
    for token in re.findall(r"[a-z][a-z0-9_/<>]*", doc_text):
        for cand in _expand_slash(token):
            if "<" in cand:
                rx = re.escape(cand)
                # re.escape stopped escaping <> in Python 3.7: accept the
                # template marker with or without the backslashes.
                rx = re.sub(r"\\?<[a-z_]+\\?>", r"[a-z0-9_]+", rx)
                patterns.append(re.compile(rx + r"$"))
    return patterns


def _expand_slash(token: str) -> List[str]:
    """`a_b_c/d/e` → [a_b_c, a_b_d, a_b_e]: each alternative replaces the
    base's LAST segment, whatever its own segment count — the doc row
    `transfer_pool_buffers/fence_waits` covers transfer_pool_fence_waits."""
    if "/" not in token:
        return [token]
    parts = token.split("/")
    base = parts[0]
    out = [base]
    segs = base.split("_")
    for p in parts[1:]:
        if not p:
            continue
        out.append("_".join(segs[:-1] + [p]) if len(segs) > 1 else p)
    return out


def _doc_mentions(field: str, plain_tokens: Set[str],
                  patterns: List[re.Pattern]) -> bool:
    if field in plain_tokens:
        return True
    return any(p.match(field) for p in patterns)


@register
class ObservabilityDrift(Rule):
    """The metrics schema, its documentation, and its renderer must move
    together: every field family a `*Stats` class emits in metrics.py
    needs a row in docs/OBSERVABILITY.md (or, for a field only the port
    has, in the port's catalog, docs/ANALYSIS.md inside the package) and a
    renderer reference in tools/runs.py — an undocumented counter is
    write-only telemetry.
    Folded in: every fault component registered in faults.py must appear
    in docs/RESILIENCE.md's failure matrix, so the chaos grammar and the
    recovery documentation cannot diverge."""

    name = "observability-drift"
    doc = (
        "metrics.py *Stats fields must appear in docs/OBSERVABILITY.md "
        "and tools/runs.py; faults.py components must appear in "
        "docs/RESILIENCE.md's failure matrix"
    )

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        yield from self._check_stats_fields(ctx)
        yield from self._check_fault_components(ctx)

    # -- metrics fields ------------------------------------------------

    def _check_stats_fields(self, ctx: LintContext) -> Iterable[Finding]:
        metrics = ctx.module("metrics.py")
        if metrics is None or metrics.tree is None or ctx.docs_root is None:
            # No docs tree at all (bare file set): doc-coupled checks stay
            # silent — only a MISSING file inside an existing docs dir is
            # a finding.
            return
        doc_text = ctx.doc_text("OBSERVABILITY.md")
        runs = ctx.module("tools/runs.py")
        if doc_text is None:
            yield Finding(
                rule=self.name, path=metrics.relpath, line=1, col=0,
                message="docs/OBSERVABILITY.md not found next to the "
                        "package — the JSONL schema has no documentation "
                        "to check against",
            )
            return
        doc_text += "\n" + package_doc_text(metrics, "ANALYSIS.md")
        plain_tokens = {
            t for tok in re.findall(r"[a-z][a-z0-9_/<>]*", doc_text)
            for t in _expand_slash(tok) if "<" not in t
        }
        patterns = _doc_field_patterns(doc_text)
        runs_text = runs.text if runs is not None else ""

        for cls in metrics.tree.body:
            if not isinstance(cls, ast.ClassDef) or \
                    not cls.name.endswith("Stats"):
                continue
            fields = self._snapshot_fields(cls)
            families: Set[str] = set()
            for field, node in fields:
                families.add(field.split("_", 1)[0] + "_")
                if not _doc_mentions(field, plain_tokens, patterns):
                    # exact: the snapshot dict is ONE simple statement —
                    # statement-span suppression matching would let a
                    # single per-field escape cover every sibling field's
                    # future drift. The comment must sit on the key's line.
                    yield metrics.finding(
                        self.name, node,
                        f"{cls.name} emits `{field}` but "
                        "docs/OBSERVABILITY.md has no row for it — "
                        "document the field (or its `<cls>` template) in "
                        "the JSONL schema table",
                        exact=True,
                    )
            for fam in sorted(families):
                if runs_text and fam not in runs_text:
                    # Anchored to the class HEADER line only (not the
                    # ClassDef's full span): a field-level suppression
                    # inside the body must never mask this class-level
                    # finding via span matching.
                    yield Finding(
                        rule=self.name, path=metrics.relpath,
                        line=cls.lineno, col=cls.col_offset,
                        message=(
                            f"{cls.name}'s `{fam}*` family has no renderer "
                            "reference in tools/runs.py — summarize/compare "
                            "would silently drop the whole family"
                        ),
                    )

    def _snapshot_fields(self, cls: ast.ClassDef) -> List[Tuple[str, ast.AST]]:
        """Literal string keys of dicts built inside the class's
        snapshot() method — the emitted JSONL field names. f-string keys
        (per-class templates) are covered by the doc's `<cls>` rows and
        skipped here."""
        out: List[Tuple[str, ast.AST]] = []
        for item in cls.body:
            if isinstance(item, ast.FunctionDef) and item.name == "snapshot":
                for node in ast.walk(item):
                    if isinstance(node, ast.Dict):
                        for k in node.keys:
                            if isinstance(k, ast.Constant) and \
                                    isinstance(k.value, str) and \
                                    _FIELD_RE.match(k.value):
                                out.append((k.value, k))
                    elif isinstance(node, ast.Subscript) and \
                            isinstance(node.ctx, ast.Store) and \
                            isinstance(node.slice, ast.Constant) and \
                            isinstance(node.slice.value, str) and \
                            _FIELD_RE.match(node.slice.value):
                        out.append((node.slice.value, node))
        return out

    # -- fault components ----------------------------------------------

    def _check_fault_components(self, ctx: LintContext) -> Iterable[Finding]:
        faults = ctx.module("faults.py")
        if faults is None or faults.tree is None or ctx.docs_root is None:
            return
        doc_text = ctx.doc_text("RESILIENCE.md")
        components: List[Tuple[str, ast.AST]] = []
        for node in faults.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "COMPONENTS"
                for t in node.targets
            ):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) and \
                                isinstance(el.value, str):
                            components.append((el.value, el))
        if not components:
            return
        if doc_text is None:
            yield Finding(
                rule=self.name, path=faults.relpath, line=1, col=0,
                message="docs/RESILIENCE.md not found — the fault grammar "
                        "has no failure matrix to check against",
            )
            return
        # The matrix section: from its heading to the next same-level one.
        m = re.search(r"^## Failure matrix.*?(?=^## )", doc_text,
                      re.MULTILINE | re.DOTALL)
        matrix = m.group(0) if m else doc_text
        for comp, node in components:
            if not re.search(rf"\b{re.escape(comp)}\s*:", matrix):
                # exact, like the snapshot-field findings: COMPONENTS is
                # one tuple statement — a suppression on one entry's line
                # must not cover its siblings.
                yield faults.finding(
                    self.name, node,
                    f"fault component `{comp}` (faults.py COMPONENTS) has "
                    "no `"
                    f"{comp}:...` spec row in docs/RESILIENCE.md's "
                    "failure matrix — every injectable fault needs its "
                    "detection/recovery/artifact row",
                    exact=True,
                )


# ---------------------------------------------------------------------------
# 5. exit-code-literal
# ---------------------------------------------------------------------------

# The typed codes (exits.py). Untyped statuses (sys.exit(1), argparse's
# 2) are not the contract's business and stay unflagged.
_TYPED_EXIT_CODES = frozenset({70, 75, 76, 77, 78, 79})
_EXITS_MODULE = "exits.py"
_EXIT_CALL_LEAVES = ("exit", "_exit", "SystemExit")


@register
class ExitCodeLiteral(Rule):
    """The typed exit codes (70/75/76/77/78/79) are a cross-process
    CONTRACT: train, the watchdog, the chaos children, and the pod
    supervisor all key recovery decisions off them (docs/RESILIENCE.md
    exit-code matrix). Before exits.py they lived as scattered literals
    — and one drifted copy turns a shrink-ready exit (relaunch smaller,
    adopt the slices) into an unknown crash (relaunch blindly). Every
    typed exit must go through the distributed_ddpg_tpu_torch.exits constants;
    only exits.py itself may spell the numbers."""

    name = "exit-code-literal"
    doc = (
        "no bare typed exit-code literal (70/75/76/77/78/79) in "
        "sys.exit/os._exit/SystemExit or EXIT_*-named assignments "
        "outside exits.py — import distributed_ddpg_tpu_torch.exits"
    )

    def check_module(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if module.tree is None or module.rulepath == _EXITS_MODULE:
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                leaf = name.rsplit(".", 1)[-1]
                if leaf not in _EXIT_CALL_LEAVES or not node.args:
                    continue
                val = node.args[0]
                if (
                    isinstance(val, ast.Constant)
                    and isinstance(val.value, int)
                    and not isinstance(val.value, bool)
                    and val.value in _TYPED_EXIT_CODES
                ):
                    yield module.finding(
                        self.name, node,
                        f"bare typed exit code {val.value} in "
                        f"{name or leaf}() — import the named constant "
                        "from distributed_ddpg_tpu_torch.exits "
                        "(docs/RESILIENCE.md exit-code matrix)",
                    )
            elif isinstance(node, ast.Assign):
                val = node.value
                if not (
                    isinstance(val, ast.Constant)
                    and isinstance(val.value, int)
                    and not isinstance(val.value, bool)
                    and val.value in _TYPED_EXIT_CODES
                ):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and "EXIT" in tgt.id.upper():
                        yield module.finding(
                            self.name, node,
                            f"local exit-code constant {tgt.id} = "
                            f"{val.value} shadows the one-place contract "
                            "— import it from distributed_ddpg_tpu_torch.exits",
                        )
