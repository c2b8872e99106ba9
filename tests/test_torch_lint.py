"""The port's invariant lint (distributed_ddpg_tpu_torch/analysis/,
tools/lint.py) against the JAX package's engine and on the port's tree.

- On the JAX package's own fixture trees (tests/lint_fixtures/, read
  only) both engines give the same findings (rule, path, line, col,
  suppressed) for the rules whose idiom both share, and the pseudo-rules.
- The torch-spelling fixtures (tests/torch_lint_fixtures/) give exactly
  the findings their `# expect:` markers name: one for each spelling of a
  collective outside parallel/mesh.py and parallel/multihost.py, none
  inside, one for each literal timedelta deadline.
- The live port tree is clean, its suppressions counted.
- tools.lint and tools.runs load none of torch, jax or the JAX package.
- The repairs the lint's first run over the port led to.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_ddpg_tpu.analysis import run_lint as jax_run_lint
from distributed_ddpg_tpu_torch.analysis import RULES, run_lint
from distributed_ddpg_tpu_torch.analysis.rules import NO_COUNTERPART
from distributed_ddpg_tpu_torch.tools import lint as lint_cli

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
PKG = REPO / "distributed_ddpg_tpu_torch"
JAX_FIX = TESTS / "lint_fixtures"
TORCH_FIX = TESTS / "torch_lint_fixtures" / "collectives"

SHARED_RULES = ("timeout-discipline", "typed-error", "lock-discipline",
                "exit-code-literal", "parse-error", "bad-suppression",
                "unused-suppression")
TREES = ("clean", "dirty", "suppress")
# The port's live tree: 7 typed-error (parallel/mesh.py x6, serve/server.py).
LIVE_SUPPRESSIONS = {"typed-error": 7}

_cache = {}


def _both(tree):
    if tree not in _cache:
        root = JAX_FIX / tree
        docs = root / "docs" if (root / "docs").is_dir() else None
        _cache[tree] = (jax_run_lint(root, docs_root=docs), run_lint(root, docs_root=docs))
    return _cache[tree]


def _keys(result, rule):
    return sorted((f.rule, f.path, f.line, f.col, f.suppressed)
                  for f in result.findings if f.rule == rule)


@pytest.mark.parametrize("rule", SHARED_RULES)
@pytest.mark.parametrize("tree", TREES)
def test_engines_agree_on_jax_fixture_trees(tree, rule):
    theirs, ours = _both(tree)
    assert _keys(ours, rule) == _keys(theirs, rule)


@pytest.mark.parametrize("rule", SHARED_RULES[:4] + ("bad-suppression", "unused-suppression"))
def test_jax_fixtures_exercise_each_shared_rule(rule):
    # The agreement above is not vacuous: every shared rule (parse-error
    # aside, which no JAX fixture exercises) fires somewhere.
    assert any(_keys(_both(t)[1], rule) for t in TREES)


def test_engine_json_schema_matches_jax():
    theirs, ours = _both("dirty")
    a, b = theirs.to_json(), ours.to_json()
    assert set(a) == set(b) and set(a["counts"]) == set(b["counts"])
    assert set(a["findings"][0]) == set(b["findings"][0])


def _expected(root):
    out = set()
    for p in sorted(root.rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            m = re.search(r"# expect: (.*)$", line)
            if m:
                for rule in m.group(1).split(","):
                    out.add((p.relative_to(root).as_posix(), i, rule.strip()))
    return out


def test_torch_spellings_each_give_one_finding():
    res = run_lint(TORCH_FIX)
    got = [(f.path, f.line, f.rule) for f in res.findings]
    assert len(got) == len(set(got))
    assert set(got) == _expected(TORCH_FIX)
    per_file = {f.path for f in res.findings if f.rule == "collective-discipline"}
    assert "parallel/mesh.py" not in per_file and "parallel/multihost.py" not in per_file
    assert sum(1 for f in res.findings if f.rule == "collective-discipline"
               and f.path == "trainer.py") == 19
    assert [f.line for f in res.findings if f.rule == "timeout-discipline"] == [13, 14]


def test_cli_reports_torch_fixtures_and_jax_fixtures(capsys):
    assert lint_cli.main(["--root", str(TORCH_FIX), str(TORCH_FIX), "--quiet"]) == 2
    assert "25 findings" in capsys.readouterr().out
    assert lint_cli.main(["--root", str(JAX_FIX / "clean"), str(JAX_FIX / "clean")]) == 0
    capsys.readouterr()
    rc = lint_cli.main(["--root", str(JAX_FIX / "dirty"), str(JAX_FIX / "dirty"),
                        "--rules", ",".join(SHARED_RULES[:4])])
    assert rc == 2


@pytest.mark.parametrize("rule", sorted(NO_COUNTERPART))
def test_rules_without_counterpart_are_usage_errors(rule, capsys):
    assert lint_cli.main(["--rules", rule]) == 1
    assert "has no counterpart in the port" in capsys.readouterr().err
    assert rule not in {r.name for r in RULES}


def test_live_port_tree_is_clean_with_pinned_suppressions(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert lint_cli.main(["--json", str(out), "--quiet"]) == 0, capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["counts"]["findings"] == 0
    counts = {}
    for f in rep["findings"]:
        assert f["suppressed"] and f["suppression_reason"]
        counts[f["rule"]] = counts.get(f["rule"], 0) + 1
    assert counts == LIVE_SUPPRESSIONS
    assert rep["rules"] == [r.name for r in RULES]


def test_devactor_gather_ms_is_documented():
    # The port-only field has its row in the port's catalog, so the
    # observability rule sees no drift in metrics.py.
    res = run_lint(PKG, docs_root=REPO / "docs", rule_names=["observability-drift"])
    assert res.findings == []
    assert "devactor_gather_ms" in (PKG / "docs" / "ANALYSIS.md").read_text()


def test_tools_import_no_torch_jax_or_jax_package(tmp_path):
    run = tmp_path / "run.jsonl"
    run.write_text(json.dumps({"kind": "final", "step": 1, "learner_steps_per_sec": 2.0}) + "\n")
    code = (
        "import sys, json\n"
        "from distributed_ddpg_tpu_torch.tools import lint, runs\n"
        "rc = lint.main(['--quiet'])\n"
        f"rc2 = runs.main(['summarize', {str(run)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'distributed_ddpg_tpu', 'numpy'))\n"
        "print(json.dumps([rc, rc2, bad]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rc, rc2, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rc, rc2, bad) == (0, 0, [])


def test_sync_ship_single_process_fast_path_and_usage_error():
    # The two results the lint's first run found differing from JAX's
    # (tests/test_torch_multihost.py holds them against JAX's replay).
    import numpy as np

    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay, ReplayUsageError

    rep = DeviceReplay(64, 3, 1, "cpu", block_size=8)
    rep.add_packed(np.ones((11, rep.width), np.float32))
    assert rep.sync_ship(force=True) == 3
    assert (rep.size, rep.pending_rows) == (16, 0)
    with pytest.raises(ReplayUsageError):
        rep.sync_ship_begin()
