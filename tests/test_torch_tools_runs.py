"""The port's tools.runs (distributed_ddpg_tpu_torch/tools/runs.py) against
the JAX package's on the same inputs: summarize, compare, gate, lint and
programs print byte for byte what the JAX tool prints, with the same exit
code, over the repo's runs/*.jsonl, a JSONL written by the port's
MetricsLogger, the BENCH_r*.json driver records, both lint engines'
findings JSON and the port analyzer's report; merge-trace over two traces
written by the port's trace.py gives the JAX tool's merged events.
"""

import json
from pathlib import Path

import pytest
import torch

from distributed_ddpg_tpu.tools import runs as jax_runs
from distributed_ddpg_tpu_torch.tools import runs as port_runs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUNS = REPO / "runs"
JSONL = ("r3_cheetah_jax.jsonl", "r3_ondevice_pendulum.jsonl", "r3_staleness_ratio1.jsonl",
         "r4_d4pg_pendulum.jsonl", "r3_ladder.jsonl")


def _both(argv, capsys):
    out = []
    for mod in (jax_runs, port_runs):
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out))
    return out


@pytest.fixture(scope="module")
def port_jsonl(tmp_path_factory):
    """A run the port's MetricsLogger writes: its header, train records
    with phase timings and ingest fields, an eval and the final record."""
    from distributed_ddpg_tpu_torch.metrics import MetricsLogger

    path = tmp_path_factory.mktemp("port") / "port_run.jsonl"
    log = MetricsLogger(str(path), echo=False, header={"replay_sharding": "replicated"})
    for i in range(1, 6):
        log.log("train", 800 * i, learner_steps_per_sec=8000.0 + 11 * i,
                env_steps_per_sec=900.0 + i, critic_loss=1.0 / i, t_dispatch_ms=4.0 + i,
                t_dispatch_p95=9.0 + i, n_dispatch=10, t_ingest_ms=0.5, n_ingest=10,
                ingest_rows_per_sec=2000.0 + i, ingest_ship_calls=i, transfer_ingest_items=i)
    log.log("eval", 4000, eval_return=-300.5)
    log.log("final", 4000, learner_steps_per_sec=8044.0, final_return=-300.5,
            actor_respawns=0, ckpt_write_retries=0)
    log.close()
    return path


@pytest.mark.parametrize("name", JSONL)
def test_summarize_matches_jax(name, capsys):
    (rc_a, a), (rc_b, b) = _both(["summarize", str(RUNS / name)], capsys)
    assert rc_a == rc_b == 0 and a == b and a


def test_summarize_json_and_port_jsonl_match_jax(port_jsonl, capsys):
    for argv in (["summarize", str(port_jsonl)], ["summarize", "--json", str(port_jsonl)],
                 ["summarize", str(port_jsonl), str(RUNS / JSONL[0])]):
        (rc_a, a), (rc_b, b) = _both(argv, capsys)
        assert rc_a == rc_b == 0 and a == b and a


@pytest.mark.parametrize("pair", [(0, 1), (2, 3), (3, 2)])
def test_compare_matches_jax(pair, capsys):
    a_path, b_path = (str(RUNS / JSONL[i]) for i in pair)
    (rc_a, a), (rc_b, b) = _both(["compare", a_path, b_path], capsys)
    assert rc_a == rc_b and a == b and a


@pytest.mark.parametrize("pair", [("BENCH_r01.json", "BENCH_r02.json"),
                                  ("BENCH_r04.json", "BENCH_r05.json"),
                                  ("BENCH_r05.json", "BENCH_r01.json")])
def test_gate_matches_jax(pair, capsys):
    argv = ["gate", str(REPO / pair[0]), str(REPO / pair[1])]
    (rc_a, a), (rc_b, b) = _both(argv, capsys)
    assert rc_a == rc_b and a == b and a


def test_gate_with_threshold_and_keys_matches_jax(capsys):
    argv = ["gate", str(REPO / "BENCH_r03.json"), str(REPO / "BENCH_r04.json"),
            "--threshold", "0.05"]
    (rc_a, a), (rc_b, b) = _both(argv, capsys)
    assert rc_a == rc_b and a == b


def _lint_jsons(tmp_path):
    """Both engines' findings JSON: the JAX engine on its dirty fixture
    tree, the port's on its torch-spelling fixtures and its live tree."""
    from distributed_ddpg_tpu.analysis import run_lint as jax_lint
    from distributed_ddpg_tpu.analysis.engine import write_json as jax_write
    from distributed_ddpg_tpu_torch.analysis import run_lint
    from distributed_ddpg_tpu_torch.analysis.engine import write_json

    fix = REPO / "tests" / "lint_fixtures" / "dirty"
    out = {}
    jax_write(jax_lint(fix, docs_root=fix / "docs"), tmp_path / "jax.json")
    out["jax"] = tmp_path / "jax.json"
    write_json(run_lint(REPO / "tests" / "torch_lint_fixtures" / "collectives"),
               tmp_path / "port_fixtures.json")
    out["port_fixtures"] = tmp_path / "port_fixtures.json"
    write_json(run_lint(REPO / "distributed_ddpg_tpu_torch", docs_root=REPO / "docs"),
               tmp_path / "port_live.json")
    out["port_live"] = tmp_path / "port_live.json"
    return out


@pytest.mark.parametrize("which", ["jax", "port_fixtures", "port_live"])
def test_lint_render_matches_jax(which, tmp_path, capsys):
    path = _lint_jsons(tmp_path)[which]
    (rc_a, a), (rc_b, b) = _both(["lint", str(path)], capsys)
    assert rc_a == rc_b and a == b and a
    if which == "port_fixtures":
        assert rc_a == 2
    if which == "port_live":
        assert rc_a == 0


@pytest.mark.parametrize("which", ["clean", "findings"])
def test_programs_render_matches_jax(which, tmp_path, capsys):
    from distributed_ddpg_tpu_torch.tools import proganalyze

    fix = str(REPO / "tests" / "torch_program_fixtures.py")
    out = tmp_path / "programs.json"
    spec = "clean_specs" if which == "clean" else "collective_specs_v2"
    if which == "findings":
        proganalyze.main(["--device", "cpu", "--specs", f"{fix}:collective_specs_v1",
                          "--golden", str(tmp_path / "g"), "--update-golden"])
    proganalyze.main(["--device", "cpu", "--specs", f"{fix}:{spec}", "--golden",
                      str(tmp_path / "g"), "--json", str(out)]
                     + (["--update-golden"] if which == "clean" else []))
    capsys.readouterr()
    (rc_a, a), (rc_b, b) = _both(["programs", str(out)], capsys)
    assert rc_a == rc_b == (0 if which == "clean" else 2) and a == b and a


def test_merge_trace_matches_jax_on_port_traces(tmp_path, capsys):
    from distributed_ddpg_tpu_torch.trace import TraceRecorder

    paths = []
    for host in range(2):
        rec = TraceRecorder()
        rec.set_meta(process_index=host, clock_offset_ms=0.25 * host)
        for i in range(3 + host):
            with rec.span("chunk", step=i):
                pass
            rec.instant("beat", n=i)
        p = tmp_path / f"trace_node{host}.json"
        rec.export(str(p))
        paths.append(str(p))
    n_in = sum(len(json.loads(Path(p).read_text())["traceEvents"]) for p in paths)
    outs = []
    for mod, name in ((jax_runs, "jax.json"), (port_runs, "port.json")):
        out = tmp_path / name
        assert mod.main(["merge-trace", *paths, "--out", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    capsys.readouterr()
    assert outs[0] == outs[1]
    # Every input event, plus each input's two track-metadata events.
    assert len(outs[1]["traceEvents"]) == n_in + 2 * len(paths)
