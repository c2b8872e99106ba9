"""The port's program-contract analyzer (distributed_ddpg_tpu_torch/
analysis/programs.py, tools/proganalyze.py) on the CPU.

- The live specs match tests/golden_programs_torch/, and guarded and
  unguarded variants share their collective order, but for the one pair
  whose routes differ on ranks.
- Fingerprints are order-sensitive.
- On alternate registries (tests/torch_program_fixtures.py) with golden
  directories of their own, never the live one, each seeded fault drives
  exit 2: a reordered collective, an added or undeclared host read, a
  moved leaf, a missing golden, a stale golden, a build error, a beat
  group that disagrees.
- --update-golden round-trips.
- The CLI runs on the card unless asked for the CPU, and without a card
  that is a usage error.
- Every JAX golden name has a port golden or a catalog entry.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from distributed_ddpg_tpu_torch.analysis import programs as prog_lib
from distributed_ddpg_tpu_torch.tools import proganalyze as prog_cli

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
GOLDEN = TESTS / "golden_programs_torch"
JAX_GOLDEN = TESTS / "golden_programs"
FIXMOD = str(TESTS / "torch_program_fixtures.py")


def cli(args, tmp_path, name="report.json"):
    out = tmp_path / name
    rc = prog_cli.main(["--json", str(out), "--device", "cpu", *args])
    return rc, json.loads(out.read_text(encoding="utf-8"))


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    import torch.distributed as dist

    assert not dist.is_initialized()
    rc, rep = cli([], tmp_path_factory.mktemp("live"))
    # The analyzer leaves the process as it found it.
    assert not dist.is_initialized()
    return rc, rep


def test_live_tree_clean_with_committed_goldens(live):
    rc, rep = live
    assert rc == 0, rep["findings"]
    names = {p["name"] for p in rep["programs"]}
    assert names == {p.stem for p in GOLDEN.glob("*.json")}
    assert len(names) == 45
    assert all(p["device"] == "cpu" for p in rep["programs"])


def test_guarded_and_unguarded_variants_share_collective_order(live):
    _, rep = live
    by_name = {p["name"]: p for p in rep["programs"]}
    pairs = [(n, n.replace(".guarded", "")) for n in by_name if n.endswith(".guarded")]
    assert len(pairs) == 13
    split = []
    for guarded, plain in pairs:
        g, u = by_name[guarded], by_name[plain]
        if g["beat_group"] == u["beat_group"]:
            assert g["collectives"] == u["collectives"], guarded
        else:
            assert g["collectives"] != u["collectives"], guarded
            split.append(plain)
    # On two ranks the unguarded uniform chunk is the mesh launch (one
    # all-reduce a chunk), its guarded twin the scan route (one a step):
    # the one pair that cannot share a beat group (the catalog's fork).
    assert split == ["learner.chunk.uniform"]
    assert by_name["learner.chunk.uniform"]["collectives"] == ["allreduce_[2,sum,float32]"]


def test_programs_issue_collectives_on_the_probe(live):
    # The 2-rank and (2, 2) probes are real groups: every learner chunk,
    # beat and superstep and the rollout exchange rows, and serving alone
    # stays collective-free on one device.
    _, rep = live
    by_name = {p["name"]: p for p in rep["programs"]}
    for name, p in by_name.items():
        if name.startswith(("learner", "megastep", "superstep")):
            assert p["collectives"], name
    assert by_name["serve.apply.jax"]["collectives"] == []
    assert by_name["devactor.rollout"]["collectives"] == ["allreduce_[2,sum,float32]"]


def test_goldens_name_their_probe_and_device_entries():
    # Each golden holds the CPU's and the card's host reads (the card's
    # from the analyzer's run on cuda:0) and says why wherever the two
    # differ; the moved leaves are one list, the same on both.
    notes = 0
    for p in GOLDEN.glob("*.json"):
        g = json.loads(p.read_text())
        assert g["probe"] == "fake" and g["program"] == p.stem
        assert set(g["host_reads"]) == {"cpu", "cuda"}
        assert isinstance(g["moved"], list) and g["moved"] == sorted(g["moved"])
        assert g["fingerprint"] == prog_lib.fingerprint(g["collectives"])
        differ = g["host_reads"]["cpu"] != g["host_reads"]["cuda"]
        assert bool(g.get("device_note")) == differ, p.stem
        notes += differ
    assert notes == 13


def test_every_spec_module_is_watched_by_changed_only():
    module_files = {m.replace(".", "/") + ".py" for m in prog_lib.SPEC_MODULES}
    assert module_files == set(prog_cli._OWNER_FILES)
    for spec in prog_lib.default_specs():
        assert "distributed_ddpg_tpu_torch/" + spec.owner in module_files, spec.name


def test_every_jax_golden_name_has_a_port_golden_or_catalog_entry():
    jax_names = {p.stem for p in JAX_GOLDEN.glob("*.json")}
    port_names = {p.stem for p in GOLDEN.glob("*.json")}
    assert jax_names - port_names <= set(prog_lib.NO_PORT_PROGRAM)
    assert set(prog_lib.NO_PORT_PROGRAM) <= jax_names


def test_fingerprint_is_order_sensitive():
    a = ["allreduce_[2,sum,float32]", "broadcast_[2,float32]"]
    assert prog_lib.fingerprint(a) != prog_lib.fingerprint(a[::-1])
    assert prog_lib.fingerprint(a) == prog_lib.fingerprint(list(a))
    assert prog_lib.fingerprint([]) != prog_lib.fingerprint(a[:1])


# (golden registry, check registry, the finding's check) for each fault;
# "self": the golden is the checked registry's own.
FAULTS = {
    "reordered-collective": ("collective_specs_v1", "collective_specs_v2", "collective-order"),
    "added-host-read": ("read_specs_v1", "read_specs_v2", "host-read"),
    "undeclared-host-read": ("self", "undeclared_read_specs", "host-read"),
    "moved-leaf": ("moved_specs_v1", "moved_specs_v2", "moved-storage"),
    "missing-golden": (None, "clean_specs", "collective-order"),
    "build-error": (None, "broken_build_specs", "build-error"),
    "beat-group": ("self", "beat_group_specs", "beat-group"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_seeded_fault_exits_2(fault, tmp_path, capsys):
    first, second, check = FAULTS[fault]
    golden = tmp_path / "golden"
    if first == "self":
        # The golden of the faulty registry itself: only the fault remains.
        cli(["--specs", f"{FIXMOD}:{second}", "--golden", str(golden), "--update-golden"],
            tmp_path, "first.json")
    elif first is not None:
        rc, _ = cli(["--specs", f"{FIXMOD}:{first}", "--golden", str(golden),
                     "--update-golden"], tmp_path, "first.json")
        assert rc == 0
        assert cli(["--specs", f"{FIXMOD}:{first}", "--golden", str(golden)],
                   tmp_path, "again.json")[0] == 0
    rc, rep = cli(["--specs", f"{FIXMOD}:{second}", "--golden", str(golden)], tmp_path)
    assert rc == 2
    assert [f["check"] for f in rep["findings"]] == [check]
    assert "proganalyze: FAIL" in capsys.readouterr().err


def test_stale_golden_exits_2(tmp_path):
    golden = tmp_path / "golden"
    assert cli(["--specs", f"{FIXMOD}:clean_specs", "--golden", str(golden),
                "--update-golden"], tmp_path)[0] == 0
    shutil.copy(golden / "fixture.clean.json", golden / "fixture.retired.json")
    rc, rep = cli(["--specs", f"{FIXMOD}:clean_specs", "--golden", str(golden)], tmp_path)
    assert rc == 2
    assert [(f["program"], f["check"]) for f in rep["findings"]] == [
        ("fixture.retired", "stale-golden")]


def test_update_golden_roundtrip(tmp_path):
    golden = tmp_path / "golden"
    spec = f"{FIXMOD}:clean_specs"
    rc, rep = cli(["--specs", spec, "--golden", str(golden), "--update-golden"], tmp_path)
    assert rc == 0 and rep["updated"] == ["fixture.clean"]
    g = json.loads((golden / "fixture.clean.json").read_text())
    assert g["collectives"] == ["allreduce_[2,sum,float32]", "broadcast_[2,float32]"]
    assert g["host_reads"] == {"cpu": 0} and g["moved"] == []
    # A second update changes nothing; a check agrees.
    assert cli(["--specs", spec, "--golden", str(golden), "--update-golden"],
               tmp_path)[1]["updated"] == []
    assert cli(["--specs", spec, "--golden", str(golden)], tmp_path)[0] == 0
    # A tampered golden gates; the update rewrites it and prunes a stale one.
    g["collectives"] = g["collectives"][::-1]
    (golden / "fixture.clean.json").write_text(json.dumps(g))
    (golden / "fixture.gone.json").write_text("{}")
    assert cli(["--specs", spec, "--golden", str(golden)], tmp_path)[0] == 2
    rc, rep = cli(["--specs", spec, "--golden", str(golden), "--update-golden"], tmp_path)
    assert rc == 0 and rep["updated"] == ["fixture.clean", "-fixture.gone"]
    assert not (golden / "fixture.gone.json").exists()
    assert cli(["--specs", spec, "--golden", str(golden)], tmp_path)[0] == 0


def test_another_devices_entries_survive_an_update(tmp_path):
    golden = tmp_path / "golden"
    spec = f"{FIXMOD}:clean_specs"
    cli(["--specs", spec, "--golden", str(golden), "--update-golden"], tmp_path)
    p = golden / "fixture.clean.json"
    g = json.loads(p.read_text())
    g["host_reads"]["cuda"] = 3
    g["device_note"] = "a fixture's note"
    p.write_text(json.dumps(g))
    assert cli(["--specs", spec, "--golden", str(golden), "--update-golden"], tmp_path)[0] == 0
    g2 = json.loads(p.read_text())
    assert g2["host_reads"] == {"cpu": 0, "cuda": 3} and g2["moved"] == []
    assert g2["device_note"] == "a fixture's note"
    # A new collective order drops them.
    g2["collectives"] = g2["collectives"][::-1]
    p.write_text(json.dumps(g2))
    assert cli(["--specs", spec, "--golden", str(golden), "--update-golden"], tmp_path)[0] == 0
    g3 = json.loads(p.read_text())
    assert g3["host_reads"] == {"cpu": 0} and "device_note" not in g3


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, capsys):
    # No --device: the card; without one that is a usage error (exit 1),
    # never a quiet run on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = f"{FIXMOD}:clean_specs"
    assert prog_cli.main(["--specs", spec, "--golden", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "torch.cuda.is_available() is False" in err and "--device cpu" in err
    assert not list(tmp_path.iterdir())
    assert cli(["--specs", spec, "--golden", str(tmp_path), "--update-golden"],
               tmp_path / "r")[0] == 0


def test_usage_errors(tmp_path, capsys):
    assert prog_cli.main(["--specs", f"{FIXMOD}:no_such_registry"]) == 1
    assert prog_cli.main(["--specs", f"{FIXMOD}:clean_specs", "--golden", str(tmp_path),
                          "--programs", "nothing.*"]) == 1
    assert "match no registered program" in capsys.readouterr().err


def test_list_prints_every_program(capsys):
    assert prog_cli.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 45
    assert any("[beat:learner-beat-uniform]" in line for line in lines)


def test_probe_refuses_a_group_of_another_backend(tmp_path):
    # The probe is chosen by the spec and never shares a foreign group:
    # with no group initialized it starts the fake one and ends it.
    import torch.distributed as dist

    g = prog_lib.probe_group("cpu")
    assert (g.world_size, dist.get_backend()) == (2, "fake")
    assert prog_lib.probe_group("cpu", 2).world_size == 4
    prog_lib.end_probe()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(prog_lib.ProgramBuildError, match="a gloo process group"):
            prog_lib.probe_group("cpu")
    finally:
        dist.destroy_process_group()
