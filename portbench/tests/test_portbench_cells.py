"""A cell is found by its name, with everything of it in data files, and
``BENCHMARK.json`` keeps to the form of its contract."""

import json
import re

import pytest

from pbcore import cells
from tiny import plug_tree

MANIFEST = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_loads_by_name(workload):
    cell = cells.load(workload)
    assert cell.traffic["loop"] in ("fit", "sweep")
    assert cell.chips in (1, 4)
    assert set(cell.limits) and all(isinstance(v, (int, float)) for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in names


def test_a_split_metric_falls_back_to_its_base_reader(tmp_path, monkeypatch):
    assert cells.reader("device_idle_pct.fit").__code__.co_filename.endswith(
        "device_idle_pct.py")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "m.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "metrics" / "m.b.py").write_text("def read(run):\n    return 2\n")
    monkeypatch.setattr(cells, "BENCH", tmp_path)
    assert cells.reader("m.a")(None) == 1 and cells.reader("m.b")(None) == 2
    with pytest.raises(FileNotFoundError):
        cells.reader("n.a")


def test_overrides_replace_entries_of_the_files():
    cell = cells.load("tsunami64.fit", {"config": {"fit": {"n_tries": 2}}})
    assert cell.config["fit"] == {"n_tries": 2}
    assert cells.load("tsunami64.fit").config["fit"]["n_tries"] == 15


def test_a_cell_added_by_data_alone(tmp_path, monkeypatch):
    manifest = dict(MANIFEST)
    manifest["workloads"] = MANIFEST["workloads"] + [
        {"name": "tsunami64.other", "config": "tsunami64", "traffic": "fit", "chips": 1,
         "why": "x"}]
    with pytest.raises(FileNotFoundError):   # its limits are a file of its own
        cells.load("tsunami64.other", manifest=manifest)
    with pytest.raises(KeyError):
        cells.load("no.such.cell")
    # a configuration of its own: its file, generator, reference, traffic
    # and limits, each a new file of a benchmark tree that holds no other
    plug_tree(tmp_path)
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    monkeypatch.setattr(cells, "BENCH", tmp_path / "portbench")
    for workload, loop in (("plug.fit", "fit"), ("plug.sweep", "sweep")):
        cell = cells.load(workload)
        assert cell.traffic["loop"] == loop and cell.config["name"] == "plug"
        assert cells.generator(cell.config).__name__ == "portbench_generators_plug_gen"
        assert cells.reference(cell.config).__name__ == "portbench_reference_plug_ref"
    with pytest.raises(FileNotFoundError):   # a generator is a file of its own
        cells.generator(cells.load("plug.fit", {"config": {"data": {"generator": "tsunami"}}})
                        .config)


def test_manifest_form():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for entry in MANIFEST["configs"] + MANIFEST["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in MANIFEST["configs"]:
        assert (cells.ROOT / c["file"]).is_file()
        assert json.loads((cells.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
