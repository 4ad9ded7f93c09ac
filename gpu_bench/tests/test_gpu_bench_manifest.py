"""``BENCHMARK.json`` against the benchmark's contract, and a cell added as
files alone found by name."""

import json
import re
import shutil

import pytest

from gpu_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_names_units_and_text(bench):
    for entry in metrics(bench) + bench["workloads"] + bench["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for m in metrics(bench):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in metrics(bench)]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert m["moves"] in {x["name"] for x in manifest.load_cell(cell, bench).end_to_end}


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"], bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]).read)
        assert manifest.driver(cell).Session.KIND in manifest.reference(cell).LIMITS


def test_every_configuration_has_a_cell_and_its_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"] == f"gpu_bench/configs/{c['name']}.json"
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(data["reduced"])
        assert (manifest.HERE / "configs" / f"{c['name']}_flops.py").is_file()
        assert (manifest.HERE / "reference" / f"{c['name']}.py").is_file()


def test_run_length_and_paths(bench):
    assert bench["paths"] == ["gpu_bench"] and 1 <= bench["run_seconds"] <= 51
    assert bench["command"][:3] == ["python3", "-m", "gpu_bench.run"]
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_a_cell_added_as_files_alone_is_found_by_name(bench, tmp_path):
    here = tmp_path / "gpu_bench"
    for part in ("configs", "traffic"):
        shutil.copytree(manifest.HERE / part, here / part)
    traffic = json.loads((here / "traffic" / "eval-b16.json").read_text())
    traffic["config"]["test_episode_size"] = 8
    (here / "traffic" / "eval-b8.json").write_text(json.dumps(traffic))
    grown = json.loads(json.dumps(bench))
    grown["workloads"].append({"name": "protonet-eval-b8", "config": "protonet_conv64f",
                               "traffic": "eval-b8", "chips": 1, "why": "eight a step"})
    for m in grown["per_layer"] + grown["end_to_end"]:
        if "protonet-eval-b16" in m.get("workloads", []):
            m["workloads"].append("protonet-eval-b8")
    cell = manifest.load_cell("protonet-eval-b8", grown, here=here)
    assert cell.traffic["config"]["test_episode_size"] == 8
    assert cell.traffic["driver"] == "eval_epochs"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "eval_eps"}
    assert "mfu.eval" in {m["name"] for m in cell.per_layer}
