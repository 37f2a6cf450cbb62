"""The benchmark's manifest and the files it names: every name and unit in
the allowed characters, every cell's configuration, traffic, kind and
metric files found by name, every cell reporting the set-up time, another
end-to-end metric and a per-layer metric."""

from __future__ import annotations

import json
import math
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from reference import model  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for text in ([w["why"] for w in MAN["workloads"] + MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]
                 + [c["source"] for c in MAN["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell, MAN)
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert entry["chips"] in (1, 4)
    assert (BENCH / "kinds" / f"{c.traffic['kind']}.py").is_file()
    assert c.limits and all(v > 0 for v in c.limits.values())
    conf = next(x for x in MAN["configs"] if x["name"] == entry["config"])
    assert conf["file"].startswith("bench/")
    assert c.config["reduced"] == conf["reduced"]
    assert c.config["source"] == conf["source"]
    assert math.prod(c.workload["mesh"]) == entry["chips"]


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_states_the_epsilon_the_reference_runs(name):
    """Each configuration states its RMSNorm epsilon, under the key its
    source uses, and lists it as changed: the port fixes 1e-6, and so
    does the reference."""
    conf = next(c for c in MAN["configs"] if c["name"] == name)
    data = json.loads((ROOT / conf["file"]).read_text())
    (key,) = [k for k in data if "epsilon" in k]
    assert data[key] == model.EPS and key in conf["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in harness.cell_metrics(cell, False, MAN)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(cell, True, MAN)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_metric(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
    assert callable(harness.metric_reader(metric).read)
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        reported = [x["name"] for x in harness.cell_metrics(cell, False, MAN)]
        assert m["moves"] in reported, (cell, m["moves"])


def test_one_config_file_each_used_by_a_cell():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "d_model"


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)
