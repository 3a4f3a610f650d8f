"""Every configuration, traffic mix, cell and metric of BENCHMARK.json
loads by its name, and the file keeps to the format and limits it must."""

import glob
import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and all(PATH.match(p) for p in BENCH["paths"])
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert os.path.isfile(os.path.join(harness.ROOT, word)) and word.startswith("perfbench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_the_checks_time_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    import matchering_tpu_torch as mt
    from perfbench.reference import matchering as reference

    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _line(config["source"]) and _line(config["why"])
    assert config["source"].startswith("https://")
    assert config["file"] == f"perfbench/configs/{config['name']}.json"
    data = harness.load_json(harness.ROOT, config["file"])
    assert data["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert _line(data["source"]) and data["assumed"]
    harness.port_config(mt, data["parameters"])  # the port takes every field
    reference.parameters(data["parameters"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_by_name(name):
    spec = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(spec) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(spec["traffic"]) and spec["chips"] in (1, 4)
    assert _line(spec["why"])
    cell = harness.Cell.load(name)
    entry = cell.entry()
    for function in ("prepare", "warm", "call", "release", "compare", "compared_indices"):
        assert callable(getattr(entry, function))
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    assert set(metric["workloads"]) <= set(CELLS) if "workloads" in metric else True
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(metric["layer"])
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):  # each of its cells reports what it moves
            assert cell in moves.get("workloads", CELLS)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
        files = glob.glob(os.path.join(harness.HERE, "metrics", metric["name"], "kernels", "*.json"))
        assert files and all(re.compile(json.load(open(f))["pattern"]) for f in files)


def test_setup_has_its_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))


def test_files_are_named_from_name_characters():
    for path in glob.glob(os.path.join(harness.HERE, "**", "*"), recursive=True):
        if "__pycache__" in path:
            continue
        assert PATH.match(os.path.relpath(path, harness.ROOT)), path
