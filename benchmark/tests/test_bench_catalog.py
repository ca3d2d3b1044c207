"""BENCHMARK.json against the benchmark's contract, the files it names,
and growth by data alone."""

import json
import re
import shutil

import pytest

from benchmark import traffic
from benchmark.catalog import REPO, Catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    spec = Catalog().spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_workload_names_files_that_exist():
    c = Catalog()
    configs = {x["name"]: x for x in c.spec["configs"]}
    for w in c.spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs
        assert (REPO / configs[w["config"]]["file"]).is_file()
        assert w["traffic"] in c.traffic_names()
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        cfg = c.config(w["config"])
        assert cfg["name"] == w["config"]
        assert len(cfg["moduli"]) == len(cfg["ntt_roots"])
    assert len({(w["config"], w["traffic"])
                for w in c.spec["workloads"]}) == len(c.spec["workloads"])
    used = {w["config"] for w in c.spec["workloads"]}
    assert used == set(configs)


def test_names_units_and_metrics():
    c = Catalog()
    spec = c.spec
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in spec[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for x in spec["configs"]:
        assert set(x) == {"name", "source", "file", "reduced", "why"}
        assert x["file"].startswith("benchmark/")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    readers = c.metric_files()
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["name"] in readers
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in c.end_to_end(cell)}
    for cell in c.cells():
        assert any(m["name"] != "setup_s" for m in c.end_to_end(cell))
        assert c.per_layer(cell)


def test_rooflines_are_named_for_their_kernels():
    for m in Catalog().spec["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_a_cell_a_traffic_mix_and_a_metric_are_added_as_files(tmp_path):
    """In a copy, a new traffic file, a new cell in BENCHMARK.json and a
    new metric file are found by name; no file the benchmark had
    changes."""
    repo = tmp_path / "repo"
    shutil.copytree(REPO / "benchmark", repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (repo / "benchmark").rglob("*")
              if p.is_file()}
    mix = json.loads((repo / "benchmark/traffic/sym.b1024.json").read_text())
    mix["batch"] = 2048
    (repo / "benchmark/traffic/sym.b2048.json").write_text(json.dumps(mix))
    (repo / "benchmark/metrics/launches.call.py").write_text(
        "def read(obs):\n    return 7.0\n")
    spec["workloads"].append({"name": "n4096.sym.b2048",
                              "config": "seal-default-n4096",
                              "traffic": "sym.b2048", "chips": 1,
                              "why": "a wider batch"})
    spec["per_layer"].append({"name": "launches.call", "unit": "count",
                              "better": "lower", "source": "device_trace",
                              "layer": "kernels", "moves": "enc_per_s",
                              "workloads": ["n4096.sym.b2048"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    c = Catalog(repo)
    assert "n4096.sym.b2048" in c.cells()
    assert c.traffic(c.cell("n4096.sym.b2048")["traffic"])["batch"] == 2048
    assert [m["name"] for m in c.per_layer("n4096.sym.b2048")] == \
        ["launches.call"]
    assert c.reader("launches.call").read(None) == 7.0
    assert c.per_layer("n4096.sym.b1024") == Catalog().per_layer(
        "n4096.sym.b1024")
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("name", ["sym.b1024", "asym.b1024", "sym.b16"])
def test_traffic_files_hold_only_what_the_traffic_varies(name):
    mix = Catalog().traffic(name)
    assert set(mix) == traffic.KEYS
    assert traffic.validate(mix) is mix


@pytest.mark.parametrize("change", [
    {"loop": "open, bursts"},
    {"order": "reverse"},
    {"values": {"low": -1.0, "high": 1.0, "distribution": "normal"}},
    {"values": {"low": 1.0, "high": -1.0}},
    {"encrypt_type": "fused"},
    {"batch": 0},
])
def test_a_traffic_file_the_generator_cannot_make_is_refused(change):
    mix = dict(Catalog().traffic("sym.b16"), **change)
    with pytest.raises(ValueError):
        traffic.Traffic(4096, mix, 1)
