"""``BENCHMARK.json`` against the rules a manifest keeps: names and units of
the allowed characters, every file it names present, each per-layer
metric's ``moves`` reported by every cell it lists, and the check's time
within its budget at the full 24 cells."""

import json
import re

import pytest

from bench import run as bench_run

ROOT = bench_run.ROOT
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank|hidden_size|intermediate_size|head|expert|latent|state_size"
                   r"|proj|expand)")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


def test_names_units_and_keys():
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, keys in groups.items():
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for e in MAN[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                if text is not None:
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25


def test_configs_are_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        # every key changed from the source is listed, none a width
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) == sorted(cfg["source_values"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert cfg[key] != cfg["source_values"][key], key


def test_cells_and_their_files():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        traffic = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "bench" / "drivers" / f"{traffic['kind']}.py").exists()
        limits = json.loads((ROOT / "bench" / "cells" / f"{w['name']}.json").read_text())
        assert limits["limits"], w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = bench_run.cell_metrics(MAN, "end_to_end", cell)
    per = bench_run.cell_metrics(MAN, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for name in e2e + per:
        assert (ROOT / "bench" / "metrics" / f"{name}.py").exists(), name


def test_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in bench_run.cell_metrics(MAN, "end_to_end", cell), m["name"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_the_check_fits_its_budget_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
