"""``BENCHMARK.json`` against the benchmark's contract, statically: its keys,
names, units and limits, what each cell reports, the files each name
finds, and the check's time budget with the full 24 cells."""
import json
import pathlib
import re

import pytest

from portbench import spec

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WIDTHS = ("hidden", "intermediate", "latent", "state", "proj", "head",
          "channels", "rank", "_dim", "L", "F", "T", "rgb_layers")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]


def test_run_seconds_fit_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(entries):
    return [e["name"] for e in entries]


def test_names_units_and_keys():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = _names(SPEC[group])
        assert len(names) == len(set(names)), group
        assert all(NAME.fullmatch(n) for n in names), group
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if any(w in k for w in WIDTHS)]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in SPEC["workloads"]} == set(
        _names(SPEC["configs"]))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", _names(SPEC["workloads"]))
def test_each_cell_reports_what_it_must(cell):
    lay = spec.Layout(REPO)
    e2e = _names(lay.metrics_of(cell, trace=False))
    per_layer = lay.metrics_of(cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert all(m["moves"] in e2e for m in per_layer)
    assert (REPO / "portbench" / "limits" / f"{cell}.json").exists()
    traffic = lay.traffic(lay.cell(cell)["traffic"])
    assert (REPO / "portbench" / "kinds" / f"{traffic['kind']}.py").exists()


@pytest.mark.parametrize("metric", _names(SPEC["end_to_end"]
                                          + SPEC["per_layer"]))
def test_each_metric_has_a_reader(metric):
    assert callable(spec.Layout(REPO).metric(metric).read)


@pytest.mark.parametrize("cell", _names(SPEC["workloads"]))
def test_limits_lie_between_their_readings(cell):
    doc = json.loads((REPO / "portbench" / "limits" / f"{cell}.json")
                     .read_text())
    assert len(doc["seeds"]) >= 12
    for name, limit in doc["limits"].items():
        r = doc["readings"][name]
        assert r["lower"] < limit < r["upper"]
        assert r["upper"] >= 3 * r["lower"]
        # more room above the lower reading than below the upper one
        assert limit / r["lower"] > r["upper"] / limit
