"""BENCHMARK.json against the benchmark's contract: every name resolves
to its file, names and units use the allowed characters, and the shape
is the one the contract fixes."""

import json
import re

import pytest

from perfbench.lib import spec

from conftest import ROOT

BENCH = spec.load_benchmark()
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert spec.NAME_RE.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert spec.UNIT_RE.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if "layer" in e:
                assert TEXT.match(e["layer"])
    metric_names = [n for m, n in names if m]
    assert len(metric_names) == len(set(metric_names))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert callable(spec.generator(cfg["generator"]))
        assert c["reduced"] == [] and cfg["guarantees"] and cfg["assumed"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads_resolve():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = spec.mix(w["traffic"])
        assert mix["driver"] in ("stream", "closed_loop")
        e2e = spec.metrics_for(BENCH, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics_for(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_resolve(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert callable(spec.metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert set(m) == {"name", "unit", "better", "bound", "source",
                              "workloads"} - (set() if "workloads" in m
                                              else {"workloads"})
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) == {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            # the cells it reads in report the metric it moves
            assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
                "workloads", cells))
    assert e2e["setup_s"]["bound"] <= 0.25


def test_paths_hold_only_allowed_file_names():
    ok = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in (ROOT / "perfbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if ".cache" in rel or "__pycache__" in rel:
            continue
        assert ok.match(rel) and len(rel) <= 200, rel


def test_mix_files_are_data():
    for p in (ROOT / "perfbench" / "traffic").iterdir():
        assert p.suffix == ".json"
        json.loads(p.read_text())
