"""Runs of every cell on the CPU (the harness without its look for a
card), the command without a card, and a mix and a metric added as files
only."""

import json
import subprocess
import sys

import pytest

from perfbench.lib import harness, spec

from conftest import DOCS, ROOT

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_has_the_contract_keys(bench_root, cell, trace):
    r = harness.run_cell(cell, 2**33 + 7, 0.5, bool(trace), device="cpu",
                         docs=DOCS, root=bench_root)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m for m in spec.metrics_for(BENCH, cell, kind)}
    assert set(r["metrics"]) <= set(listed)
    if not trace:  # every end-to-end metric; per-layer ones may read nothing
        assert set(r["metrics"]) == set(listed)
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == listed[name]["unit"]
        assert isinstance(m["value"], float) and m["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("driver", [{"driver": "stream", "lookahead": 2},
                                    {"driver": "closed_loop"}])
def test_mix_and_metric_added_as_files(bench_root, driver):
    """A later change adds a mix, a cell and metrics by adding files and
    entries only."""
    mix = {**driver, "block": 64, "pool_cycles": 2,
           "engine_config": {"msearch_dedup": False},
           "check": {"distinct_per_request": 3, "slots": 4},
           "requests": [{"name": "q1", "params": {"v": {"int": [0, 8]}},
                         "query": {"range": {"field": "qty", "lower": {
                             "param": "v", "plus": 10}}},
                         "aggs": {"m": {"max": {"field": "amount"}},
                                  "c": {"count": {}}}}]}
    (bench_root / "perfbench" / "traffic" / "throwaway.json").write_text(
        json.dumps(mix))
    (bench_root / "perfbench" / "metrics" / "answers_in_window.py"
     ).write_text("def read(run):\n    return run['answered']\n")
    (bench_root / "perfbench" / "metrics" / "answers_per_s.py").write_text(
        "def read(run):\n    return run['answered'] / run['window_s']\n")
    b = json.loads((bench_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "bench10m.throwaway", "config": "bench10m",
                           "traffic": "throwaway", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "answers_per_s", "unit": "req/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["bench10m.throwaway"]})
    b["per_layer"].append({"name": "answers_in_window", "unit": "req",
                           "better": "higher", "source": "program_counter",
                           "layer": "searcher", "moves": "answers_per_s",
                           "workloads": ["bench10m.throwaway"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(b))
    r = harness.run_cell("bench10m.throwaway", 5, 0.3, True, device="cpu",
                         docs=DOCS, root=bench_root)
    assert r["correct"]
    assert r["metrics"]["answers_in_window"]["value"] == r["attempted"]
    r = harness.run_cell("bench10m.throwaway", 5, 0.3, False, device="cpu",
                         docs=DOCS, root=bench_root)
    assert r["correct"] and set(r["metrics"]) == {"answers_per_s", "setup_s"}


def test_readers_find_nothing_without_a_device_trace():
    """A reader with nothing to read returns None (left out of the line),
    never 0."""
    run = {"answered": 10, "window_s": 1.0, "setup": {}, "latencies_s": [],
           "stats": None, "trace": {"window_s": 1.0, "busy_s": 0.0,
                                    "device_s_by_name": {}}}
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert spec.metric_reader(m["name"])(run) is None, m["name"]


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax",
                                  "tantivy_aggregations_tpu"])
def test_jax_loaded_means_no_result(bench_root, monkeypatch, name):
    """A run in whose process JAX or the JAX package is loaded when the
    window closes exits without a result; the port's own name (which
    begins with the JAX package's) is compared whole and passes."""
    import types

    import tantivy_aggregations_tpu_torch  # noqa: F401
    assert "tantivy_aggregations_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType(name))
    with pytest.raises(SystemExit) as e:
        harness.run_cell(CELLS[-1], 9, 0.2, False, device="cpu", docs=DOCS,
                         root=bench_root)
    assert e.value.code != 0
