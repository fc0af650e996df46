"""The control (the reference in float32 in the port's place) comes out
not correct on every cell, and each fault planted under the timed path
makes a run's `correct` false."""

import copy
import json

import pytest

from perfbench import control
from perfbench.lib import harness, spec

from conftest import DOCS

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(bench_root, cell, seed):
    r = control.readings(cell, seed, docs=DOCS, root=bench_root)
    assert r["exact_mismatched"] == 0
    assert r["mismatched_answers"] >= 1


def _bump(fruit):
    """The first count or value in a fruit tree, plus one."""
    for k, v in fruit.items():
        if k in ("doc_count", "value") and isinstance(v, (int, float)):
            fruit[k] = v + 1
            return True
        if isinstance(v, dict) and _bump(v):
            return True
        if isinstance(v, list):
            for x in v:
                if isinstance(x, dict) and _bump(x):
                    return True
    return False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(bench_root, monkeypatch, cell):
    from tantivy_aggregations_tpu_torch.aggs import compile as C
    orig = C.Program.harvest_host

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        _bump(out)
        return out
    monkeypatch.setattr(C.Program, "harvest_host", altered)
    r = harness.run_cell(cell, 41, 0.3, False, device="cpu", docs=DOCS,
                         root=bench_root)
    assert r["correct"] is False
    assert r["checks"]["mismatched_answers"]["value"] > 0


def _stream_cell(bench_root, cell):
    """A throwaway cell that sends `cell`'s mix through
    agg_search_stream in msearch groups of 64, every slot index checked."""
    w = spec.workload(BENCH, cell)
    mix = spec.mix(w["traffic"], bench_root)
    mix.update(driver="stream", lookahead=2, block=64, pool_cycles=2,
               engine_config={"msearch_dedup": False},
               check={"distinct_per_request": 8, "slots": 64})
    (bench_root / "perfbench" / "traffic" / "as-stream.json").write_text(
        json.dumps(mix))
    b = json.loads((bench_root / "BENCHMARK.json").read_text())
    name = f"{w['config']}.as-stream"
    b["workloads"].append({**w, "name": name, "traffic": "as-stream"})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(b))
    return name


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out(bench_root, monkeypatch, cell):
    """A group's second half answered with its first half's answers (a
    fault of msearch groups: the mix sent as a stream)."""
    from tantivy_aggregations_tpu_torch.aggs import compile as C
    orig = C.Program.finalize_many

    def half(self, raw, aggs, B, staged=None):
        outs = orig(self, raw, aggs, B, staged=staged)
        h = (B + 1) // 2
        return outs[:h] + [copy.deepcopy(outs[i % h]) for i in range(h, B)]
    name = _stream_cell(bench_root, cell)
    r = harness.run_cell(name, 43, 0.3, False, device="cpu", docs=DOCS,
                         root=bench_root)
    assert r["correct"] is True
    monkeypatch.setattr(C.Program, "finalize_many", half)
    r = harness.run_cell(name, 43, 0.3, False, device="cpu", docs=DOCS,
                         root=bench_root)
    assert r["correct"] is False
