"""The port's spans as the benchmark reads them (perfbench/lib/spans.py):
the per-layer metrics of a traced CPU run, their silence on a program
without spans, and the split of a trace's idle time by span."""

from perfbench.lib import harness, spans

from conftest import DOCS

ms = 1_000_000
SPAN_METRICS = ["params_ms", "param_copy_ms", "launch_ms", "wait_ms",
                "build_s"]


def test_traced_cpu_run_reads_the_span_metrics(bench_root):
    """A traced closed-loop run on the CPU reads every span metric but
    capture_s (the CPU captures no graph)."""
    from tantivy_aggregations_tpu_torch.utils import stats
    stats.reset_spans()
    r = harness.run_cell("bench10m.judged-latency", 2**32 + 11, 0.5, True,
                         device="cpu", docs=DOCS, root=bench_root)
    assert r["correct"] is True
    m = r["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["value"] > 0, name
    assert "capture_s" not in m
    # params, their copy and the launch lie inside dispatch; load and
    # build inside the warm-up
    assert (m["params_ms"]["value"] + m["param_copy_ms"]["value"]
            + m["launch_ms"]["value"]) <= m["dispatch_ms"]["value"]
    assert m["build_s"]["value"] <= m["warmup_s"]["value"]


def test_readers_find_nothing_without_spans():
    """A program without spans (QueryStats without `spans`) or a run
    without stats: every span metric reads None."""
    from perfbench.lib import spec
    old = {"answered": 3, "window_s": 1.0, "setup": {}, "latencies_s": [],
           "trace": None, "stats": [{"prepare_ms": 0.1, "dispatch_ms": 0.2,
                                     "wait_ms": 0.3, "harvest_ms": 0.1,
                                     "device_ms": 0.6, "total_ms": 0.7}]}
    for run in (old, dict(old, stats=None), dict(old, stats=[])):
        for name in SPAN_METRICS[:4]:
            assert spec.metric_reader(name)(run) is None, name


def test_split_by_innermost_span():
    """Idle before any span, inside nested spans (charged to the
    innermost), inside tat.wait and after the window's end; the pieces
    sum to the window less its busy time exactly."""
    evs = [("bench.window", False, 0, 100 * ms),
           # request 1: 5-45 ms, submit 10-20 (params 10-14), wait 25-40
           ("tat.request serial=1", False, 5 * ms, 45 * ms),
           ("tat.submit", False, 10 * ms, 20 * ms),
           ("tat.params", False, 10 * ms, 14 * ms),
           ("tat.wait", False, 25 * ms, 40 * ms),
           # request 2 runs past the window's end
           ("tat.request serial=2", False, 60 * ms, 130 * ms),
           ("tat.wait", False, 70 * ms, 130 * ms),
           ("aten::copy_", False, 11 * ms, 12 * ms),
           # the card: busy 16-30 and 50-75
           ("k1", True, 16 * ms, 30 * ms), ("k2", True, 50 * ms, 75 * ms)]
    r = spans.split(evs)
    # idle 0-16: outside 0-5, request 5-10, params 10-14, submit 14-16;
    # idle 30-50: wait 30-40, request 40-45, outside 45-50; idle 75-100:
    # wait
    got = {k: round(v * 1e3, 9) for k, v in r["idle_by_span"].items()}
    assert got == {"outside": 10, "tat.request": 10, "tat.params": 4,
                   "tat.submit": 2, "tat.wait": 35}
    assert abs(sum(r["idle_by_span"].values()) - r["idle_s"]) < 1e-12
    assert abs(r["idle_s"] - (100 - 14 - 25) / 1e3) < 1e-12
    sp = {k: {f: round(v, 9) for f, v in e.items()}
          for k, e in r["spans"].items()}
    assert sp == {
        "tat.request": {"count": 2, "s": 0.08, "self_s": 0.025},
        "tat.submit": {"count": 1, "s": 0.01, "self_s": 0.006},
        "tat.params": {"count": 1, "s": 0.004, "self_s": 0.004},
        "tat.wait": {"count": 2, "s": 0.045, "self_s": 0.045}}


def test_split_reads_nothing_without_spans_or_window():
    assert spans.split([("k", True, 0, 1)]) is None
    assert spans.split([("bench.window", False, 0, 10),
                        ("k", True, 0, 1)]) is None
