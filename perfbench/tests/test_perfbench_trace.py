"""The reduction of a trace: busy seconds are the union of the device
records inside the window, gaps are named by the host record at their
middle."""

from perfbench.lib import trace_read


def test_reduce_union_and_gaps():
    ms = 1_000_000
    evs = [("bench.window", False, 0, 100 * ms),
           ("k1", True, 10 * ms, 30 * ms), ("k2", True, 20 * ms, 40 * ms),
           ("k1", True, 90 * ms, 120 * ms), ("early", True, -5 * ms, 2 * ms),
           ("harvest", False, 45 * ms, 85 * ms),
           ("aten::copy_", False, 60 * ms, 61 * ms)]
    r = trace_read.reduce(evs)
    assert r["window_s"] == 0.1
    assert abs(r["busy_s"] - (2 + 30 + 10) / 1e3) < 1e-12
    assert r["device_ops"][0] == ["k1", 0.03]
    # gaps: 40-90 (50 ms, host at 65: harvest), 2-10 (8 ms, no host record)
    assert r["idle_gaps"][0] == ["harvest", 0.05]
    assert r["idle_gaps"][1] == ["host python: no torch op or CUDA call",
                                 0.008]


def test_no_window_no_reading():
    assert trace_read.reduce([("k", True, 0, 1)]) is None
