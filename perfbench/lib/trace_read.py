"""From a torch.profiler trace of the window to what the metrics read.

`events(prof)` flattens the profiler's records into (name, on_device,
start_ns, end_ns): on_device for the card's kernels, copies and fills,
host otherwise (torch ops, CUDA runtime calls, the benchmark's own
record_function spans); the device-side copies of record_function
spans (`gpu_user_annotation`) are left out, as they are no device work.
`reduce(events)` clips the device records to the benchmark's
"bench.window" span and returns the window's length, the
seconds in which any device record ran (the union of their intervals),
device seconds by name, and the longest idle gaps, each named by what
the host was doing at its middle (the innermost host record there).
"""

WINDOW = "bench.window"


def events(prof) -> list:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if kind == "gpu_user_annotation" or (
                e.device_type() == cuda and e.name() == WINDOW):
            continue
        if hasattr(e, "start_ns"):
            t0, dt = e.start_ns(), e.duration_ns()
        else:
            t0, dt = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), e.device_type() == cuda, int(t0), int(t0 + dt)))
    return out


def _union(intervals):
    total, cur0, cur1 = 0, None, None
    merged = []
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                merged.append((cur0, cur1))
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        merged.append((cur0, cur1))
        total += cur1 - cur0
    return total, merged


def _host_label(host, t) -> str:
    best = None
    for name, a, b in host:
        if a <= t <= b and name != WINDOW and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "host python: no torch op or CUDA call"


def reduce(evs, top: int = 10) -> dict:
    spans = [(a, b) for name, dev, a, b in evs if name == WINDOW and not dev]
    if not spans:
        return None
    w0, w1 = spans[-1]
    dev = [(n, max(a, w0), min(b, w1)) for n, d, a, b in evs
           if d and b > w0 and a < w1]
    busy, merged = _union([(a, b) for _, a, b in dev])
    by_name = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0) + (b - a)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, a, b) for n, d, a, b in evs if not d]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s_by_name": {n: ns / 1e9 for n, ns in by_name.items()},
        "device_ops": [[n, ns / 1e9] for n, ns in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_label(host, (a + b) // 2), (b - a) / 1e9]
                      for a, b in gaps[:top]],
    }
