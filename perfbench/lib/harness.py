"""One run of one cell: set-up, the timed window, the check.

`run_cell` is the whole run behind perfbench/run.py. It takes the device
and, for tests on the CPU, a smaller doc count; run.py always passes the
card and the configuration's own size.

Set-up (everything from process start to the first timed request):
imports, the index (built from the seed in RAM, in every run), the first
call of each of the mix's programs at the batch sizes its window uses
(device load, planning, kernel build, graph capture), a pass of the
pool's first cycles through the window's own entry point, a collection
of the host's garbage. The window then
drives the port's public entry point (Searcher.agg_search_stream, or
Searcher.agg_search one at a time in a closed loop) for `seconds`. After
it: the device's memory peak, the counters, the look for JAX, the trace;
then the program is freed and the reference answers the sampled requests
from the columns the generator drew, every kept answer compared with it
exactly.
"""

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import dsl, spec, trace_read
from .traffic_gen import Pool

FORBIDDEN = ("jax", "jaxlib", "flax", "tantivy_aggregations_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

def _schema(tt, cols):
    from tantivy_aggregations_tpu_torch.schema import Cardinality
    b = tt.SchemaBuilder()
    for name, c in cols.items():
        card = Cardinality.MULTI if "offsets" in c else Cardinality.SINGLE
        if c["type"] == "facet":
            b.add_facet_field(name)
        else:
            getattr(b, f"add_{c['type']}_field")(name, cardinality=card)
    return b.build()


def _writer_column(c, lo, hi):
    """Docs [lo, hi) of a neutral column in the writer's columnar form."""
    if "offsets" in c:
        offs = c["offsets"]
        a, b = int(offs[lo]), int(offs[hi])
        vals = (np.asarray(c["terms"], object)[c["codes"][a:b]]
                if "codes" in c else c["values"][a:b])
        return (offs[lo:hi + 1] - offs[lo], vals)
    if "codes" in c:
        return np.asarray(c["terms"], object)[c["codes"][lo:hi]]
    return c["values"][lo:hi]


def build_index(tt, cfg, n_docs, seed, root=spec.ROOT):
    """(index, columns): the configuration's columns drawn from the seed
    and written by the port's writer into an index in RAM, one commit a
    segment. Every run builds it anew, so that set-up is the same work in
    every run and nothing is written to disk."""
    cols = spec.generator(cfg["generator"], root)(n_docs, seed,
                                                  cfg["params"])
    idx = tt.Index.create_in_ram(_schema(tt, cols))
    w = idx.writer()
    S = int(cfg["segments"])
    per = n_docs // S
    for s in range(S):
        lo, hi = s * per, (n_docs if s == S - 1 else (s + 1) * per)
        w.add_documents_columnar(
            {k: _writer_column(c, lo, hi) for k, c in cols.items()}, hi - lo)
        w.commit()
    return idx, cols


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def _stream_window(searcher, objs, pool, mix, seconds, keep, kept):
    """Closed loop: agg_search_stream over the pool, replayed from its
    start, until the cycle in which `seconds` ran out has been fed; every
    request fed is answered. Returns (answered, seconds)."""
    L, cycle = len(objs), pool.cycle
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        i = 0
        while True:
            yield objs[i % L]
            i += 1
            if i % cycle == 0 and time.perf_counter() >= deadline:
                return

    n = 0
    for out in searcher.agg_search_stream(feed(),
                                          lookahead=int(mix["lookahead"])):
        if keep[n % L]:
            kept.append((n % L, out))
        n += 1
    return n, time.perf_counter() - t0


def port_requests(tt, pool) -> list:
    """(query, aggs) of the port for each pool position: one object per
    distinct tree, so that the requests of a block share their aggs
    object (the msearch grouping asks for the same one)."""
    made, out = {}, []
    for r in pool.requests:
        pair = []
        for part, build in (("query", dsl.query), ("aggs", dsl.aggs)):
            k = (part, json.dumps(r[part], sort_keys=True))
            if k not in made:
                made[k] = build(tt, r[part])
            pair.append(made[k])
        out.append(tuple(pair))
    return out


def _closed_loop_window(searcher, objs, seconds, keep, kept, lat, stats):
    """One client, closed loop: the next agg_search starts when the last
    answer is in, until `seconds` have passed; a latency is one call.
    Returns (answered, seconds)."""
    L = len(objs)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    t = t0
    while t < deadline:
        q, a = objs[n % L]
        out = searcher.agg_search(q, a)
        done = time.perf_counter()
        lat.append(done - t)
        t = done
        if stats is not None:
            stats.append(searcher.last_stats)
        if keep[n % L]:
            kept.append((n % L, out))
        n += 1
    return n, t - t0


def _warm(searcher, objs, pool, mix, say):
    """The first call of each template's program at the window's batch
    sizes (a stream: its full groups; a closed loop: one request), twice,
    then the pool's first `warm_cycles` cycles (default 1) through the
    window's entry point."""
    stream = mix["driver"] == "stream"
    la = int(mix.get("lookahead", 1))
    for j, tmpl in enumerate(mix["requests"]):
        block = objs[j * pool.block:(j + 1) * pool.block]
        for rep in range(2):
            t = time.perf_counter()
            if stream:
                list(searcher.agg_search_stream(iter(block), lookahead=la))
            else:
                searcher.agg_search(*block[0])
            if rep == 0:
                say(f"first call of {tmpl['name']} "
                    f"({len(block) if stream else 1} requests): "
                    f"{time.perf_counter() - t:.3f} s")
    first = objs[:pool.cycle * int(mix.get("warm_cycles", 1))]
    if stream:
        list(searcher.agg_search_stream(iter(first), lookahead=la))
    else:
        for q, a in first:
            searcher.agg_search(q, a)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", docs: int = None, t_process: float = None,
             root: Path = spec.ROOT) -> dict:
    """One run of `workload`; returns the result object of the last line.
    `docs` (tests on the CPU) replaces the configuration's doc count."""
    t_process = time.perf_counter() if t_process is None else t_process
    setup = {}

    def part(name, t, what=""):
        setup[name] = time.perf_counter() - t
        log(f"[perfbench] set-up: {name} {setup[name]:.3f} s {what}")

    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.mix(cell["traffic"], root)
    n_docs = int(docs or cfg["docs"])
    log(f"[perfbench] {workload}: {cfg['name']} x {cell['traffic']}, "
        f"{n_docs} docs, seed {seed}, {seconds} s, trace {int(trace)}, "
        f"device {device}")

    t = time.perf_counter()
    import torch
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    from tantivy_aggregations_tpu_torch.ops import cube, kernels, reductions
    part("imports_s", t)
    on_card = device.startswith("cuda")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    idx, cols = build_index(tt, cfg, n_docs, seed, root)
    part("index_s", t, "(built in RAM)")

    t = time.perf_counter()
    pool = Pool(mix, seed)
    objs = port_requests(tt, pool)
    keep = pool.keep.tolist()
    part("traffic_s", t)

    opts = {**cfg.get("engine_config", {}), **mix.get("engine_config", {})}
    if trace and mix["driver"] != "stream":
        opts["collect_stats"] = True
    searcher = idx.searcher(device=device, config=EngineConfig(**opts))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _warm(searcher, objs, pool, mix,
          lambda s: log(f"[perfbench] set-up: {s}"))
    if on_card:
        torch.cuda.synchronize()
    part("warmup_s", t)
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    part("gc_s", t)

    kernels.reset_launches()
    cube.reset_calls()
    reductions.reset_mm_calls()
    kept, lat = [], []
    stats = [] if opts.get("collect_stats") else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(trace_read.WINDOW)
        span.__enter__()
    setup["setup_s"] = time.perf_counter() - t_process
    if mix["driver"] == "stream":
        answered, window_s = _stream_window(searcher, objs, pool, mix,
                                            seconds, keep, kept)
    else:
        answered, window_s = _closed_loop_window(searcher, objs, seconds,
                                                 keep, kept, lat, stats)
    if on_card:
        torch.cuda.synchronize()
    if trace:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    gc.unfreeze()
    log(f"[perfbench] window: {answered} requests in {window_s:.6f} s")

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        log(f"[perfbench] modules of JAX or the JAX package loaded: {loaded}")
        raise SystemExit(1)

    if on_card:
        peak = torch.cuda.max_memory_allocated()
        log(f"[perfbench] device memory: peak allocated {peak} bytes, peak "
            f"reserved {torch.cuda.max_memory_reserved()} bytes")
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    log(f"[perfbench] counters over the window: kernel launches "
        f"{dict(kernels.launches)}, cube products {dict(cube.calls)}, dense "
        f"products {dict(reductions.mm_calls)}")

    run = {"answered": answered, "window_s": window_s, "setup": setup,
           "latencies_s": lat,
           "stats": None if stats is None else [s.as_dict() for s in stats],
           "trace": None}
    breakdown = None
    if trace:
        t = time.perf_counter()
        run["trace"] = trace_read.reduce(trace_read.events(prof))
        prof = None
        log(f"[perfbench] trace read in {time.perf_counter() - t:.3f} s")
        if run["trace"] is not None:
            tr = run["trace"]
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = tr["window_s"]
            breakdown = {"device_ops": tr["device_ops"],
                         "idle_gaps": tr["idle_gaps"]}
            log(f"[perfbench] trace: busy {tr['busy_s']} s of "
                f"{tr['window_s']} s; top device ops {tr['device_ops']}; "
                f"longest idle gaps {tr['idle_gaps']}")

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, workload, kind):
        v = spec.metric_reader(m["name"], root)(run)
        if v is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    del searcher, objs, idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(cols, n_docs, pool, kept, mix)

    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": answered, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result


def check(cols, n_docs, pool, kept, mix) -> dict:
    """Every kept answer against the reference's answer to its request."""
    from perfbench.reference.engine import Reference
    t = time.perf_counter()
    ref = Reference(cols, n_docs)
    want = {k: ref.answer(pool.requests[pool.keys.index(k)])
            for k in pool.check_keys}
    wrong, seen = 0, set()
    for pos, out in kept:
        k = pool.keys[pos]
        seen.add(pool.requests[pos]["name"])
        if out != want[k]:
            wrong += 1
            if wrong <= 3:
                log(f"[perfbench] MISMATCH {pool.requests[pos]['name']} "
                    f"{k}: port {json.dumps(out)[:1500]} reference "
                    f"{json.dumps(want[k])[:1500]}")
    log(f"[perfbench] reference: {len(want)} distinct requests, {len(kept)} "
        f"answers compared in {time.perf_counter() - t:.3f} s")
    names = [r["name"] for r in mix["requests"]]
    return {"mismatched_answers": {"value": wrong, "limit": 0},
            "templates_unchecked": {"value": len(set(names) - seen),
                                    "limit": 0}}
