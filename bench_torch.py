#!/usr/bin/env python3
"""Benchmark harness of the PyTorch / CUDA port: tantivy_aggregations_tpu_torch
on one NVIDIA GPU vs the single-core C++ baseline (baseline_cpp/), on the
judged configs c1-c5 and the extra configs c6-c10 of models/flagship.py,
10M-doc fixed-seed index. The port's counterpart of bench.py, with its flags
and its steps, at the default EngineConfig.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": <geomean qps>, "unit": "qps", "vs_baseline": <geomean speedup>}
`value` is the geomean over c1-c5 of the queries per second of the varied
msearch stream with request dedup off. All progress and detail go to
stderr: the card's name and power limit first, then per config the first
call's seconds, the p50 of `--reps` sequential agg_search calls, one
call's QueryStats split (prepare / dispatch / wait / harvest), the stream's
ms/q with dedup off and on, and the scan bound (Program.scan_bytes) and
effective GB/s against the card's HBM rate; at the end the kernels'
launch counts over the whole run (ops/kernels.py). Before any number is
reported, every config's fruit must EQUAL the C++ baseline's (the identity
gate, c1-c10), each varied stream must equal the per-query answers, and up
to 3 distinct varied params per config must equal the oracle (c6: the
numpy reference chip_smoke.c6_reference, as the oracle's path for c6 does
not finish at 10M docs; where a stream varies no param, its one query);
any mismatch exits 1.

The index is built with the port's models/flagship.py under
.bench_cache/idx_<docs>_<segments>_<seed>, the directory bench.py and
chip_smoke.py share. c6's host-bound stream (about 0.23 s a request at 10M
docs) keeps bench.py's length, so that config alone takes minutes.

On the card every program answers through its compiled step, as bench.py's
jitted one: one CUDA graph per program and padded batch size, captured at
the first call of each size (aggs/compile.py `_StepGraph`). So a config's
first-call seconds include its plan and the capture of its B = 1 graph
(bench.py's include JAX's compile), the stream's first groups capture the
graphs of their padded sizes, and the QueryStats split measures a replay:
dispatch is the param copy and one graph launch. On the CPU the step runs
eagerly.

The searcher runs on the card unless `--device cpu` is given; with
`--device cuda` (the default) and no CUDA device it exits 2 and prints no
result. Nothing here imports jax or the JAX package.

Usage: python3 bench_torch.py [--smoke] [--docs N] [--reps R] [--segments S]
                              [--skip-baseline] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np

# the card's HBM rate for the roofline line, and c6's numpy reference
from chip_smoke import HBM_BYTES_PER_S, c6_reference

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")
HBM_GBPS = HBM_BYTES_PER_S / 1e9
#: the msearch stream's lookahead (groups in flight), bench.py's
LOOKAHEAD = 6


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# index build (cached on disk)
# ---------------------------------------------------------------------------

def ensure_index(n_docs: int, n_segments: int, seed: int = 42):
    from tantivy_aggregations_tpu_torch import Index
    from tantivy_aggregations_tpu_torch.models import flagship
    path = os.path.join(CACHE, f"idx_{n_docs}_{n_segments}_{seed}")
    if os.path.exists(os.path.join(path, "meta.json")):
        log(f"[bench] reusing cached index {path}")
        return Index.open(path), path
    log(f"[bench] building {n_docs}-doc index at {path} ...")
    t0 = time.time()
    idx = flagship.build_bench_index(path, n_docs, seed=seed,
                                     n_segments=n_segments)
    log(f"[bench] built in {time.time()-t0:.1f}s")
    return idx, path


def write_manifest(idx, path: str) -> str:
    """Manifest + terms.txt sidecars for the C++ baseline."""
    mpath = os.path.join(path, "baseline_manifest.txt")
    with open(mpath, "w") as f:
        f.write(f"base {path}\n")
        for seg in idx.segments:
            segdir = f"seg_{seg.id}"
            has_alive = 1 if seg.alive is not None else 0
            f.write(f"segment {segdir} {seg.max_doc} {has_alive}\n")
            for entry in idx.schema.fields:
                fd = seg.fields[entry.name]
                csr = 1 if fd.offsets is not None else 0
                f.write(f"field {entry.name} {entry.type.value} "
                        f"{1 if entry.cardinality.value=='multi' else 0} {csr}\n")
                if fd.terms is not None:
                    tpath = os.path.join(path, segdir,
                                         f"{entry.name}.terms.txt")
                    with open(tpath, "w") as tf:
                        tf.write("\n".join(fd.terms))
    return mpath


def build_baseline() -> str:
    exe = os.path.join(REPO, "baseline_cpp", "engine")
    subprocess.run(["make", "-s", "-C", os.path.join(REPO, "baseline_cpp")],
                   check=True)
    return exe


# ---------------------------------------------------------------------------
# C++ raw fruit -> engine-shaped final fruit (shared exact harvest helpers)
# ---------------------------------------------------------------------------

def _f64(bits: int) -> float:
    from tantivy_aggregations_tpu_torch.utils import mono
    return float(mono.mono_to_f64(np.asarray([bits], dtype=np.int64))[0])


def finalize_cpp(cfg: int, raw: dict) -> dict:
    from tantivy_aggregations_tpu_torch.utils import exact
    if cfg == 1:
        return {"n": {"value": raw["n"]}, "s": {"value": int(raw["s"])}}
    if cfg == 2:
        cnt = raw["cnt"]
        wc, ws = raw["w_cnt"], int(raw["w_sum"])
        return {
            "lo": {"value": None if cnt == 0 else _f64(raw["lo_bits"])},
            "hi": {"value": None if cnt == 0 else _f64(raw["hi_bits"])},
            "avg_w": {"value": None if wc == 0 else float(Fraction(ws) / wc),
                      "sum": ws, "count": wc},
        }
    if cfg == 3:
        return {"h": {"buckets": [
            {"key": k, "doc_count": c, "s": {"value": int(s)}}
            for k, c, s in raw["buckets"]]}}
    if cfg in (4, 6, 7):  # c6 = ordered by sum desc; c7 = multi-field query
        return {"t": {
            "buckets": [{"key": k, "doc_count": c, "s": {"value": int(s)},
                         "n": {"value": c2}}
                        for k, c, s, c2 in raw["buckets"]],
            "sum_other_doc_count": int(raw["other"])}}
    if cfg == 8:  # prefix query + calendar month histogram {sum}
        return {"n": {"value": raw["n"]},
                "h": {"buckets": [
                    {"key": k, "doc_count": c, "s": {"value": int(s)}}
                    for k, c, s in raw["buckets"]]}}
    if cfg == 10:  # termset query + count/sum + histogram (§A.14 surface)
        return {"n": {"value": raw["n"]}, "s": {"value": int(raw["s"])},
                "h": {"buckets": [{"key": k, "doc_count": c}
                                  for k, c in raw["buckets"]]}}
    if cfg == 9:  # terms{percentiles} nested slot_rank selection
        pcts = (25.0, 50.0, 75.0)
        buckets = []
        for key, cnt, ranks in raw["buckets"]:
            values = {}
            for p, (lo_bits, hi_bits) in zip(pcts, ranks):
                if cnt == 0:
                    values[str(p)] = None
                    continue
                lo, hi, frac = exact.percentile_rank(p, cnt)
                values[str(p)] = exact.interpolate(
                    _f64(lo_bits), _f64(hi_bits), frac)
            buckets.append({"key": key, "doc_count": cnt,
                            "p": {"values": values}})
        return {"t": {"buckets": buckets,
                      "sum_other_doc_count": int(raw["other"])}}
    if cfg == 5:
        m = raw["m"]
        pcts = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
        values = {}
        for p, (lo_bits, hi_bits) in zip(pcts, raw["ranks"]):
            if m == 0:
                values[str(p)] = None
                continue
            lo, hi, frac = exact.percentile_rank(p, m)
            values[str(p)] = exact.interpolate(_f64(lo_bits), _f64(hi_bits),
                                               frac)
        return {
            "p": {"values": values},
            "pf": {"doc_count": raw["pf_n"],
                   "n": {"value": raw["pf_n"]},
                   "s": {"value": int(raw["pf_sum"])},
                   "h": {"buckets": [{"key": k, "doc_count": c}
                                     for k, c in raw["pf_hist"]]}},
            "t": {"buckets": [{"key": k, "doc_count": c,
                               "s": {"value": int(s)}}
                              for k, c, s, *_ in raw["st"]["buckets"]],
                  "sum_other_doc_count": int(raw["st"]["other"])},
        }
    raise ValueError(cfg)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def fail(what: str) -> None:
    log(f"[bench] {what}")
    raise SystemExit(1)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def reference(tt, idx, oracle, cfg: int, query, aggs) -> dict:
    """The oracle's fruit; c6's from chip_smoke.c6_reference (numpy over
    the segments), which the CPU tests hold to the oracle."""
    if cfg == 6:
        return c6_reference(tt, idx, query, aggs)
    return oracle.agg_search(query, aggs)


def sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="100k docs")
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the searcher's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    on_card = args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        log("[bench] no CUDA device (pass --device cpu to run on the CPU)")
        raise SystemExit(2)
    log(f"[bench] card: {card_line()}" if on_card
        else "[bench] device: cpu (no card figure)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_docs = args.docs or (100_000 if args.smoke else 10_000_000)
    reps = args.reps or 96          # sequential-latency reps (p50)
    sys.path.insert(0, REPO)
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    from tantivy_aggregations_tpu_torch.models import flagship
    # sustained-stream length: 6 msearch groups at the serving batch size
    stream_reps = 6 * EngineConfig().max_batch
    cpp_reps = 3

    idx, path = ensure_index(n_docs, args.segments)
    log(f"[bench] engine device: "
        f"{torch.cuda.get_device_name(0) if on_card else 'cpu'}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")

    # --- C++ single-core baseline -----------------------------------------
    cpp_results, cpp_secs = {}, {}
    if not args.skip_baseline:
        exe = build_baseline()
        manifest = write_manifest(idx, path)
        for cfg in range(1, 11):
            t0 = time.time()
            out = subprocess.run([exe, manifest, str(cfg), str(cpp_reps)],
                                 capture_output=True, text=True, check=True)
            j = json.loads(out.stdout)
            cpp_results[cfg] = finalize_cpp(cfg, j["result"])
            cpp_secs[cfg] = j["seconds"]
            log(f"[bench] cpp c{cfg}: best {j['seconds']*1000:.1f}ms "
                f"(wall {time.time()-t0:.1f}s)")

    # --- the port's engine -------------------------------------------------
    searcher = idx.searcher(device=args.device)
    oracle = idx.oracle_searcher()
    # null round trip: median of a tiny device tensor's copy to the host
    # after the stream is idle, so the p50 split separates the copy's
    # fixed cost from device time
    tiny = torch.zeros(8, dtype=torch.int32, device=args.device)
    rtts = []
    for _ in range(7):
        sync(torch, args.device)
        t0 = time.perf_counter()
        tiny.cpu()
        rtts.append(time.perf_counter() - t0)
    link_rtt_ms = statistics.median(rtts) * 1000
    log(f"[bench] null device->host round trip: {link_rtt_ms:.3f}ms")
    configs = [(i, n, q, a) for i, (n, q, a)
               in enumerate(flagship.judged_configs(), start=1)]
    configs += flagship.extra_configs()  # identity-gated, outside geomean
    dev_p50, dev_qtime, dev_results = {}, {}, {}
    plain_cfg = searcher.config
    for i, name, query, aggs in configs:
        t0 = time.time()
        r = searcher.agg_search(query, aggs)  # plan + capture + first run
        log(f"[bench] c{i} first call {time.time()-t0:.1f}s")
        # sequential p50 latency (each call ends in the fruit's host copy)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = searcher.agg_search(query, aggs)
            times.append(time.perf_counter() - t0)
        dev_results[i] = r
        dev_p50[i] = statistics.median(times)
        # phase split of one representative sequential call (EngineConfig
        # is frozen; swap a stats-enabled copy in and out)
        searcher.config = dataclasses.replace(plain_cfg, collect_stats=True)
        searcher.agg_search(query, aggs)
        st = searcher.last_stats
        searcher.config = plain_cfg
        log(f"[bench] c{i} p50 breakdown: prepare {st.prepare_ms:.3f}ms, "
            f"dispatch {st.dispatch_ms:.3f}ms, execute+copy "
            f"{st.wait_ms:.3f}ms (null round trip {link_rtt_ms:.3f}ms), "
            f"harvest {st.harvest_ms:.3f}ms")
        # sustained msearch throughput over VARIED query params: one query
        # SHAPE, rotating parameter values, so the stream runs one planned
        # program with param-only dispatches. Each distinct param set is
        # anchored once against the single-query path, and up to 3 against
        # the oracle.
        reqs = flagship.varied_requests(i, aggs, stream_reps)
        expect, distinct = {}, {}
        for q, _ in reqs:
            k = repr(q)
            distinct.setdefault(k, q)
            if k not in expect:
                expect[k] = searcher.agg_search(q, aggs)
        # the canonical query is identity-gated against the C++ baseline;
        # anchor the VARIED params against the oracle (a stream that varies
        # nothing: its one query)
        canon = repr(query)
        anchors = [q for k, q in distinct.items() if k != canon][:3] \
            or [query]
        for q in anchors:
            if expect[repr(q)] != reference(tt, idx, oracle, i, q, aggs):
                fail(f"ORACLE MISMATCH config {i} query {q!r}")
        # headline stream: msearch dedup OFF, so the geomean measures raw
        # per-request compute throughput (streams repeat param sets; the
        # request dedup would collapse them)
        searcher.config = dataclasses.replace(plain_cfg, msearch_dedup=False)
        searcher.agg_search_batch(reqs[: searcher.config.max_batch * 2])
        sync(torch, args.device)
        t0 = time.perf_counter()
        outs = list(searcher.agg_search_stream(iter(reqs),
                                               lookahead=LOOKAHEAD))
        batch_t = (time.perf_counter() - t0) / len(reqs)
        if not all(o == expect[repr(q)] for o, (q, _) in zip(outs, reqs)):
            fail(f"STREAM MISMATCH config {i} (dedup off)")
        dev_qtime[i] = batch_t
        # serving mode (default config): dedup ON — stderr only
        searcher.config = plain_cfg
        list(searcher.agg_search_stream(iter(reqs), lookahead=LOOKAHEAD))
        sync(torch, args.device)
        t0 = time.perf_counter()
        outs2 = list(searcher.agg_search_stream(iter(reqs),
                                                lookahead=LOOKAHEAD))
        dedup_t = (time.perf_counter() - t0) / len(reqs)
        if not all(o == expect[repr(q)] for o, (q, _) in zip(outs2, reqs)):
            fail(f"STREAM MISMATCH config {i} (dedup on)")
        log(f"[bench] c{i} ({name}): p50 {dev_p50[i]*1000:.3f}ms, "
            f"stream {batch_t*1000:.4f}ms/q over {len(expect)} distinct "
            f"param sets (serving mode w/ request dedup: "
            f"{dedup_t*1000:.4f}ms/q)")
        # roofline: the program's resident row-extent bytes are the
        # per-query scan bound of a one-pass row formulation; effective
        # GB/s against the card's HBM rate says how close (or, through the
        # cube, a member operand or a batch-shared pass, how far past) the
        # stream runs to it
        prog = searcher._program_for(query, aggs)
        sb = prog.scan_bytes()
        n_cube = sum(1 for pp in prog.plan.values()
                     if isinstance(pp, dict)
                     and (pp.get("cube") is not None
                          or pp.get("pcube") is not None
                          or pp.get("scube") is not None))
        n_member = sum(1 for pp in prog.plan.values()
                       if isinstance(pp, dict) and pp.get("member_op"))
        eff = sb / batch_t / 1e9
        # the % is meaningful only on the card and where the scan bound
        # dominates the fixed dispatch floor (not at smoke scale)
        small = n_docs < 2_000_000
        log(f"[bench] c{i} roofline: scan bound {sb/1e6:.1f} MB/q, "
            f"effective {eff:.1f} GB/s"
            + (f" = {100*eff/HBM_GBPS:.1f}% of HBM roofline "
               f"({HBM_GBPS:.0f} GB/s)" if on_card and not small else
               " [% suppressed: " + ("cpu" if not on_card else
                                     "smoke scale, dispatch floor dominates")
               + "]")
            + (f"; {n_cube} cube site(s) bypass the row pass"
               if n_cube else "")
            + (f"; {n_member} member operand(s): one row per query"
               if n_member else ""))

    # --- identity gate -----------------------------------------------------
    if cpp_results:
        for cfg in sorted(cpp_results):
            if dev_results[cfg] != cpp_results[cfg]:
                log(f"  port: {json.dumps(dev_results[cfg])[:2000]}")
                log(f"  cpp: {json.dumps(cpp_results[cfg])[:2000]}")
                fail(f"MISMATCH config {cfg}!")
        log(f"[bench] identity gate: all {len(cpp_results)} configs EQUAL "
            "(port == cpp)")

    # --- report (geomean over the 5 JUDGED configs; extras on stderr) ------
    for i, name, _, _ in configs:
        if i > 5 and cpp_secs:
            log(f"[bench] extra c{i} ({name}): {1.0/dev_qtime[i]:.1f} qps, "
                f"{cpp_secs[i]/dev_qtime[i]:.1f}x vs cpp")
    dev_qtime = {i: t for i, t in dev_qtime.items() if i <= 5}
    cpp_secs = {i: t for i, t in cpp_secs.items() if i <= 5}
    qps = {i: 1.0 / dev_qtime[i] for i in dev_qtime}
    geo_qps = math.exp(sum(math.log(v) for v in qps.values()) / len(qps))
    if cpp_secs:
        speedups = {i: cpp_secs[i] / dev_qtime[i] for i in cpp_secs}
        geo_speedup = math.exp(
            sum(math.log(v) for v in speedups.values()) / len(speedups))
        for i in sorted(speedups):
            log(f"[bench] c{i}: {qps[i]:.1f} qps, {speedups[i]:.1f}x vs cpp "
                f"(p50 latency {dev_p50[i]*1000:.3f}ms)")
    else:
        geo_speedup = 0.0
    from tantivy_aggregations_tpu_torch.ops import kernels as K
    log(f"[bench] kernel launches in the whole run: {K.launches}")
    device = torch.cuda.get_device_name(0) if on_card else "cpu"
    print(json.dumps({
        "metric": f"agg qps geomean (sustained msearch stream), 5 judged "
                  f"configs, {n_docs} docs, {device}, identical-results "
                  f"gate vs single-core C++ baseline",
        "value": round(geo_qps, 3),
        "unit": "qps",
        "vs_baseline": round(geo_speedup, 2),
    }))


if __name__ == "__main__":
    main()
