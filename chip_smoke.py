#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives tantivy_aggregations_tpu_torch's main path — `Searcher.agg_search`
and `agg_search_batch` over the judged configs c1-c5 and the extra configs
c6-c9 on the 10M-doc bench index (models/flagship.py, seed 42, 4 segments;
built on first use under .bench_cache/, the path bench.py uses) — and
checks it end to end:

1. versions of torch, CUDA and nvcc, and the card's name and power limit;
2. builds the port's CUDA kernels from csrc/ (timed);
3. builds or reuses the bench index, then plans c1-c9 (timed: c7's
   member operand and c9's slot plane are built here);
4. each kernel against its plain PyTorch version at the main path's shapes
   (exact `==`), with median CUDA-event times of both; the chain kernels
   also under a query whose mask program holds every opcode, on the same
   layouts;
5. the main path of each slice (c1-c5, then c6-c9), each with the launch
   counters set to 0: for each config, agg_search == the port's oracle
   (c6: c6_reference, as the oracle's path for it does not finish at 10M
   docs), agg_search_batch over 256 varied requests == the per-query results
   (with msearch dedup on and off), distinct varied params == the oracle;
   p50 single-query latency, and msearch ms/query with dedup on and off
   beside the number of distinct requests per group;
6. each slice's kernels were launched by its own main path in step 5.

Each phase prints its seconds.

It prints a JSON line of per-kernel records, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device, or without the port's package beside it, it exits non-zero
before printing any result. The port never imports jax, and neither does
this script.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
#: the bench deployment (models/flagship.py, bench.py): docs, segments, seed
DOCS, SEGMENTS, SEED = 10_000_000, 4, 42
SOURCE = "tantivy_aggregations_tpu_torch/csrc/kernels.cu"
REPLACES = {
    "fused_metrics": "tantivy_aggregations_tpu/ops/pallas_kernels.py:225",
    "chain_blocks": "tantivy_aggregations_tpu/ops/pallas_kernels.py:355",
    "chain_counts": "tantivy_aggregations_tpu/ops/pallas_kernels.py:156",
    "chain_slot_counts":
        "tantivy_aggregations_tpu/ops/pallas_kernels.py:432",
    "gather_rows": "tantivy_aggregations_tpu/ops/pallas_kernels.py:527",
}
#: the extra configs this script drives beside c1-c5 (c10's set queries
#: are not ported yet)
EXTRA = (6, 7, 8, 9)
#: the main path of each slice of the port: its configs, and the kernels
#: that path must launch (each path runs with the counters set to 0)
PATHS = (
    ("c1-c5", (1, 2, 3, 4, 5),
     ("fused_metrics", "chain_blocks", "chain_counts")),
    ("c6-c9", EXTRA, ("chain_slot_counts", "gather_rows")),
)


def say(*a):
    print(*a, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _cmd_out(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"{cmd[0]} exited {res.returncode}: "
                               f"{res.stderr.strip()}")
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_versions(torch, K) -> str:
    say("[1] versions")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(_cmd_out([K._nvcc(), "--version"]).splitlines()[-1])
    card = _cmd_out(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    say(card)
    return card


def phase_build(K) -> None:
    say("[2] kernel build")
    t0 = time.time()
    lib = K.build()
    say(f"built {lib.name} in {time.time() - t0:.1f}s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                say("  ptxas:", ln.strip())


def phase_index(tt, flagship):
    say("[3] bench index")
    path = REPO / ".bench_cache" / f"idx_{DOCS}_{SEGMENTS}_{SEED}"
    t0 = time.time()
    if (path / "meta.json").exists():
        idx = tt.Index.open(str(path))
        say(f"reused {path} in {time.time() - t0:.1f}s")
    else:
        idx = flagship.build_bench_index(str(path), DOCS, seed=SEED,
                                         n_segments=SEGMENTS)
        say(f"built {DOCS} docs x {SEGMENTS} segments at {path} in "
            f"{time.time() - t0:.1f}s")
    return idx


def _cuda_ms(torch, fn, iters: int) -> float:
    """Median CUDA-event time of fn() over `iters` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"kernel/plain output {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def every_op_queries(tt, B: int):
    """B queries of one Boolean shape over the bench schema whose mask
    program holds every opcode of the kernels' interpreter: EQ32 (keyword
    term), RANGE32 (narrow range), RANGE_WIDE (f64 range), EQ_WIDE_GUARD and
    EQ32_GUARD in OR pairs (f64 and narrow terms), NOT, AND and TRUE. Their
    params are drawn from SEED."""
    rng = np.random.default_rng(SEED)
    statuses = ("active", "archived", "deleted", "pending")
    out = []
    for b in range(B):
        lo = int(rng.integers(0, 5000))
        plo = int(rng.integers(0, 4000)) / 100
        out.append(tt.BooleanQuery(
            must=[tt.TermQuery("status", statuses[b % 4]),
                  tt.RangeQuery("amount", lower=lo, upper=lo + 4000,
                                include_upper=True),
                  tt.RangeQuery("price", lower=plo, upper=plo + 40.0)],
            must_not=[tt.TermQuery("price",
                                   round(float(rng.lognormal(3.0, 1.0)), 2)),
                      tt.TermQuery("qty", int(rng.integers(0, 100)))]))
    return out


def _chain_blocks_args(prog, pmat):
    """chain_blocks operands of a prefix-mode terms agg "t"."""
    pt = prog.plan[("a", "t")]
    e, pre = pt["chainp"], pt["prefix"]
    pay = [prog._arrays[pre + k] for meta in pt["pay_plan"].values()
           for k in meta["skeys"]]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"], pay)


def _chain_counts_args(prog, pmat):
    """chain_counts operands of a rank-mode percentiles agg "p"."""
    pp = prog.plan[("a", "p")]
    e, pre = pp["chainp"], pp["prefix"]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"])


def _chain_slot_args(prog, pmat):
    """chain_slot_counts operands of a slot_rank percentiles agg "t"/"p"."""
    pp = prog.plan[("a", "t", "p")]
    e, pre = pp["chainp"], pp["prefix"]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"], prog._arrays[pre + pp["slotk"]],
            pp["nslots"])


def _gather_rows_args(prog, pmat):
    """gather_rows operands of a member-operand terms agg "t": the row
    index as the main path clamps it, and the resident operand."""
    mo = prog.plan[("a", "t")]["member_op"]
    op = prog._arrays[mo["key"]]
    return pmat[:, mo["tcol"]].clamp(0, op.shape[0] - 1).contiguous(), op


def all_configs(flagship):
    """(config number, name, query, aggs) of c1-c5 and the EXTRA configs."""
    out = [(i + 1, name, q, aggs)
           for i, (name, q, aggs) in enumerate(flagship.judged_configs())]
    return out + [c for c in flagship.extra_configs() if c[0] in EXTRA]


def phase_kernels(torch, K, qc, tt, searcher, flagship):
    """Each kernel vs its plain version on the main path's operands; the
    chain kernels also under every opcode, on the same layouts."""
    say("[4] kernels vs plain versions (exact ==)")
    cfgs = {name: (q, aggs) for _, name, q, aggs in all_configs(flagship)}
    progs = {n: searcher._program_for(q, a) for n, (q, a) in cfgs.items()}

    def pmat_of(prog, reqs):
        return qc.param_matrix([prog._extract(q, a) for q, a in reqs],
                               prog._pkeys, prog.device)

    def pmat_for(prog, cfg_no, aggs, B):
        return pmat_of(prog, flagship.varied_requests(cfg_no, aggs, B))

    p1 = progs["c1_count_sum"]
    p4 = progs["c4_terms_highcard_nested"]
    p5 = progs["c5_percentiles_mixed_postfilter"]
    p7 = progs["c7_terms_prefix_multiquery"]
    p9 = progs["c9_terms_nested_percentiles"]
    c5_aggs = cfgs["c5_percentiles_mixed_postfilter"][1]
    c4_aggs = cfgs["c4_terms_highcard_nested"][1]
    c7_aggs = cfgs["c7_terms_prefix_multiquery"][1]
    c9_aggs = cfgs["c9_terms_nested_percentiles"][1]
    amount = p1._arrays["amount:w"]
    # the c4, c5 and c9 trees under the every-opcode query: the same sku
    # bucket and price value layouts, with the query's planes permuted onto
    # them (and c9's status slot plane)
    every = every_op_queries(tt, 128)
    p4e = searcher._program_for(every[0], c4_aggs)
    p5e = searcher._program_for(every[0], c5_aggs)
    p9e = searcher._program_for(every[0], c9_aggs)
    for prog, key in ((p4e, ("a", "t")), (p5e, ("a", "p")),
                      (p9e, ("a", "t", "p"))):
        ops = prog.plan[key]["chainp"]["mp"].ops
        check(set(ops[:, 0].tolist())
              == set(range(qc.OP_EQ_WIDE_GUARD + 1)),
              f"every-opcode chain on {key} has opcodes "
              f"{sorted(set(ops[:, 0].tolist()))}")

    cases = {}
    for B in (1, 128):
        # fused_metrics: the c5 root masks (B queries) over amount
        pm5 = pmat_for(p5, 5, c5_aggs, B)
        mask = (p5._chain_mask(p5._root, pm5, p5._arrays)
                & (p5._arrays["alive"] > 0)).contiguous()
        cases[("fused_metrics", "c5", B)] = (
            lambda m=mask: K.fused_metrics(m, amount),
            lambda m=mask: K.fused_metrics_plain(m, amount))
        # chain_blocks: c4's sku bucket layout + sum(amount) payload
        args = _chain_blocks_args(p4, pmat_for(p4, 4, c4_aggs, B))
        cases[("chain_blocks", "c4", B)] = (
            lambda a=args: K.chain_blocks(*a),
            lambda a=args: K.chain_blocks_plain(*a))
        # chain_counts: c5's price value layout under the c5 chain
        args = _chain_counts_args(p5, pm5)
        cases[("chain_counts", "c5", B)] = (
            lambda a=args: K.chain_counts(*a),
            lambda a=args: K.chain_counts_plain(*a))
        # both chain kernels under the every-opcode query
        args = _chain_blocks_args(
            p4e, pmat_of(p4e, [(q, c4_aggs) for q in every[:B]]))
        cases[("chain_blocks", "every-op", B)] = (
            lambda a=args: K.chain_blocks(*a),
            lambda a=args: K.chain_blocks_plain(*a))
        args = _chain_counts_args(
            p5e, pmat_of(p5e, [(q, c5_aggs) for q in every[:B]]))
        cases[("chain_counts", "every-op", B)] = (
            lambda a=args: K.chain_counts(*a),
            lambda a=args: K.chain_counts_plain(*a))
        # chain_slot_counts: c9's price value layout, Range chain and
        # status slot plane; then under the every-opcode query
        args = _chain_slot_args(p9, pmat_for(p9, 9, c9_aggs, B))
        cases[("chain_slot_counts", "c9", B)] = (
            lambda a=args: K.chain_slot_counts(*a),
            lambda a=args: K.chain_slot_counts_plain(*a))
        args = _chain_slot_args(
            p9e, pmat_of(p9e, [(q, c9_aggs) for q in every[:B]]))
        cases[("chain_slot_counts", "every-op", B)] = (
            lambda a=args: K.chain_slot_counts(*a),
            lambda a=args: K.chain_slot_counts_plain(*a))
        # gather_rows: rows of c7's resident member operand
        args = _gather_rows_args(p7, pmat_for(p7, 7, c7_aggs, B))
        cases[("gather_rows", "c7", B)] = (
            lambda a=args: K.gather_rows(*a),
            lambda a=args: K.gather_rows_plain(*a))

    records = {}
    for (name, chain, B), (kern, plain) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = _max_abs_err(torch, got, want)
        check(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name} ({chain}) B={B} disagrees with its plain version "
              f"(max abs err {err})")
        matched = int(got[0].to(torch.int64).sum())
        ms = _cuda_ms(torch, kern, 10)
        plain_ms = _cuda_ms(torch, plain, 3)
        say(f"  {name:17s} {chain:8s} B={B:<4d} kernel {ms:.3f} ms  plain "
            f"{plain_ms:.3f} ms  max_abs_err {err}  matched {matched}")
        rec = records.setdefault(name, {"name": name, "route": "cuda",
                                        "source": SOURCE,
                                        "replaces": REPLACES[name],
                                        "launches": 0,
                                        "max_abs_err": 0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if B == 1 and chain != "every-op":
            rec["ms"], rec["plain_ms"] = ms, plain_ms
    del cases
    torch.cuda.empty_cache()
    return records


def _msearch_ms_per_q(torch, searcher, reqs) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    searcher.agg_search_batch(reqs)
    return (time.perf_counter() - t0) * 1e3 / len(reqs)


def c6_reference(tt, idx, query, aggs) -> dict:
    """c6's fruit by plain numpy over the segments: terms over sku ordered
    by sum(amount) desc (ties key asc), with the sum and count subs. The
    oracle's own c6 path refines each of the 100k buckets over every row,
    which does not finish at 10M docs; the CPU tests hold the port's c6 to
    the oracle at small sizes."""
    t = aggs["t"]
    check(isinstance(query, tt.MatchAllQuery) and t.field == "sku"
          and t.order == ("s", "desc")
          and [(nm, type(s).__name__, getattr(s, "field", None))
               for nm, s in t.sub_aggs]
          == [("s", "SumAgg", "amount"), ("n", "CountAgg", None)],
          "c6 reference: unexpected request shape")
    cnt, tot = {}, {}
    for seg in idx.segments:
        sku, amount = seg.fields["sku"], seg.fields["amount"]
        reps = np.diff(sku.offsets.astype(np.int64))
        check(int(reps.max(initial=0)) <= 1, "sku is single-valued")
        doc = np.repeat(np.arange(seg.max_doc), reps)
        live = seg.alive_mask()[doc]
        ords = sku.values[live].astype(np.int64)
        c = np.bincount(ords, minlength=len(sku.terms))
        s = np.zeros(len(sku.terms), np.int64)
        np.add.at(s, ords, amount.values[doc[live]].astype(np.int64))
        for i in np.nonzero(c)[0].tolist():
            k = sku.terms[i]
            cnt[k] = cnt.get(k, 0) + int(c[i])
            tot[k] = tot.get(k, 0) + int(s[i])
    order = sorted(cnt, key=lambda k: (-tot[k], k))
    return {"t": {"buckets": [{"key": k, "doc_count": cnt[k],
                               "s": {"value": tot[k]}, "n": {"value": cnt[k]}}
                              for k in order[:t.size]],
                  "sum_other_doc_count": sum(cnt[k] for k in order[t.size:])}}


def phase_main_path(torch, K, tt, idx, searcher, oracle, flagship, card,
                    path):
    """Drive one slice's main path with the launch counters set to 0;
    returns the counts it left."""
    label, cfg_nos, kernels = path
    say(f"[5] main path {label}: agg_search / agg_search_batch vs the "
        "oracle (c6: its numpy reference)")
    K.reset_launches()
    dedup_on = searcher.config
    dedup_off = dataclasses.replace(dedup_on, msearch_dedup=False)
    for n, name, q, aggs in all_configs(flagship):
        if n not in cfg_nos:
            continue
        t_cfg = time.time()
        reference = (oracle.agg_search if n != 6 else
                     lambda rq, ra: c6_reference(tt, idx, rq, ra))
        t0 = time.time()
        want = reference(q, aggs)
        t_oracle = time.time() - t0
        got = searcher.agg_search(q, aggs)
        check(got == want, f"{name}: agg_search != oracle")
        reqs = flagship.varied_requests(n, aggs, 256)
        prog = searcher._program_for(q, aggs)
        group = reqs[:searcher.config.max_batch]
        distinct = len({prog.param_key(rq, ra) for rq, ra in group})
        batch = searcher.agg_search_batch(reqs)
        check(len(batch) == len(reqs), f"{name}: batch length")
        # one agg_search per distinct param set (a program is a pure
        # function of its params, so repeats would recompute the same)
        keys = [prog.param_key(rq, ra) for rq, ra in reqs]
        one = {}
        for k, (rq, ra) in zip(keys, reqs):
            if k not in one:
                one[k] = searcher.agg_search(rq, ra)
        singles = [one[k] for k in keys]
        check(batch == singles, f"{name}: agg_search_batch != per-query")
        searcher.config = dedup_off
        check(searcher.agg_search_batch(reqs) == singles,
              f"{name}: agg_search_batch (dedup off) != per-query")
        searcher.config = dedup_on
        seen = []
        for (rq, ra), res in zip(reqs, batch):
            if any(rq == s for s in seen):
                continue
            seen.append(rq)
            check(res == (want if rq == q else reference(rq, ra)),
                  f"{name}: varied request {rq!r} != oracle")
            if len(seen) == 3:
                break
        # timings (every agg_search ends in the device->host fruit copy)
        times = []
        for rq, ra in reqs[:20]:
            t0 = time.perf_counter()
            searcher.agg_search(rq, ra)
            times.append((time.perf_counter() - t0) * 1e3)
        msq = _msearch_ms_per_q(torch, searcher, reqs)
        searcher.config = dedup_off
        msq_all = _msearch_ms_per_q(torch, searcher, reqs)
        searcher.config = dedup_on
        say(f"  {name}: == oracle ({len(seen)} distinct varied checked; "
            f"oracle {t_oracle:.1f}s)  p50 {statistics.median(times):.3f} ms  "
            f"msearch {msq:.4f} ms/q dedup on ({distinct} distinct of "
            f"{len(group)} per group), {msq_all:.4f} ms/q dedup off  "
            f"[{card}]  ({time.time() - t_cfg:.1f}s)")
    counts = dict(K.launches)
    say(f"[6] kernel launches during the main path {label}:", counts)
    for k in kernels:
        check(counts[k] > 0,
              f"kernel {k} was never launched by the main path {label}")
    return counts


def phase_plan(torch, searcher, flagship):
    """Plan every config (layouts, planes and operands ship here). c7 is
    planned after c4 and c9 after c5, so their plan seconds are the build
    of what they add: c7's member operand (on c4's sku layout) and c9's
    slot plane (on c5's price layout, under the same chain planes)."""
    say("[3b] planning c1-c9")
    for n, name, q, aggs in all_configs(flagship):
        t0 = time.time()
        prog = searcher._program_for(q, aggs)
        torch.cuda.synchronize()
        extra = ""
        mo = prog.plan.get(("a", "t"), {}).get("member_op")
        if mo is not None:
            op = prog._arrays[mo["key"]]
            extra = (f"  (member operand built here: {tuple(op.shape)} "
                     f"int64, {op.numel() * op.element_size()} bytes)")
        pp = prog.plan.get(("a", "t", "p"), {})
        if pp.get("pmode") == "slot_rank":
            extra = (f"  (slot plane built here: {pp['slotk']} over "
                     f"{pp['layout'].n_rows} rows, ns {pp['nslots']}; "
                     f"batch_cap {prog.batch_cap})")
        say(f"  {name}: planned in {time.time() - t0:.2f}s{extra}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "tantivy_aggregations_tpu_torch").is_dir():
        print("chip_smoke: tantivy_aggregations_tpu_torch not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.models import flagship
    from tantivy_aggregations_tpu_torch.ops import kernels as K
    from tantivy_aggregations_tpu_torch.query import compile as qc
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.time()
    phases = {}

    def lap(phase, t0):
        phases[phase] = time.time() - t0
        say(f"    [{phase}: {phases[phase]:.1f}s]")

    t0 = time.time()
    card = phase_versions(torch, K)
    lap("versions", t0)
    t0 = time.time()
    phase_build(K)
    lap("build", t0)
    t0 = time.time()
    idx = phase_index(tt, flagship)
    lap("index", t0)
    t0 = time.time()
    searcher = idx.searcher(device="cuda")
    phase_plan(torch, searcher, flagship)
    lap("plan", t0)
    t0 = time.time()
    records = phase_kernels(torch, K, qc, tt, searcher, flagship)
    lap("kernels", t0)
    oracle = idx.oracle_searcher()
    counts = dict.fromkeys(K.launches, 0)
    for path in PATHS:
        t0 = time.time()
        for k, n in phase_main_path(torch, K, tt, idx, searcher, oracle,
                                    flagship, card, path).items():
            counts[k] += n
        lap(f"main path {path[0]}", t0)
    check(set(records) == set(K.launches),
          f"kernel records {sorted(records)} != kernels "
          f"{sorted(K.launches)}")
    for name, rec in records.items():
        check(counts[name] > 0, f"kernel {name} was never launched")
        rec["launches"] = counts[name]
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    say(f"whole run {time.time() - t_run:.1f}s: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in phases.items()))
    say(json.dumps({"kernels": list(records.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
