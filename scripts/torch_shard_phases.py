"""The phases chip_smoke.py added for sharded meshes, replica groups and
the prep cache, alone, for a quick check on CUDA cards: versions and the
kernel build, the bench index at --docs docs (built on first use under
.bench_cache/), the default path c1-c10 (its oracle answers and timings;
the oracle's answers of mv1, p1 and h2 on worker processes meanwhile),
then phase 10 (the prep cache's cold and warm plans, unsharded), 7-8 (the
sharded path on a 4-shard mesh, through the mesh's graphs on one card),
8t (its step through graphs vs the eager raw_fn), 8k (its kernels on the
shards' operands), 8g (every mesh program's graphs == raw_fn and the
oracle, their kernel nodes == the credited launches, shuffled among
unsharded graphs; p1's phase-2 graphs on the mesh), 10 again (the mesh's
warm plan), 9 (replica groups) and 11 (the device guard). With --8g only
phases 7-8, 8t and 8g follow the default path. Prints each part's
seconds, a {"mesh_graphs": ...} JSON line, and ends with "OK"; any
failure raises.

    python3 scripts/torch_shard_phases.py [--docs N] [--8g]
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.aggs import compile as AC  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import cube as C  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import reductions as R  # noqa: E402
from tantivy_aggregations_tpu_torch.query import compile as qc  # noqa: E402


def lap(label, t0):
    S.say(f"{label} {time.time() - t0:.1f}s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=S.DOCS,
                    help="docs of the bench index (chip_smoke.py: 10M)")
    ap.add_argument("--8g", dest="only_8g", action="store_true",
                    help="phases 7-8, 8t and 8g only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    S.DOCS = args.docs
    # every graph keeps its nodes, so phase 8g reads the kernels in each
    AC._StepGraph.keep_nodes = True
    t_run = time.time()
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    t0 = time.time()
    idx = S.phase_index(tt, flagship)
    lap("index", t0)
    pool = S.OraclePool(max(1, min(3, (os.cpu_count() or 2) - 2)))
    try:
        answers, timings = {}, {}
        for nm in ("h2", "p1", "mv1"):
            q, aggs = S.multi_requests(tt, nm, 0)
            answers[(nm, repr(q), repr(aggs))] = pool.submit(idx.path, q,
                                                             aggs)
        dflt = idx.searcher(device="cuda")
        oracle = idx.oracle_searcher()
        t0 = time.time()
        S.phase_main_path(torch, K, C, R, tt, idx, dflt, oracle, flagship,
                          card, S.PATHS[3], answers, timings=timings,
                          profiled=())
        lap("default path", t0)
        if not args.only_8g:
            t0 = time.time()
            S.phase_prep(torch, tt, idx, flagship, card, answers)
            lap("prep unsharded", t0)
        t0 = time.time()
        _, s4, steps = S.phase_sharded(torch, K, C, R, tt, idx, dflt, oracle,
                                       flagship, card, answers, timings)
        lap("sharded", t0)
        if not args.only_8g:
            t0 = time.time()
            S.phase_shard_kernels(torch, K, qc, s4, flagship,
                                  {n: {"max_abs_err": 0} for n in K.launches})
            lap("shard kernels", t0)
        t0 = time.time()
        mesh = S.phase_mesh_graphs(torch, K, C, R, tt, flagship, s4, dflt,
                                   answers, card)
        lap("mesh graphs", t0)
        S.say(json.dumps({"mesh_graphs": {
            "mesh_steps": steps, "credited_8g": mesh["credited"],
            "nodes_8g": mesh["nodes"], "graph_nodes": mesh["graph_nodes"],
            "capture_s": mesh["capture_s"],
            "memory": S.graph_memory(torch, torch.device("cuda"))}}))
        mesh4 = [str(d) for d in s4._get_device_index().devices]
        S._free(torch, s4)
        if args.only_8g:
            lap("total", t_run)
            S.say("OK")
            return 0
        t0 = time.time()
        S.phase_prep(torch, tt, idx, flagship, card, answers, mesh4)
        lap("prep sharded", t0)
        t0 = time.time()
        S.phase_replicas(torch, K, C, R, tt, idx, dflt, flagship, card)
        lap("replicas", t0)
        S.phase_device_guard(torch, K, qc, tt, idx, flagship,
                             lambda n, q, a: S._answer(
                                 answers, (n, repr(q), repr(a))))
    finally:
        pool.terminate()
    lap("total", t_run)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
