"""The phases chip_smoke.py added for sharded meshes, replica groups and
the prep cache, alone, for a quick check on CUDA cards: versions and the
kernel build, the bench index (built on first use under .bench_cache/),
the default path c1-c10 (its oracle answers and timings; the oracle's
answers of mv1, p1 and h2 on worker processes meanwhile), then phase 10
(the prep cache's cold and warm plans, unsharded), 7-8 (the sharded path
on a 4-shard mesh), 8k (its kernels on the shards' operands), 10 again
(the mesh's warm plan), 9 (replica groups) and 11 (the device guard). Prints each part's seconds and ends with "OK";
any failure raises.

    python3 scripts/torch_shard_phases.py
"""
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import cube as C  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import reductions as R  # noqa: E402
from tantivy_aggregations_tpu_torch.query import compile as qc  # noqa: E402


def lap(label, t0):
    S.say(f"{label} {time.time() - t0:.1f}s")


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
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
        t0 = time.time()
        S.phase_prep(torch, tt, idx, flagship, card, answers)
        lap("prep unsharded", t0)
        t0 = time.time()
        _, s4 = S.phase_sharded(torch, K, C, R, tt, idx, dflt, oracle,
                                flagship, card, answers, timings)
        lap("sharded", t0)
        t0 = time.time()
        S.phase_shard_kernels(torch, K, qc, s4, flagship,
                              {n: {"max_abs_err": 0} for n in K.launches})
        mesh4 = [str(d) for d in s4._get_device_index().devices]
        S._free(torch, s4)
        lap("shard kernels", t0)
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
