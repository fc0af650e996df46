"""The phases chip_smoke.py added for the rest of the agg surface, alone,
for a quick check on one CUDA card: versions and the kernel build, the
bench index and the tags deployment with its facet field (built on first
use under .bench_cache/), the oracle's answers on worker processes, phase
3m (every multi-valued, select and catalog request's plan vs MULTI_MODES,
the host-path shapes), the "select" and "catalog" main paths, the
host-path shapes == the oracle, phase 5p (phase 2 == the integer path's
rows) and phase 5s (the stream == the batch). Prints each part's seconds
and ends with "OK"; any failure raises.

    python3 scripts/torch_select_phases.py
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
from tantivy_aggregations_tpu_torch.engine_config import \
    EngineConfig  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import cube as C  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import reductions as R  # noqa: E402


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
    tags_idx = S.phase_tags_index(tt)
    lap("indexes", t0)
    pool = S.OraclePool(max(1, min(4, (os.cpu_count() or 2) - 2)))
    try:
        answers = {}
        S.prefetch_answers(tt, pool, {"bench": idx.path,
                                      "tags": tags_idx.path}, answers)
        row = idx.searcher(device="cuda", config=EngineConfig(**S.ROW_MODES))
        dflt = idx.searcher(device="cuda")
        dflt._device_index = row._get_device_index()
        dflt._device_epoch = row._device_epoch
        searchers = {"row": row, "default": dflt,
                     "tags": tags_idx.searcher(device="cuda")}
        t0 = time.time()
        S.phase_plan_multi(torch, {"bench": dflt, "tags": searchers["tags"]})
        lap("plan", t0)
        oracles = {"bench": idx.oracle_searcher(),
                   "tags": tags_idx.oracle_searcher()}
        for label, dep, names, kernels, prods, prof in S.MULTI_PATHS:
            if label not in ("select", "catalog"):
                continue
            t0 = time.time()
            cfgs = [(nm, nm, *S.multi_requests(tt, nm, 0)) for nm in names]
            S.phase_main_path(
                torch, K, C, R, tt, idx if dep == "bench" else tags_idx,
                searchers["default" if dep == "bench" else "tags"],
                oracles[dep], flagship, card,
                (label, names, kernels, prods, {}), answers, configs=cfgs,
                varied=S.multi_varied(tt), profiled=prof,
                n_checked=S.MULTI_CHECKED)
            lap(f"path {label}", t0)
        pool.close()
        t0 = time.time()
        for name in S.HOST_SHAPES:
            q, aggs = S.multi_requests(tt, name, 0)
            S.check(dflt.agg_search(q, aggs)
                    == oracles["bench"].agg_search(q, aggs),
                    f"{name} (host path) != oracle")
            S.say(f"[5m] {name} on the host path == the oracle")
        lap("host shapes", t0)
        t0 = time.time()
        S.phase_phase2_rows(torch, tt, searchers, card)
        lap("phase 2 rows", t0)
        t0 = time.time()
        S.phase_stream(torch, tt, searchers, card)
        lap("stream", t0)
    finally:
        pool.terminate()
    lap("total", t_run)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
