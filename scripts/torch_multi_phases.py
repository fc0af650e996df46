"""The multi-valued phases of chip_smoke.py alone, for a quick check on
one CUDA card: versions and the kernel build, the bench index and the
tags deployment (built on first use under .bench_cache/), phase 3m (the
multi-valued requests' plans vs MULTI_MODES), phase 4m (the chain kernels
on the multi-valued layouts, exact == their plain versions, timed), the
phase-4b every-opcode program (OP_GT_IMM included) at B = 1, 33 and 128,
the "multi" and "tags" main paths, mv4 on the host path and phase 5d.
Prints each part's seconds and ends with "OK"; any failure raises.

    python3 scripts/torch_multi_phases.py
"""
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.engine_config import \
    EngineConfig  # noqa: E402
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
    tags_idx = S.phase_tags_index(tt)
    lap("indexes", t0)
    row = idx.searcher(device="cuda", config=EngineConfig(**S.ROW_MODES))
    dflt = idx.searcher(device="cuda")
    dflt._device_index = row._get_device_index()
    dflt._device_epoch = row._device_epoch
    searchers = {"row": row, "default": dflt,
                 "tags": tags_idx.searcher(device="cuda")}
    t0 = time.time()
    S.phase_plan_multi(torch, {"bench": dflt, "tags": searchers["tags"]})
    lap("plan", t0)
    records = {n: {"name": n, "max_abs_err": 0} for n in K.launches}
    t0 = time.time()
    S.phase_kernels_multi(torch, K, qc, tt, searchers, records)
    rng = np.random.default_rng(S.SEED)
    for B in (1, 33, 128):
        args = S.edge_operands(torch, qc, 32768, B, rng)
        for name, a in (("chain_counts", args[:4]), ("chain_blocks", args)):
            err = S._check_equal(torch, name, "edge", getattr(K, name)(*a),
                                 getattr(K, name + "_plain")(*a))
            S.say(f"  {name} every-opcode edge program B={B}: max_abs_err "
                  f"{err}")
    lap("kernels", t0)
    oracles = {"bench": idx.oracle_searcher(),
               "tags": tags_idx.oracle_searcher()}
    answers = {}
    for label, dep, names, kernels, prods, prof in S.MULTI_PATHS:
        if label not in ("multi", "tags"):
            continue  # scripts/torch_select_phases.py runs the others
        t0 = time.time()
        cfgs = [(nm, nm, *S.multi_requests(tt, nm, 0)) for nm in names]
        S.phase_main_path(
            torch, K, C, R, tt, idx if dep == "bench" else tags_idx,
            searchers["default" if dep == "bench" else "tags"],
            oracles[dep], flagship, card, (label, names, kernels, prods, {}),
            answers, configs=cfgs, varied=S.multi_varied(tt),
            profiled=prof, n_checked=S.MULTI_CHECKED)
        lap(f"path {label}", t0)
    q, aggs = S.multi_requests(tt, "mv4", 0)
    S.check(dflt.agg_search(q, aggs) == oracles["bench"].agg_search(q, aggs),
            "mv4 (host path) != oracle")
    S.phase_doc_space(torch, tt)
    lap("total", t_run)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
