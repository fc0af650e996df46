"""The phases chip_smoke.py added for the compiled step, alone, for a
quick check on a CUDA card: versions and the kernel build, the bench and
tags deployments at --docs docs (built on first use under .bench_cache/),
the row-mode, default, nomop and tags searchers of chip_smoke.py's
unsharded paths, the oracle's answer to each path's own requests (c6:
its numpy reference), then phase 5g (every program's CUDA graph at B = 1,
3 -> 4 and a full group == its raw_fn and the oracle, the replays'
credited launches == the eager step's and == the kernel nodes of each
graph, every graph again in a shuffled order, the graphs' memory, three
graphs dropped for a budget and captured again) and phase 5t (c1-c10 in
row modes and at the default config through the graph and through
raw_fn, B = 1 and 128, and c2's group of 65 padded to 128). Prints each
part's seconds, a {"graph_step": ...} JSON line, and ends with "OK"; any
failure raises.

    python3 scripts/torch_graph_phases.py [--docs N]
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.aggs import compile as AC  # noqa: E402
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000,
                    help="docs of both deployments (chip_smoke.py: 10M)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    S.DOCS = args.docs
    # every graph keeps its nodes, so phase 5g reads the kernels in each
    AC._StepGraph.keep_nodes = True
    t_run = time.time()
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    t0 = time.time()
    idx = S.phase_index(tt, flagship)
    tags = S.phase_tags_index(tt)
    lap("indexes", t0)
    t0 = time.time()
    row = idx.searcher(device="cuda", config=EngineConfig(**S.ROW_MODES))
    searchers = {"row": row, "tags": tags.searcher(device="cuda")}
    for label, cfg in (("default", {}), ("nomop", S.NOMOP)):
        s = searchers[label] = idx.searcher(device="cuda",
                                            config=EngineConfig(**cfg))
        s._device_index = row._get_device_index()
        s._device_epoch = row._device_epoch
    oracles = {"bench": idx.oracle_searcher(),
               "tags": tags.oracle_searcher()}
    answers = {}
    for label, key, name, s, q, aggs, _ in S.graph_programs(tt, flagship,
                                                             searchers):
        dep = "tags" if s is searchers["tags"] else "bench"
        answers[(key, repr(q), repr(aggs))] = (
            S.c6_reference(tt, idx, q, aggs) if key == 6
            else oracles[dep].agg_search(q, aggs))
    lap(f"the oracle's {len(answers)} answers", t0)
    t0 = time.time()
    replayed = S.phase_graphs(torch, K, C, R, qc, tt, flagship, searchers,
                              answers, card)
    lap("graphs", t0)
    t0 = time.time()
    step = S.phase_step_timings(torch, flagship, searchers, card)
    step["graph_memory_5g"] = replayed["memory"]
    lap("step timings", t0)
    S.say(json.dumps({"graph_step": step, "nodes_5g": replayed["nodes"],
                      "credited_5g": replayed["credited"]}))
    lap("total", t_run)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
