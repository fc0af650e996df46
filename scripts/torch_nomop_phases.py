"""The phases chip_smoke.py added for EngineConfig.use_member_ops and the
port's quickstart, alone, for a quick check on a CUDA card: versions and
the kernel build, the bench index (built on first use under
.bench_cache/), c1-c10 planned in row modes and at the default config,
then phase 3n (c7 at use_member_ops=False plans chain_blocks, no member
operand), phase 4 (every kernel == its plain version, chain_blocks also on
c7's operands without the member operand), the "default" path (c1-c10)
and the "nomop" path (c7: chain_blocks launched, gather_rows not), c7's
times both ways, and phase 5q (examples/quickstart_torch.py on cuda).
Prints each part's seconds and ends with "OK"; any failure raises.

    python3 scripts/torch_nomop_phases.py
"""
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
    t0 = time.time()
    row = idx.searcher(device="cuda", config=EngineConfig(**S.ROW_MODES))
    S.phase_plan(torch, row, flagship)
    searchers = {"row": row}
    for label, cfg in (("default", {}), ("nomop", S.NOMOP)):
        s = searchers[label] = idx.searcher(device="cuda",
                                            config=EngineConfig(**cfg))
        s._device_index = row._get_device_index()
        s._device_epoch = row._device_epoch
    S.phase_plan(torch, searchers["default"], flagship,
                 "default EngineConfig", S.DEFAULT_MODES)
    S.phase_plan_nomop(searchers["nomop"], flagship)
    lap("plans", t0)
    t0 = time.time()
    S.phase_kernels(torch, K, qc, tt, row, flagship, None,
                    searchers["nomop"])
    lap("kernels", t0)
    oracle = idx.oracle_searcher()
    answers, timings = {}, {}
    for path in (S.PATHS[3], S.PATHS[4]):
        t0 = time.time()
        S.phase_main_path(torch, K, C, R, tt, idx, searchers[path[0]],
                          oracle, flagship, card, path, answers, reps=3,
                          timings=timings,
                          profiled=(7,) if path[0] == "nomop" else ())
        lap(f"main path {path[0]}", t0)
    for label in ("default", "nomop"):
        p50, on, off = timings[(label, "c7_terms_prefix_multiquery")]
        S.say(f"[5n] c7 {label}: p50 {p50:.3f} ms, msearch {on:.4f} ms/q "
              f"dedup on, {off:.4f} ms/q dedup off  [{card}]")
    t0 = time.time()
    S.phase_quickstart()
    lap("quickstart", t0)
    lap("total", t_run)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
