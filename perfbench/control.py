"""The control of the comparison that decides `correct`: the reference in
float32 (perfbench/reference/engine.py, lossy=True) put in the port's
place, one precision below the exact answers the configurations
guarantee. It must come out not correct.

    python perfbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it draws the columns at the configuration's size and the
cell's pool, answers each sampled request with the exact reference and
with the control, and prints, per seed, the sampled requests and how
many of the control's answers differ (the number a run compares, whose
limit is 0), on the last line one JSON object of the readings. It needs
no card and imports nothing of the port.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, docs: int = None, root=ROOT) -> dict:
    """{"requests": sampled distinct requests, "mismatched_answers": the
    control's answers that differ from the exact reference's,
    "exact_mismatched": the exact reference against itself, run twice}."""
    from perfbench.lib import spec
    from perfbench.lib.traffic_gen import Pool
    from perfbench.reference.engine import Reference
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    cfg = spec.config(bench, cell["config"], root)
    n = int(docs or cfg["docs"])
    cols = spec.generator(cfg["generator"], root)(n, seed, cfg["params"])
    pool = Pool(spec.mix(cell["traffic"], root), seed)
    reqs = [pool.requests[pool.keys.index(k)] for k in pool.check_keys]
    exact, again, lossy = (Reference(cols, n), Reference(cols, n),
                           Reference(cols, n, lossy=True))
    out = {"requests": len(reqs), "mismatched_answers": 0,
           "exact_mismatched": 0}
    for r in reqs:
        want = exact.answer(r)
        out["exact_mismatched"] += again.answer(r) != want
        out["mismatched_answers"] += lossy.answer(r) != want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    res = {}
    for s in args.seeds:
        t = time.perf_counter()
        res[s] = readings(args.workload, s)
        print(f"[control] {args.workload} seed {s}: {res[s]} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr,
              flush=True)
    print(json.dumps({"workload": args.workload, "readings": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
