"""What the prep cache saves at a restart: c1-c10's plans at the default
EngineConfig on a fresh searcher (a new DeviceIndex, so every layout, cube
operand, block histogram and top_hits order is built or read again) with
the cache off (TAT_PREP_CACHE=0: every artifact built, nothing written),
cold (the cache directory emptied: built and saved) and warm (read from
`<index>/.prep_cache_torch/`), in turns, on the bench index (built on
first use under .bench_cache/): three turns unsharded, one on a 4-shard
mesh (four cards where there are four, else four shards on cuda:0).
Prints each plan's seconds (the device index's load included, and per
config) and the cache's counters, the medians, the card's name and power
limit. Ends with "OK".

    python3 scripts/torch_prep_plan.py
"""
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.utils import prep_cache as PC  # noqa
from tantivy_aggregations_tpu_torch.utils import stats  # noqa: E402

MODES = ("off", "cold", "warm")


def plan_all(idx, mode: str, devices=None) -> float:
    """Seconds to plan c1-c10 on a fresh searcher (on `devices` as a mesh
    where given) with the cache `mode`."""
    if mode == "cold":
        shutil.rmtree(Path(idx.path) / PC.DIR_NAME, ignore_errors=True)
    os.environ["TAT_PREP_CACHE"] = "0" if mode == "off" else "1"
    ix = tt.Index.open(idx.path)
    s = (ix.searcher(device=S.DEVICE) if devices is None
         else ix.searcher(mesh=tt.make_mesh(devices=devices)))
    stats.reset_prep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    each = []
    for n, _, q, aggs in S.all_configs(flagship):
        t1 = time.perf_counter()
        s._program_for(q, aggs)
        torch.cuda.synchronize()
        each.append(f"c{n} {time.perf_counter() - t1:.3f}")
    t = time.perf_counter() - t0
    c = dict(stats.prep_cache)
    S.say(f"  {'unsharded' if devices is None else 'mesh'} {mode}: "
          f"{t:.3f}s ({S._prep_io(c)}); " + ", ".join(each))
    S._free(torch, s)
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    idx = S.phase_index(tt, flagship)
    devices, what = S.mesh_devices(torch, S.SHARDS)
    plan_all(idx, "off")  # the columns' first load from the segments
    for label, devs, turns in (("unsharded", None, 3),
                               (f"{S.SHARDS}-shard mesh ({what})", devices,
                                1)):
        times = {m: [] for m in MODES}
        for _ in range(turns):
            for mode in MODES:
                times[mode].append(plan_all(idx, mode, devs))
        S.say(f"c1-c10 plan seconds, {label}, median of {turns} in turns: "
              + ", ".join(f"{m} {statistics.median(v):.3f}"
                          for m, v in times.items()) + f"  [{card}]")
    os.environ.pop("TAT_PREP_CACHE", None)
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
