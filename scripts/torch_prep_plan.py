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
limit. Then why the dense products' bf16 operands stay out of the cache:
c3's plan with the cache off (its operands built on the card) beside the
time to read those operands back from `.npz` files in the cache directory
(saved under a probe key, removed after), three times each in turns. Ends
with "OK".

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


def dense_read_back(idx) -> tuple:
    """(c3's plan seconds with the cache off, seconds to read its dense
    operands back from .npz files onto the card, their MiB)."""
    os.environ["TAT_PREP_CACHE"] = "0"
    _, q, aggs = flagship.judged_configs()[2]
    s = tt.Index.open(idx.path).searcher(device=S.DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s._program_for(q, aggs)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    ops = [v for k, v in s._get_device_index().cube_cache.items()
           if k[0] == "dmm"]
    S.check(ops, "c3 planned no resident dense operand")
    os.environ["TAT_PREP_CACHE"] = "1"
    keys = [("dense-probe", i) for i in range(len(ops))]
    for k, op in zip(keys, ops):
        PC.save(idx.path, "probe", 1, k, {"a": op.view(torch.int16).cpu()
                                          .numpy()})
    S._free(torch, s)
    del ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mib = 0.0
    for k in keys:
        a = PC.load(idx.path, "probe", 1, k)["a"]
        op = torch.from_numpy(a).to(S.DEVICE).view(torch.bfloat16)
        mib += a.nbytes / 2**20
        del a, op
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    shutil.rmtree(Path(idx.path) / PC.DIR_NAME, ignore_errors=True)
    return t_plan, t_read, mib


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
    plan, read = [], []
    for _ in range(3):
        t_plan, t_read, mib = dense_read_back(idx)
        plan.append(t_plan)
        read.append(t_read)
        S.say(f"  c3 plan, cache off: {t_plan:.3f}s; its dense operands "
              f"({mib:.1f} MiB) read back: {t_read:.3f}s")
    S.say(f"c3 plan with the cache off {statistics.median(plan):.3f}s vs "
          f"its dense operands read back {statistics.median(read):.3f}s, "
          f"medians of 3  [{card}]")
    os.environ.pop("TAT_PREP_CACHE")
    S.say("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
