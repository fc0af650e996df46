"""One run of one benchmark cell of tantivy_aggregations_tpu_torch.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic mix come from BENCHMARK.json and the files it names
(perfbench/lib/spec.py). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics; with --trace 1 its per-layer metrics), device (with --trace 1
also busy_s and window_s), breakdown (--trace 1) and, last, checks: each
number compared with its limit. Everything else goes to standard error,
whose last lines are the same checks. With no CUDA device, or fewer than
the cell asks for, it exits 2 and prints no result; it never runs on the
CPU (the CPU tests call perfbench.lib.harness.run_cell themselves).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the script's own directory must not shadow packages; the checkout's
    # root holds perfbench and the port
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path.insert(0, str(ROOT))
    cache = ROOT / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from perfbench.lib import spec
    cell = spec.workload(spec.load_benchmark(ROOT), args.workload)

    import torch
    if not torch.cuda.is_available():
        print("[perfbench] no CUDA device: nothing measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"[perfbench] {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from perfbench.lib import card, harness
    harness.log(f"[perfbench] card: {card.line()}; torch {torch.__version__},"
                f" cuda {torch.version.cuda}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS, root=ROOT)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
