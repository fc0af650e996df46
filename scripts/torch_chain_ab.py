"""The chain tile kernels (chain_blocks, chain_counts, chain_slot_counts)
of this tree and of the port packages in the trees at DIR..., in turns on
the main path's operands (chip_smoke phase 4's: c4's sku layout under
MatchAll with sum(amount), c5's price layout under c5's Range chain, c9's
under its Range chain and status slot plane; 10M-doc bench index), at
B = 1 and 128. Prints each tree's ptxas report, then per case the median
CUDA-event ms of every tree over `ROUNDS` rounds of turns (trees in order,
then reversed) and its ratio to the first DIR; every output == this
tree's. Needs one CUDA card.

    python3 scripts/torch_chain_ab.py DIR [DIR ...]

(DIR: a tree holding a `tantivy_aggregations_tpu_torch/` package, say one
unpacked with `git archive <commit> tantivy_aggregations_tpu_torch` under a
gitignored directory.)
"""
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.query import compile as qc  # noqa: E402

#: rounds of turns per case (each round runs every tree twice)
ROUNDS = 3


def main(dirs) -> int:
    if not torch.cuda.is_available() or not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    trees = [("this tree", K)]
    for i, d in enumerate(dirs):
        mod = S.load_against(d, f"tat_ab{i}")
        lib = mod.build()
        S.say(f"[ptxas of {d}]")
        S._say_ptxas(lib)
        trees.append((d, mod))
    idx = S.phase_index(tt, flagship)
    searcher = idx.searcher(device="cuda")
    cfgs = {n: (q, a) for n, _, q, a in S.all_configs(flagship)}
    cases = []
    for B in (1, 128):
        for n, name, args_of in ((4, "chain_blocks", S._chain_blocks_args),
                                 (5, "chain_counts", S._chain_counts_args),
                                 (9, "chain_slot_counts",
                                  S._chain_slot_args)):
            q, aggs = cfgs[n]
            prog = searcher._program_for(q, aggs)
            reqs = flagship.varied_requests(n, aggs, B)
            pm = qc.param_matrix([prog._extract(rq, ra) for rq, ra in reqs],
                                 prog._pkeys, prog.device)
            cases.append((f"c{n}", name, B, args_of(prog, pm)))
    S.say(f"[chain kernels in turns, {ROUNDS} rounds; {card}]")
    for label, name, B, args in cases:
        fns = [getattr(mod, name) for _, mod in trees]
        want = fns[0](*args)
        for (d, _), f in zip(trees[1:], fns[1:]):
            S._check_equal(torch, name, f"{label} B={B} {d}", f(*args), want)
        times = [[] for _ in trees]
        order = list(range(len(trees)))
        for _ in range(ROUNDS):
            for i in order + order[::-1]:
                times[i].append(S._cuda_ms(torch, lambda f=fns[i]: f(*args),
                                           30))
        med = [statistics.median(t) for t in times]
        S.say(f"  {name:17s} {label} B={B:<4d} " + "; ".join(
            f"{d} {m:.4f} ms ({m / med[1]:.3f}x)"
            for (d, _), m in zip(trees, med)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
