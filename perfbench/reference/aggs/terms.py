"""Terms of a keyword field: doc_count counts value occurrences (by
weight), buckets ordered by doc_count descending, ties by key ascending,
the first `size` (default 10) kept, the rest's doc_counts summed in
sum_other_doc_count; the sub-aggs see a doc once per occurrence of the
bucket's term."""

import numpy as np


def evaluate(ref, args, w):
    field = args["field"]
    if args.get("order", ["_count", "desc"]) != ["_count", "desc"]:
        raise NotImplementedError("the reference orders terms by count")
    c = ref.col(field)
    if "codes" not in c:
        raise NotImplementedError("the reference groups keyword fields "
                                  "only: terms over numeric fields are out")
    size = int(args.get("size", 10))
    counts = ref.counts(c["codes"], ref.row_weights(field, w),
                        len(c["terms"]))
    present = np.nonzero(counts)[0]
    # terms are sorted, so code order is key order
    ranked = present[np.lexsort((present, -counts[present]))]
    top = ranked[:size].tolist()
    buckets = [{"key": c["terms"][code], "doc_count": int(counts[code])}
               for code in top]
    subs = args.get("aggs", {})
    if subs:
        for b, f in zip(buckets, ref.bucket_subaggs(
                subs, field, c["codes"], w, len(c["terms"]), top,
                lambda code: ref.occurrences(field, code))):
            b.update(f)
    return {"buckets": buckets,
            "sum_other_doc_count": int(counts[ranked[size:]].sum())}
