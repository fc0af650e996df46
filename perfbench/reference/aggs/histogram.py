"""Fixed-interval histogram of a numeric field: key index
floor((v - offset) / interval) per value in exact arithmetic
(Reference.bucket_keys), non-empty buckets only, keys ascending, the
bucket key offset + index * interval (Reference.bucket_key); doc_count
counts value occurrences (by weight), and the sub-aggs see a doc once
per occurrence in the bucket."""

import numpy as np


def evaluate(ref, args, w):
    field = args["field"]
    interval, offset = args["interval"], args.get("offset", 0)
    rw = ref.row_weights(field, w)
    live = rw > 0
    keys = ref.bucket_keys(field, interval, offset, live)
    lk = keys[live]
    if lk.size == 0:
        return {"buckets": []}
    k0 = int(lk.min())
    counts = ref.counts(lk - k0, rw[live], int(lk.max()) - k0 + 1)
    present = np.nonzero(counts)[0].tolist()
    buckets = [{"key": ref.bucket_key(field, interval, offset, k0 + j),
                "doc_count": int(counts[j])} for j in present]
    subs = args.get("aggs", {})
    if subs:
        def occ(j):
            hit = keys == k0 + j
            if ref.multi(field):
                return np.bincount(ref.doc_of_row(field)[hit],
                                   minlength=ref.n)
            return hit
        # rows outside the live keys' span go to an extra bucket, unread
        span = int(lk.max()) - k0 + 1
        rk = np.clip(keys - k0, -1, span)
        rk[rk < 0] = span
        for b, f in zip(buckets, ref.bucket_subaggs(
                subs, field, rk, w, span + 1, present, occ)):
            b.update(f)
    return {"buckets": buckets}
