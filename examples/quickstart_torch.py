"""Quickstart of the PyTorch / CUDA port: build an index, run aggregations,
use msearch batching — the steps of examples/quickstart.py, one for one.

Run from the repo root: python examples/quickstart_torch.py [--device cuda]
The searcher runs on the card (`--device cuda`, the default; it never
falls back to the CPU) or, when asked, on the CPU (`--device cpu`)."""

import argparse
import os
import sys

# make `python examples/quickstart_torch.py` work without an install: the
# interpreter puts examples/ (not the cwd) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import tantivy_aggregations_tpu_torch as tt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the searcher's device: cuda (default) or cpu")
    device = ap.parse_args(argv).device
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("quickstart_torch: no CUDA device (pass --device cpu to "
                  "run on the CPU)", file=sys.stderr)
            return 2

    schema = (tt.SchemaBuilder()
              .add_u64_field("amount")
              .add_f64_field("price")
              .add_date_field("ts")
              .add_keyword_field("status")
              .add_keyword_field("tags", cardinality=tt.Cardinality.MULTI)
              .add_text_field("title")
              .build())

    idx = tt.Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(0)
    n = 50_000
    day = 86_400_000_000
    w.add_documents_columnar({
        "amount": rng.integers(0, 10_000, n, dtype=np.uint64),
        "price": np.round(rng.lognormal(3, 1, n), 2),
        "ts": np.uint64(1_600_000_000_000_000) + rng.integers(
            0, 30 * day, n, dtype=np.uint64),
        "status": np.array(["active", "archived"], object)[
            rng.integers(0, 2, n)],
        "title": [f"item {i % 97} deluxe" for i in range(n)],
    }, n)
    w.commit()

    query = tt.BooleanQuery(must=[tt.TermQuery("status", "active"),
                                  tt.RangeQuery("amount", lower=100)])
    tree = {"n": tt.count_agg(),
            "revenue": tt.sum_agg("price"),
            "stats": tt.stats_agg("amount"),
            "p": tt.percentiles_agg("price"),
            "daily": tt.date_histogram_agg(
                "ts", interval_micros=day,
                sub_aggs={"rev": tt.sum_agg("price")}),
            "words": tt.terms_agg("title", size=5)}
    searcher = idx.searcher(device=device)
    result = searcher.agg_search(query, tree)
    print("matched:", result["n"]["value"])
    print("revenue:", result["revenue"]["value"])
    print("p50 price:", result["p"]["values"]["50.0"])
    print("first day:", result["daily"]["buckets"][0])
    print("top words:", [(b["key"], b["doc_count"])
                         for b in result["words"]["buckets"]])

    # msearch: many same-shape queries in one batched dispatch
    queries = [tt.RangeQuery("amount", lower=int(lo), upper=int(lo) + 2000)
               for lo in range(0, 8000, 1000)]
    aggs = {"n": tt.count_agg(), "s": tt.sum_agg("price")}
    for q, r in zip(queries,
                    searcher.agg_search_batch([(q, aggs) for q in queries])):
        print(q.lower, "->", r["n"]["value"], round(r["s"]["value"], 2))

    # everything above is bit-identical to the sequential oracle
    if result != idx.oracle_searcher().agg_search(query, tree):
        print("oracle parity: MISMATCH", file=sys.stderr)
        return 1
    print("oracle parity: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
