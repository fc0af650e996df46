"""Columns of the `bench10m` deployment, drawn from a seed.

Frozen copy of `tantivy_aggregations_tpu_torch/models/flagship.py::
generate_bench_columns` at commit 3b8b2ac20aec56d4702b01e08d1cd415c047bb37:
the same draws in the same order from `np.random.default_rng(seed)`, so
the same seed gives the same values. Two departures that change no value:
keyword columns come back as codes into a sorted term list (the original
builds one Python string per doc; `terms[codes]` is the same column), and
the vocabulary size and skews are read from the configuration file.

Every generator under perfbench/data/ returns the same neutral form,
which the harness hands to the port's writer and the reference reads
as is: {field: {"type": "u64" | "f64" | "date" | "keyword" | "facet",
"values": array} or, for keyword and facet fields, {"terms": sorted list
of str, "codes": int array into terms}, plus "offsets" (n_docs + 1) for a
multi-valued field, whose values or codes are then one per value row}.
"""

import numpy as np

STATUSES = ["active", "archived", "deleted", "pending"]
DAY_US = 86_400_000_000


def columns(n_docs: int, seed: int, params: dict) -> dict:
    card = int(params["sku_card"])
    rng = np.random.default_rng(seed)
    cols = {}
    cols["amount"] = {"type": "u64", "values": rng.integers(
        0, 10_000, n_docs, dtype=np.uint64)}
    cols["qty"] = {"type": "u64", "values": rng.integers(
        0, 100, n_docs, dtype=np.uint64)}
    cols["price"] = {"type": "f64", "values": np.round(
        rng.lognormal(3.0, 1.0, n_docs), 2)}
    cols["status"] = {"type": "keyword", "terms": list(STATUSES),
                      "codes": rng.integers(0, 4, n_docs)}
    # zipf skew over the sku vocabulary; "sku%07d" sorts as its number
    sku = rng.zipf(float(params["sku_zipf"]), n_docs) % card
    cols["sku"] = {"type": "keyword",
                   "terms": [f"sku{i:07d}" for i in range(card)],
                   "codes": sku}
    nvals = rng.integers(0, 4, n_docs)
    offsets = np.zeros(n_docs + 1, dtype=np.uint32)
    np.cumsum(nvals, out=offsets[1:])
    cols["weights"] = {"type": "u64", "offsets": offsets,
                       "values": rng.integers(0, 1000, int(offsets[-1]),
                                              dtype=np.uint64)}
    cols["ts"] = {"type": "date", "values": (
        np.uint64(1_600_000_000_000_000)
        + rng.integers(0, 30 * DAY_US, n_docs, dtype=np.uint64))}
    return cols
