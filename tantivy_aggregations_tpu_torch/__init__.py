"""tantivy_aggregations_tpu_torch — the PyTorch / CUDA port of the engine.

Same capability surface and exactness contract as the JAX package
``tantivy_aggregations_tpu`` (Elasticsearch-style aggregations over a
tantivy-like segment index, every fruit bit-identical to the NumPy oracle),
re-hosted on PyTorch for one NVIDIA H100:

- The host layer (schema, segments, writer, query/agg IR, oracle) is a
  copy of the JAX package's jax-free modules, so both packages read and
  write the same on-disk index.
- Fast-field columns are device-resident int32/int8 planes in the same
  encoding as the JAX package (index/loader.py).
- Programs are batch-first: every request group runs as one ``[B, P]``
  int32 parameter matrix through eager torch ops, five hand-written CUDA
  kernels (csrc/kernels.cu, bound in ops/kernels.py: fused masked
  metrics, per-32-row chain-mask counts + payload sums, per-128-row
  chain-mask counts, per-slot chain-mask counts, and member-operand row
  gathers) and exact matrix products on the tensor cores: the value-domain
  cube's (ops/cube.py) and the dense bucket products
  (ops/reductions.py).

The device path serves the judged configs c1-c5 and the extra configs
c6-c10 (models/flagship.py) at the JAX package's default EngineConfig
(the cube and the dense products on; ``EngineConfig(use_cube=False,
dense_mxu=False)`` asks for the row modes). An agg tree the planner
cannot lower answers on the exact host path (the copied oracle), with one
warning on the package logger, and so does a request whose set-query runs
exceed its program's run slots. Nothing here imports jax.

Scale-out, as in the JAX package: ``make_mesh`` (parallel/shard.py) and
``Index.searcher(mesh=...)`` shard the doc axis over several devices, one
program body per shard meeting at exact collectives (one process, a thread
per shard); ``ReplicatedSearcher`` (parallel/replica.py) serves msearch
groups round-robin from R full copies. One-time prep artifacts persist in
``<index>/.prep_cache_torch/`` (utils/prep_cache.py).
"""

from .schema import Schema, FieldType, Cardinality, SchemaBuilder
from .index.index import Index
from .index.merge_policy import LogMergePolicy
from .searcher import Searcher
from .parallel.shard import make_mesh
from .parallel.replica import ReplicatedSearcher
from .query.ir import (
    MatchAllQuery,
    TermQuery,
    RangeQuery,
    BooleanQuery,
    ExistsQuery,
    PhraseQuery,
    PrefixQuery,
    TermSetQuery,
    FuzzyTermQuery,
    RegexQuery,
)
from .aggs.ir import (
    count_agg,
    sum_agg,
    min_agg,
    max_agg,
    avg_agg,
    stats_agg,
    percentiles_agg,
    histogram_agg,
    date_histogram_agg,
    terms_agg,
    facet_agg,
    filter_agg,
    post_filter_agg,
    top_hits_agg,
)
from .aggs import ir as _agg_ir

# typed aliases (reference ergonomics): sum_agg_f64, terms_agg_str, ...
for _n in dir(_agg_ir):
    if _n.endswith(("_u64", "_i64", "_f64", "_date", "_str")):
        globals()[_n] = getattr(_agg_ir, _n)
del _n

__version__ = "0.1.0"

__all__ = [
    "Schema",
    "SchemaBuilder",
    "FieldType",
    "Cardinality",
    "Index",
    "LogMergePolicy",
    "Searcher",
    "make_mesh",
    "ReplicatedSearcher",
    "MatchAllQuery",
    "TermQuery",
    "RangeQuery",
    "BooleanQuery",
    "ExistsQuery",
    "PhraseQuery",
    "PrefixQuery",
    "TermSetQuery",
    "FuzzyTermQuery",
    "RegexQuery",
    "count_agg",
    "sum_agg",
    "min_agg",
    "max_agg",
    "avg_agg",
    "stats_agg",
    "percentiles_agg",
    "histogram_agg",
    "date_histogram_agg",
    "terms_agg",
    "facet_agg",
    "filter_agg",
    "post_filter_agg",
    "top_hits_agg",
]
