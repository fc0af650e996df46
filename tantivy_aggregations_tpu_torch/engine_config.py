"""EngineConfig: the engine's (deliberately small) tuning surface.

The reference has no flag system — everything is typed constructor
arguments (SURVEY.md §5); this engine keeps that posture and exposes only
the hardware-mapping knobs that plan-time mode selection uses."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EngineConfig:
    #: blocked one-hot bucket budget: bucket aggs with a flat slot space up
    #: to this size use compare-reduce; larger use prefix/scatter paths
    dense_nb: int = 256
    #: collect per-query QueryStats on the searcher (last_stats), read
    #: from the request's spans (utils/stats.py), which it turns on
    collect_stats: bool = False
    #: msearch group cap: same-shape queries per batched dispatch (one
    #: [B, P] param matrix; the chain kernels read each plane once per
    #: group); groups are dispatched back to back before any is collected.
    #: The default is the JAX package's; it has not been swept on the H100
    max_batch: int = 128
    #: dedup identical requests inside an msearch group (request-cache
    #: analog of Elasticsearch's shard request cache): a compiled program
    #: is a pure function of its extracted params, so equal param sets
    #: compute once and fan the fruits out. Serving wins; benchmarks that
    #: want to measure raw compute throughput should turn it off.
    msearch_dedup: bool = True
    #: dense bucket counts and sums over STATIC bucket-id planes (and masked
    #: sums of several planes) are int8 matrix products on the tensor cores
    #: (ops/reductions.py dense_bucket_*_mm, masked_sum_planes_mm) instead
    #: of per-query int64 index_add_; exact by 7-bit piece construction
    dense_mxu: bool = True
    #: value-domain cube lowering (ops/cube.py): trees whose parameterized
    #: query chain lives on a small single-valued domain evaluate as exact
    #: domain-indicator int8 matrix products — no per-query row pass
    use_cube: bool = True
    #: member operands: a prefix-mode bucket agg gated by ONE TermQuery on
    #: a dense multi-valued field answers from one row of a precomputed
    #: [Df_pad, n_cols * card_pad] int64 per-(value, bucket) count /
    #: payload-sum operand, copied by the gather_rows kernel — no
    #: per-query row pass (bench c7's lever); off, the chain runs the
    #: chain_blocks kernel over the bucket layout
    use_member_ops: bool = True
    #: answer a request that has no device lowering (or whose set-query
    #: runs exceed its program's slots) on the exact host path; off, the
    #: searcher raises NotImplementedError with the planner's reason
    #: instead, for a deployment whose every answer has to come from the
    #: device (the host path is orders of magnitude slower on large
    #: indexes). Port-only: the JAX package always falls back
    host_fallback: bool = True

    def validate(self) -> "EngineConfig":
        if self.dense_nb < 1:
            raise ValueError("dense_nb must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        return self
