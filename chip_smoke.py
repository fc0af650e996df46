#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives tantivy_aggregations_tpu_torch's main path — `Searcher.agg_search`
and `agg_search_batch` over the judged configs c1-c5 and the extra configs
c6-c10 on the 10M-doc bench index (models/flagship.py, seed 42, 4 segments;
built on first use under .bench_cache/, the path bench.py uses) — and
checks it end to end. Two searchers share the device index: one in row
modes (EngineConfig use_cube=False, dense_mxu=False: the chain kernels'
paths) and one at the default EngineConfig (the JAX package's: the
value-domain cube and the dense reductions on).

1. versions of torch, CUDA and nvcc, and the card's name and power limit;
2. builds the port's CUDA kernels from csrc/ (timed);
3. builds or reuses the bench index, then plans c1-c10 in row modes
   (timed: c7's member operand and c9's slot plane are built here), each
   a device Program, never the host fallback; then at the default config
   (the cube's operands and block histograms built here), printing each
   plan's modes, which must be DEFAULT_MODES: c2, c5, c8, c9, c10 on the
   cube (c5 a pcube, c9 a scube), c3 dense_buckets (dense_mm), c1, c4,
   c6, c7 none; then the tags
   deployment (phase_tags_index: 10M docs, SEED, with the facet field
   `cat`, built on first use under .bench_cache/catalog_*), (3o) the
   oracle's answers of the select and catalog paths queued on worker
   processes (OraclePool), and (3m) the multi-valued requests at the
   default config, each a device Program with its MULTI_MODES (mv1-mv3
   and mv5-mv7 over the bench's multi-valued `weights`, t1-t3 over the
   tags deployment's keyword `tags` and wide `ids`; p1-p4 and h1-h5 on
   the bench index, tp, th and f1-f4 on the tags deployment), mv4 and the
   HOST_SHAPES the host path; (3n) c7 at use_member_ops=False (a third
   searcher on the same device index) plans prefix + chain_blocks over
   the sku layout, the chain weights' per-position planes, and no member
   operand;
4. each kernel against its plain PyTorch version at the main path's shapes
   (exact `==`), B = 1 and 128, with median CUDA-event times of both, the
   bound (kernel_bound), the device time in torch.profiler and, for
   gather_rows, the time of `index_select` (library_ms); fused_metrics
   also with min and max, and on c1's shared MatchAll mask at B = 128 (a
   batch-stride-0 view); the chain kernels also under a query whose mask
   program holds every opcode (the set opcodes through a TermSet over sku
   and one over f64 prices), on the same layouts, and at B = 31, 33 and
   200; chain_blocks on c7's operands at use_member_ops=False (B = 1 and
   128, a variant in its record); chain_blocks on c4's layout under a
   64-price TermSet and a range
   (wide_set_queries: more than 256 params); gather_rows' host time per
   call, step by step, beside index_select's (gather_host_steps);
   4b. edge cases on operands made from SEED (phase_edges), each printing
   its max_abs_err: chain_blocks, chain_counts and chain_slot_counts at
   B in {1, 31, 33, 128, 200}, R = 32768 with 8 planes (and 16 payloads)
   under a program holding every opcode, and with 16 planes and 3228
   params (wide_edge_operands),
   a tile tail, INT32_MIN / INT32_MAX payloads over fully matched blocks,
   blocks whose avalid is all 0; chain_slot_counts at ns in {1, 4, 32, 33}
   and 4096, over a slot plane with -1 rows and one-slot blocks;
   gather_rows at B in {1, 128, 200} with repeated indices, rows of one
   word, one chunk and an odd number of chunks, and the largest row it
   accepts; fused_metrics (fused_operands) with and without min and max
   at B in {1, 31, 33, 128, 200}, T below a tile and with a tile tail,
   int8 masks holding -1, 2, 127, -128, all-0 masks, INT32_MIN /
   INT32_MAX planes under full masks over 10M rows, stride-0 masks;
4p. the matrix products and dense_buckets against their plain versions
   (phase_products), exact ==, on the main path's operands at B in {1,
   17, 31, 128, 200}: cube_dots on c5's post-filter sites (and their
   count and sum(qty) == the row reduction under the same chain),
   block_counts on c5's pcube (== chain_counts' per-128-row counts summed
   to G), slot_block_counts on c9's scube (== chain_slot_counts' summed),
   dense_buckets (phase_dense) on c3's histogram and sum (its shared
   MatchAll mask), on c5's post-filter histogram of qty and its sum (B
   distinct masks) and on a value-row plane (weights' rows, amount at
   their docs) against index_add_ and, at B = 1 and 128, the bf16
   one-hot product it replaced (library_ms), and at its edges (INT32_MIN
   / INT32_MAX and +-2^15 payloads under full masks, sorted ids, T %
   4 != 0, 4096 and 100,000 buckets), masked_sum_planes_mm on c2's
   avg(weights) pre-aggregates, and cube_dots with Dprod 1003 and K 13;
   CUDA-event and torch.profiler ms, the plain version's, and the bound
   (product_bound: bytes at 3.35 TB/s or tensor operations at the int8 /
   bf16 dense peak; kernel_bound for dense_buckets); for c8 the cube
   product on a row-major operand;
4e. dense_extremes against its plain version (phase_extremes), exact ==,
   on the nyc_taxis cell's distance histogram (41,353,216 rows, 50
   buckets, made from SEED) at B = 1 and 128, on its first 2^22 rows at
   B = 3, 31, 33 and 200, and at its edges (4096 and 100,000 buckets,
   int32 extremes, sorted ids, T % 4 != 0, one extreme alone), timed on
   the nyc shape beside the two int64 scatter_reduce_ passes it replaced
   (library_ms);
5. the main path of each slice (c1-c5, then c6-c9, then c10, in row
   modes; then "default": c1-c10 at the default config, msearch timed 3
   times but c6 once; then "nomop": c7 at use_member_ops=False, timed 3
   times, one group profiled, chain_blocks launched and gather_rows not
   (NOT_LAUNCHED), its p50 and ms/q printed beside the default path's
   c7), each with the launch and product counters set to 0: for each
   config, agg_search == the port's oracle
   (c6: c6_reference, as the oracle's path for it does not finish at 10M
   docs), agg_search_batch over 256 varied requests (c6: C6_STREAM) == the
   per-query results
   (with msearch dedup on and off), distinct varied params == the oracle;
   p50 single-query latency, and msearch ms/query with dedup on and off
   beside the number of distinct requests per group; for c1, c4, c5 and
   c10 (the default path: c3, c5, c9, c10) one dedup-off group under
   torch.profiler (wall, device busy share, top device ops);
   then the "multi", "tags", "select" and "catalog" paths (MULTI_PATHS,
   the same checks at the default config, MULTI_CHECKED distinct varied
   requests per request held to the oracle; select: non-integer
   percentiles through phase 2 and top_hits; catalog: wslots' phase 2,
   top_hits under a multi-valued terms agg, facets; a profiled group's
   phase 2 timed apart), and mv4 and the HOST_SHAPES once on the host
   path == the oracle;
   On the card every unsharded Program answers through its compiled
   step: one CUDA graph per program and padded batch size, captured at
   first use (aggs/compile.py `_StepGraph`); the launch and product
   counters count what a replay launches.
   5g. the compiled step (phase_graphs): every program of the unsharded
   paths above plans its step captured; its graphs at B = 1, 3 padded to
   4 and a full group each == its raw_fn on the same param matrix
   (packed and every phase-1 tensor), their fruits == the oracle, a
   replay's credited launch and product counts == the eager step's and
   its credited launches == the kernel nodes in CUDA's own record of
   the graph (all five kernels launched from replays), then every graph
   replayed again in a shuffled order (one shared memory pool) and held
   ==; the graphs' own and pool bytes, and three graphs dropped for a
   budget below them and captured again == raw_fn;
   5t. c1-c10 in row modes and at the default config through the graph
   and through raw_fn at B = 1 and 128 (phase_step_timings), and c2's
   group of 65 padded to 128 in row modes: dispatch, wait, harvest and
   total host ms and the CUDA-event ms, fruits == both ways, the eager
   steps' peak memory beside the graph pool's reserved bytes;
   5g2. phase 2's selection as graphs (phase_phase2_graphs): p1-p4 and
   tp at B = 1, 4 and a full group, each node's replayed selection == the
   eager one on the same state, the fruits == the oracle;
   5p. phase 2's rank rows == the integer path's for the same percents,
   p1's and p2's layouts, row modes and default config, B = 1 and 128
   (phase_phase2_rows);
   5s. agg_search_stream at lookahead 1 and 2 == agg_search_batch over a
   mixed stream on each deployment (phase_stream), with ms/q and the
   device's busy share;
   5d. the doc-space shapes on the card (phase_doc_space: overflow tails,
   the CSR phrase stream, mask_gather, a cross-product expansion) == the
   oracle on a 3000-doc index made from SEED;
   5b. a RegexQuery over sku whose runs fit the 64 regex slots answers on
   a device Program, one whose runs exceed them on the exact host path,
   both == the oracle, and the Program stays cached; the host answer also
   == its three fitting thirds' device answers, merged;
   5q. examples/quickstart_torch.py on cuda, in a process of its own,
   to its oracle-parity line;
6. each slice's kernels (and the default, multi and tags paths' products)
   were launched by its own main path in step 5;
7. "sharded": the bench index over a SHARDS-shard mesh (four
   cards where there are four, else four shards on cuda:0, saying which),
   c1-c10 and mv1, p1, h2 planned (timed) as ShardedPrograms with the
   JAX package's sharded modes (SHARDED_MODES: prefix terms, rank +
   bisect, slot_rank + slot_bisect, in-slot top_hits; no member operand,
   pcube or scube; SHARDED_CUBE_MODES), every shard body on a card;
8. c1-c10 on the mesh through phase_main_path (agg_search == the oracle
   and == the unsharded searcher's, the 256-request batch == the
   unsharded per-query answers with dedup on and off, and the 20 timed
   agg_search calls == them; p50 and msearch ms/q printed beside the
   default path's), with fused_metrics, chain_blocks, chain_counts and
   chain_slot_counts launched by the shard bodies; mv1, p1 (non-integer
   percents, phase 2's cross-shard bisection) and h2 (the in-slot top_hits
   merge) once each == the oracle. On one card the mesh answers through
   its graphs (one per mesh program and padded B: the S shard bodies and
   their collectives captured in turn order on one stream);
   8t. c1-c10, mv1 and p1 on the mesh through its graphs and eagerly
   (raw_fn, and p1's phase 2), in turns (phase_mesh_step_timings): p50 at
   B = 1 and ms/q of a group of 128, fruits == both ways;
   8k. each of those kernels == its plain version on every launch of
   SHARD_KERNELS' config on the mesh at B = 1 and 128 (the shards' own
   operands, captured), shard 0's time and bound kept as variants;
   8g. the mesh step as graphs (phase_mesh_graphs): c1-c10, mv1, p1, h2
   at B = 1, 3 padded to 4 and a full group, each replay == the eager
   raw_fn (packed and every shard's phase-1 state) and the fruits == the
   oracle, a replay's credited launches == the eager step's == the kernel
   nodes of its graph (fused_metrics, chain_blocks, chain_counts and
   chain_slot_counts among them), every mesh graph again in a shuffled
   order among the default path's unsharded graphs, node counts and
   first-call seconds printed; p1's phase-2 graphs on the mesh == the
   eager bisection at B = 1, 4 and a full group;
9. "replicas": ReplicatedSearcher over REPLICAS groups (cards, or one-
   shard groups on cuda:0): a mixed stream of c1-c10 through
   agg_search_batch and agg_search_stream == the single searcher's
   answers in request order, every replica submitting msearch groups in
   both (through each replica's graphs on one card), ms/q beside the
   single searcher's;
10. the prep cache: with <index>/.prep_cache_torch emptied, c1-c10
   planned cold on a fresh searcher, then warm on another (a new
   DeviceIndex): seconds, hits and misses (the warm plan misses nothing),
   fruits == the oracle; the mesh's warm plan after its cold one (phase
   7's);
11. the device guard: with two or more cards a 2-shard mesh over cuda:0
   and cuda:1 answers c1, c4, c5, c9 == the oracle and chain_counts on
   cuda:1 operands == its plain version while cuda:0 is current; with one
   card it prints why it is skipped.

Each phase prints its seconds.

It prints a JSON line of phase 5t's step timings ({"graph_step": ...};
with phase 8t's under "mesh_steps", 8g's node counts and first-call
seconds per mesh graph under "mesh_graph_nodes_8g" and
"mesh_capture_s_8g"), a
JSON line of per-product records (the same keys; launches
from the default path), a JSON line of per-kernel records (launches in
all and per path, the sharded and replicas paths among them;
max_abs_err; B = 1: ms, plain_ms, bound_ms, bound_by,
library_ms, device_ms; B = 128: the same keys suffixed _b128;
fused_metrics' other operands under "variants", `launches_replayed_5g`:
the launches phase 5g's replays credited, `graph_nodes_5g`: the kernel
nodes CUDA's own record of those graphs holds; `launches_replayed_8g`
and `graph_nodes_8g`: the same for phase 8g's mesh graphs), then, as its
last line,
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --against DIR

also times the AB_KERNELS against the kernels of the port package in the
tree at DIR (say the parent commit, unpacked with `git archive`), in turns
on the same operands (those cases the other tree's kernels can run), then
c1, c5, c4, c9 and c7 end to end through either tree's kernels, in turns
(phase 4c), and prints the other tree's ptxas report.

Any failure raises and exits non-zero; with no CUDA device, or without the
port's package beside it, it exits non-zero before printing any result.
The port never imports jax, and neither does this script.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
#: the bench deployment (models/flagship.py, bench.py): docs, segments, seed
DOCS, SEGMENTS, SEED = 10_000_000, 4, 42
#: the device phase_edges makes its operands on
DEVICE = "cuda"
SOURCE = "tantivy_aggregations_tpu_torch/csrc/kernels.cu"
REPLACES = {
    "fused_metrics": "tantivy_aggregations_tpu/ops/pallas_kernels.py:225",
    "chain_blocks": "tantivy_aggregations_tpu/ops/pallas_kernels.py:355",
    "chain_counts": "tantivy_aggregations_tpu/ops/pallas_kernels.py:156",
    "chain_slot_counts":
        "tantivy_aggregations_tpu/ops/pallas_kernels.py:432",
    "gather_rows": "tantivy_aggregations_tpu/ops/pallas_kernels.py:527",
    "dense_buckets":
        "tantivy_aggregations_tpu/ops/reductions.py:242 and :258 (products)",
    "dense_extremes":
        "tantivy_aggregations_tpu/ops/reductions.py:327 and :338 (XLA "
        "reductions)",
}
#: the nyc_taxis cell's distance histogram (PERF.md §4): its rows (41,336,673
#: trips, padded as the loader pads them), its docs and buckets, the shape
#: phase 4e times dense_extremes on
NYC_ROWS, NYC_DOCS, NYC_NB = 41_353_216, 41_336_673, 50
#: rows of phase 4e's operands at the batch sizes past the nyc shape's
EXTREME_ROWS = 1 << 22
#: the card's peak rates for kernel_bound: HBM3 of an H100 SXM (NVIDIA's
#: data sheet), and int32 ALU ops — 132 SMs x 64 INT32 lanes at the 1.98 GHz
#: boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
#: the kernels timed against another tree's by --against (gather_rows
#: beside index_select)
AB_KERNELS = ("fused_metrics", "chain_blocks", "chain_counts",
              "chain_slot_counts", "gather_rows")
#: configs timed end to end by --against, each with the kernels of its main
#: path that are swapped for the other tree's
AB_CONFIGS = ((1, ("fused_metrics",)), (5, ("fused_metrics",)),
              (4, ("chain_blocks", "chain_counts")),
              (9, ("chain_slot_counts",)), (7, ("gather_rows",)))
#: configs whose dedup-off msearch group is also profiled (the users of
#: fused_metrics, chain_blocks and chain_counts, and c10's set query)
PROFILED = (1, 4, 5, 10)
#: the extra configs this script drives beside c1-c5 (all of them)
EXTRA = (6, 7, 8, 9, 10)
#: requests of c6's varied stream (one msearch group; its host-bound
#: dedup-off pass took 0.23-0.34 s a request at 10M docs beside an NVIDIA
#: H100 80GB HBM3 at 700 W, on three paths, so it is cut from 128 to 64 to
#: make room for the sharded path)
C6_STREAM = 64
#: the main path of each slice of the port: its configs, the kernels and
#: the matrix products that path must launch (each path runs with the
#: counters set to 0), and its EngineConfig switches. The slices c1-c5,
#: c6-c9 and c10 run in row modes (the cube and the dense reductions off),
#: so that chain_counts and chain_slot_counts stay on a main path; the
#: "default" path runs c1-c10 at the JAX package's default EngineConfig.
ROW_MODES = {"use_cube": False, "dense_mxu": False}
#: the default EngineConfig with the member operands off
NOMOP = {"use_member_ops": False}
PATHS = (
    ("c1-c5", (1, 2, 3, 4, 5),
     ("fused_metrics", "chain_blocks", "chain_counts"), (), ROW_MODES),
    ("c6-c9", (6, 7, 8, 9), ("chain_slot_counts", "gather_rows"), (),
     ROW_MODES),
    ("c10", (10,), ("fused_metrics",), (), ROW_MODES),
    ("default", (1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
     ("fused_metrics", "chain_blocks", "gather_rows", "dense_buckets"),
     ("cube_dots", "block_counts", "slot_block_counts",
      "dense_bucket_counts_mm", "dense_bucket_sum_mm"), {}),
    # c7 with the member operand off: its TermQuery on the multi-valued
    # weights runs chain_blocks over the sku layout (gather_rows must not
    # launch), timed beside the default path's c7
    ("nomop", (7,), ("chain_blocks",), (), NOMOP),
)
#: kernels a path must NOT launch (checked with the counts it leaves)
NOT_LAUNCHED = {"nomop": ("gather_rows",)}
#: the modes the default path's plans must carry, per config (phase 3b):
#: c2, c5, c8, c9 and c10 on the cube (c5 a pcube, c9 a scube), c3 the
#: dense reductions (dense_buckets), c1, c4, c6 and c7 none
DEFAULT_MODES = {1: set(), 2: {"cube"}, 3: {"dense_mm"},
                 4: set(), 5: {"cube", "pcube"}, 6: set(), 7: set(),
                 8: {"cube"}, 9: {"cube", "scube"}, 10: {"cube"}}
#: configs whose dedup-off group is profiled on the default path
PROFILED_DEFAULT = (3, 5, 9, 10)
#: the matrix products (ops/cube.py, ops/reductions.py): their source, the
#: JAX function each replaces, and how the card runs it (the dense bucket
#: counts and sums are the dense_buckets kernel, one of the kernels)
PRODUCTS = {
    "cube_dots": ("tantivy_aggregations_tpu_torch/ops/cube.py",
                  "tantivy_aggregations_tpu/ops/cube.py:310", "int8"),
    "block_counts": ("tantivy_aggregations_tpu_torch/ops/cube.py",
                     "tantivy_aggregations_tpu/ops/cube.py:357", "int8"),
    "slot_block_counts": ("tantivy_aggregations_tpu_torch/ops/cube.py",
                          "tantivy_aggregations_tpu/ops/cube.py:395",
                          "int8"),
    "masked_sum_planes_mm": (
        "tantivy_aggregations_tpu_torch/ops/reductions.py",
        "tantivy_aggregations_tpu/ops/reductions.py:286", "bf16"),
}
#: the H100 SXM's dense tensor-core peaks (NVIDIA's data sheet): int8 for
#: the cube's torch._int_mm products, bf16 for masked_sum_planes_mm's
#: batched bf16 products
TENSOR_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
#: the multi-valued paths (phase 5m), each on its deployment at the default
#: EngineConfig: the requests (multi_requests / tags_requests; mv4 answers
#: on the host path and is checked apart), the kernels and products the
#: path must launch, and the requests whose dedup-off group is profiled
MULTI_PATHS = (
    ("multi", "bench", ("mv1", "mv2", "mv3", "mv5", "mv6", "mv7"),
     ("fused_metrics", "chain_blocks", "chain_counts", "chain_slot_counts",
      "dense_extremes"),
     ("block_counts", "dense_bucket_extremes_mm"), ("mv1", "mv3", "mv7")),
    ("tags", "tags", ("t1", "t2", "t3"),
     ("fused_metrics", "chain_counts", "dense_buckets"),
     ("dense_bucket_counts_mm", "dense_bucket_sum_mm"), ("t1", "t2")),
    # the rest of the agg surface: non-integer percents (phase 2),
    # top_hits on the bench index; in-slot top_hits, wslots' phase 2 and
    # facets on the catalog deployment (the tags deployment's index with
    # its facet field `cat`)
    ("select", "bench", ("p1", "p2", "p3", "p4", "h1", "h2", "h3", "h4",
                         "h5"), ("chain_counts",), (),
     ("p1", "p2", "h2", "h5")),
    ("catalog", "tags", ("tp", "th", "f1", "f2", "f3", "f4"),
     ("fused_metrics",), (), ("tp", "f1")),
)
#: distinct varied requests of the multi paths held to the oracle per
#: request (the oracle takes 6-17 s a request there at 10M docs)
MULTI_CHECKED = 2
#: the modes each multi-valued request must plan (phase 3m), per node: the
#: JAX package's plans of the same requests at its default EngineConfig
MULTI_MODES = {
    "mv1": {"p": {"rank", "pallas_counts"}},
    "mv2": {"t": {"prefix", "pallas_prefix"}},
    "mv3": {"t": {"scatter"}, "h": {"dense", "dense_mm"}},
    "mv5": {"p": {"rank", "pcube"}},
    "mv6": {"p": {"rank", "pallas_counts"}},
    "mv7": {"t": {"dense", "dense_mm"}, "t/p": {"slot_rank",
                                                 "pallas_slots"}},
    "t1": {"t": {"dense", "dense_mm"}, "t/p": {"slot_rank", "wslots"}},
    "t2": {"t": {"dense", "dense_mm", "plane_fanout"},
           "t/h": {"scatter"}},
    "t3": {"p": {"rank", "pallas_counts"}},
    "p1": {"p": {"rank", "pallas_counts", "phase2"}},
    "p2": {"t": {"dense", "sel_host", "cube"},
           "t/p": {"slot_rank", "phase2"}},
    "p3": {"p": {"rank", "pallas_counts", "phase2"}},
    "p4": {"p": {"rank", "pallas_counts", "phase2"}},
    "h1": {"h": {"top_hits"}},
    "h2": {"t": {"dense", "dense_mm"}, "t/h": {"top_hits", "in_slot"}},
    "h3": {"h": {"top_hits", "score"}},
    "h4": {"t": {"scatter"}, "t/h": {"top_hits", "in_slot"}},
    "h5": {"t": {"scatter"}, "t/h": {"top_hits", "in_slot"}},
    "tp": {"t": {"dense", "dense_mm", "sel_host"},
           "t/p": {"slot_rank", "wslots", "phase2"}},
    "th": {"t": {"dense", "dense_mm"}, "t/h": {"top_hits", "in_slot"}},
    "f1": {"f": {"scatter", "sel_host", "facet"}},
    "f2": {"f": {"scatter", "sel_host", "facet"}},
    "f3": {"f": {"scatter", "sel_host", "facet"}},
    "f4": {"t": {"dense", "dense_mm", "plane_fanout"},
           "t/f": {"scatter", "sel_host", "facet"}},
}
#: shapes the port answers on the host path, as the JAX package does
#: (phase 3m): top_hits under a bucket space past prod(hdims) * k = 4096
#: (4 status buckets x 1100 hits), and a multi-valued terms agg nested two
#: deep under multi-valued ones; each under a narrow range (about 11k
#: docs), so that the oracle answers in seconds at 10M docs
HOST_SHAPES = ("huge_top_hits", "deep_multi_nest")
#: the facet deployment's categories: CATS top-level, each with CAT_SUBS
#: subcategories of CAT_LEAVES leaves
CATS, CAT_SUBS, CAT_LEAVES = 20, 10, 10
#: cycles of phase 5s's mixed stream on the bench index (384 requests and
#: 2 on the host path; the tags deployment's runs 2 cycles, 128 requests)
STREAM_CYCLES = 4
#: the tags deployment: DOCS docs in SEGMENTS segments from SEED, with
#: TAGS_CARD zipf-skewed tag terms
TAGS_CARD = 64
#: phase 5g: (distinct requests, padded batch) of each program's graphs
#: (one query, an odd group padded as the searcher pads it, a full
#: group), the varied requests a program draws them from, and the
#: largest phase-1 state ("big") of an eager step kept for the replays in
#: another order (past it they compare `packed` only)
GRAPH_SIZES = ((1, 1), (3, 4), (128, 128))
GRAPH_GROUP = 128
GRAPH_KEEP_BIG = 256 << 20
#: phase 5t: timed runs of each way (graph, raw_fn) per config, by B; and
#: the odd group (distinct requests, padded batch) timed in a row mode
STEP_REPS = {1: 3, 128: 2}
#: runs of the mesh step per way in phase 8t, by B
MESH_STEP_REPS = {1: 5, 128: 2}
PAD_ODD = (65, 128)


def say(*a, **kw):
    print(*a, flush=True, **kw)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _cmd_out(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"{cmd[0]} exited {res.returncode}: "
                               f"{res.stderr.strip()}")
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_versions(torch, K) -> str:
    say("[1] versions")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(_cmd_out([K._nvcc(), "--version"]).splitlines()[-1])
    card = _cmd_out(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    say(card)
    return card


def _say_ptxas(lib) -> None:
    """ptxas's report of each kernel in the build log kept beside `lib`:
    its registers, stack frame and spills."""
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if any(k in ln for k in ("registers", "Compiling entry",
                                     "stack frame")):
                say("  ptxas:", ln.strip())


def phase_build(K) -> None:
    say("[2] kernel build")
    t0 = time.time()
    lib = K.build()
    say(f"built {lib.name} in {time.time() - t0:.1f}s")
    _say_ptxas(lib)


def phase_index(tt, flagship):
    say("[3] bench index")
    path = REPO / ".bench_cache" / f"idx_{DOCS}_{SEGMENTS}_{SEED}"
    t0 = time.time()
    if (path / "meta.json").exists():
        idx = tt.Index.open(str(path))
        say(f"reused {path} in {time.time() - t0:.1f}s")
    else:
        idx = flagship.build_bench_index(str(path), DOCS, seed=SEED,
                                         n_segments=SEGMENTS)
        say(f"built {DOCS} docs x {SEGMENTS} segments at {path} in "
            f"{time.time() - t0:.1f}s")
    return idx


def tags_schema(tt):
    """The tags deployment's schema: amount and price as the bench's,
    tags (keyword, multi-valued), ids (u64, multi-valued, wide) and the
    facet field cat."""
    from tantivy_aggregations_tpu_torch.schema import Cardinality
    return (tt.SchemaBuilder()
            .add_u64_field("amount")
            .add_f64_field("price")
            .add_keyword_field("tags", cardinality=Cardinality.MULTI)
            .add_u64_field("ids", cardinality=Cardinality.MULTI)
            .add_facet_field("cat")
            .build())


def tags_columns(n_docs: int, seed: int):
    """Columns of the tags deployment from `seed`: amount and price drawn
    as the bench draws them; 0-3 tags per doc from TAGS_CARD zipf-skewed
    terms, and in one doc of five with a tag a repeat of its first tag
    (occurrence weight 2); 0-3 ids per doc uniform in [0, 2^40), a span
    past NARROW_MAX_SPAN (a wide field); then one facet leaf path per doc
    in cat (CATS x CAT_SUBS x CAT_LEAVES leaves, 2220 terms with their
    ancestors). No doc holds more than 4 values in tags or ids."""
    rng = np.random.default_rng(seed)
    cols = {"amount": rng.integers(0, 10_000, n_docs, dtype=np.uint64),
            "price": np.round(rng.lognormal(3.0, 1.0, n_docs), 2)}
    ntag = rng.integers(0, 4, n_docs)
    rep = (rng.random(n_docs) < 0.2) & (ntag > 0)
    cnt = ntag + rep
    offs = np.zeros(n_docs + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    first = np.cumsum(ntag) - ntag  # each doc's first tag in `drawn`
    vocab = np.array([f"tag{i:02d}" for i in range(TAGS_CARD)], object)
    drawn = vocab[(rng.zipf(1.3, int(ntag.sum())) - 1) % TAGS_CARD]
    vals = np.empty(int(offs[-1]), object)
    vals[np.repeat(offs[:-1], ntag)
         + (np.arange(len(drawn)) - np.repeat(first, ntag))] = drawn
    reps = np.nonzero(rep)[0]
    vals[offs[reps] + ntag[reps]] = drawn[first[reps]]
    cols["tags"] = (offs.astype(np.uint32), vals)
    nid = rng.integers(0, 4, n_docs)
    ioffs = np.zeros(n_docs + 1, np.uint32)
    np.cumsum(nid, out=ioffs[1:])
    cols["ids"] = (ioffs, rng.integers(0, 2**40, int(ioffs[-1]),
                                       dtype=np.uint64))
    # drawn last, so that the columns above do not change with it:
    # one leaf path /cNN/sN/lN a doc, zipf-skewed over the leaves (the
    # writer indexes its two ancestors beside it)
    leaves = np.array([f"/c{c:02d}/s{u}/l{v}" for c in range(CATS)
                       for u in range(CAT_SUBS) for v in range(CAT_LEAVES)],
                      object)
    cols["cat"] = leaves[(rng.zipf(1.3, n_docs) - 1) % len(leaves)]
    return cols


def build_columnar_index(tt, path, schema, cols, n_docs, n_segments):
    """An on-disk index of `cols` in n_segments segments (CSR columns are
    (offsets, values) pairs, cut at the segment bounds)."""
    idx = tt.Index.create(str(path), schema, overwrite=True)
    w = idx.writer()
    per = n_docs // n_segments
    for s in range(n_segments):
        lo = s * per
        hi = n_docs if s == n_segments - 1 else (s + 1) * per
        part = {}
        for k, v in cols.items():
            if isinstance(v, tuple):
                offs, vals = v
                part[k] = (offs[lo:hi + 1] - offs[lo],
                           vals[int(offs[lo]):int(offs[hi])])
            else:
                part[k] = v[lo:hi]
        w.add_documents_columnar(part, hi - lo)
        w.commit()
    return idx


def tags_index_path():
    """Where the tags deployment is cached: `catalog_*` since it holds the
    facet field (a cached `tags_*` index, without it, is never read)."""
    return REPO / ".bench_cache" / f"catalog_{DOCS}_{SEGMENTS}_{SEED}"


def phase_tags_index(tt):
    """The tags deployment (DOCS docs, SEGMENTS segments, SEED), built on
    first use under .bench_cache/ and reused after."""
    path = tags_index_path()
    t0 = time.time()
    if (path / "meta.json").exists():
        idx = tt.Index.open(str(path))
        say(f"reused {path} in {time.time() - t0:.1f}s")
    else:
        idx = build_columnar_index(tt, path, tags_schema(tt),
                                   tags_columns(DOCS, SEED), DOCS, SEGMENTS)
        say(f"built the tags deployment, {DOCS} docs x {SEGMENTS} "
            f"segments, at {path} in {time.time() - t0:.1f}s")
    return idx


def multi_requests(tt, name: str, k: int):
    """Request `name` of the multi path (mv1-mv7, on the bench index) with
    parameter set k (0-31)."""
    pct = (25.0, 50.0, 75.0)
    amt = tt.RangeQuery("amount", lower=100 + k, upper=9000 - k,
                        include_upper=True)
    wrange = tt.RangeQuery("weights", lower=100 + k, upper=899 - k)
    statuses = ("active", "archived", "deleted", "pending")
    if name == "mv1":
        return (tt.BooleanQuery(must=[wrange,
                                      tt.TermQuery("status", "active")]),
                {"n": tt.count_agg(), "s": tt.sum_agg("amount"),
                 "p": tt.percentiles_agg("price")})
    if name == "mv2":
        return (tt.RangeQuery("weights", lower=500 + k, upper=531 + k),
                {"t": tt.terms_agg("sku", size=10, sub_aggs={
                    "s": tt.sum_agg("amount"), "n": tt.count_agg()})})
    if name == "mv3":
        return (amt, {"t": tt.terms_agg("weights", size=10, sub_aggs={
                          "s": tt.sum_agg("amount")}),
                      "h": tt.histogram_agg("weights", interval=100,
                                            sub_aggs={"st": tt.stats_agg(
                                                "price")})})
    if name == "mv4":
        return (amt, {"t": tt.terms_agg("weights", size=10, sub_aggs={
            "p": tt.percentiles_agg("price", pct)})})
    if name == "mv5":
        return (tt.TermQuery("status", statuses[k % 4]),
                {"p": tt.percentiles_agg("weights")})
    if name == "mv6":
        return (tt.BooleanQuery(must=[tt.ExistsQuery("weights"), amt]),
                {"n": tt.count_agg(), "p": tt.percentiles_agg("price")})
    if name == "mv7":
        return (wrange, {"t": tt.terms_agg("status", size=4, sub_aggs={
            "p": tt.percentiles_agg("price", pct)})})
    if name in SELECT_AGGS:
        if name == "p3":
            q = tt.TermQuery("status", statuses[k % 4])
        elif name == "p4":
            q = wrange
        else:
            q = amt
        return q, SELECT_AGGS[name](tt)
    if name in CATALOG_AGGS:
        path = catalog_path(name, k)
        q = tt.TermQuery("cat", path) if name == "f3" else amt
        return q, CATALOG_AGGS[name](tt, path)
    if name in HOST_SHAPES:
        return (tt.RangeQuery("amount", lower=100, upper=110),
                HOST_AGGS[name](tt))
    lo = (k * 2**35) % (2**40 - 2**36)
    if name == "t1":
        return (amt, {"t": tt.terms_agg("tags", size=10, sub_aggs={
            "p": tt.percentiles_agg("price", pct)})})
    if name == "t2":
        return (amt, {"t": tt.terms_agg("tags", size=10, sub_aggs={
            "h": tt.histogram_agg("amount", interval=1000),
            "s": tt.sum_agg("amount")})})
    if name == "t3":
        return (tt.RangeQuery("ids", lower=lo, upper=lo + 2**36),
                {"n": tt.count_agg(), "s": tt.sum_agg("amount"),
                 "p": tt.percentiles_agg("price")})
    raise KeyError(name)


#: the select path's agg trees (phase 5, "select"), by request
SELECT_AGGS = {
    "p1": lambda tt: {"p": tt.percentiles_agg(
        "price", (1, 5, 25, 50, 75, 95, 99, 99.9))},
    "p2": lambda tt: {"t": tt.terms_agg("status", 4, sub_aggs={
        "p": tt.percentiles_agg("price", (50, 99.9))})},
    "p3": lambda tt: {"p": tt.percentiles_agg("weights", (50, 99.9))},
    "p4": lambda tt: {"p": tt.percentiles_agg("price", (99.5,))},
    "h1": lambda tt: {"h": tt.top_hits_agg(10, "amount", False)},
    "h2": lambda tt: {"t": tt.terms_agg("status", 4, sub_aggs={
        "h": tt.top_hits_agg(3, "price", False)})},
    "h3": lambda tt: {"h": tt.top_hits_agg(10)},
    "h4": lambda tt: {"t": tt.terms_agg("weights", 10, sub_aggs={
        "h": tt.top_hits_agg(2, "price", True)})},
    "h5": lambda tt: {"t": tt.terms_agg("sku", 10, sub_aggs={
        "h": tt.top_hits_agg(3, "price", False)})},
}
#: the catalog path's agg trees, by request and facet path
CATALOG_AGGS = {
    "tp": lambda tt, path: {"t": tt.terms_agg("tags", 10, sub_aggs={
        "p": tt.percentiles_agg("price", (50, 99.9))})},
    "th": lambda tt, path: {"t": tt.terms_agg("tags", 10, sub_aggs={
        "h": tt.top_hits_agg(2, "price", False)})},
    "f1": lambda tt, path: {"f": tt.facet_agg("cat")},
    "f2": lambda tt, path: {"f": tt.facet_agg("cat", path, size=5)},
    "f3": lambda tt, path: {"n": tt.count_agg(),
                            "s": tt.sum_agg("amount"),
                            "f": tt.facet_agg("cat", path)},
    "f4": lambda tt, path: {"t": tt.terms_agg("tags", 5, sub_aggs={
        "f": tt.facet_agg("cat")})},
}
#: the host-path shapes (HOST_SHAPES)
HOST_AGGS = {
    "huge_top_hits": lambda tt: {"t": tt.terms_agg("status", 4, sub_aggs={
        "h": tt.top_hits_agg(1100, "price", False)})},
    "deep_multi_nest": lambda tt: {"t": tt.terms_agg("weights", 3, sub_aggs={
        "u": tt.terms_agg("weights", 2, sub_aggs={
            "v": tt.terms_agg("weights", 2)})})},
}


def catalog_path(name: str, j: int) -> str:
    """The facet path of request j of f2 (from /c07) and f3 (from /c03):
    the next of the CATS top-level categories every 16 requests, so that
    a varied stream keeps runs of one agg tree."""
    c0 = {"f2": 7, "f3": 3}.get(name, 0)
    return f"/c{(c0 + j // 16) % CATS:02d}"


def multi_varied(tt):
    """varied_requests for the multi paths: 32 parameter sets in turn
    (j % 32), as models/flagship.py rotates them; f2 and f3 also rotate
    their facet path (catalog_path), with one agg tree per path."""
    trees = {}

    def varied(name, aggs, n):
        out = []
        for j in range(n):
            q = multi_requests(tt, name, j % 32)[0]
            if name in ("f2", "f3"):
                path = catalog_path(name, j)
                if name == "f3":
                    q = tt.TermQuery("cat", path)
                if path == catalog_path(name, 0):
                    ra = aggs
                else:
                    ra = trees.setdefault(
                        (name, path), CATALOG_AGGS[name](tt, path))
                out.append((q, ra))
            else:
                out.append((q, aggs))
        return out
    return varied


def plan_nodes(prog):
    """(path, plan entry) of a program's agg nodes (the plan's other
    entries, `graph` and its reason, record the program's mode)."""
    return [(path, p) for path, p in prog.plan.items()
            if isinstance(p, dict)]


def multi_plan_modes(prog) -> dict:
    """{node path: the modes it runs} of a Program's bucket and percentile
    nodes (the MULTI_MODES vocabulary)."""
    out = {}
    for path, p in plan_nodes(prog):
        got = {p[k] for k in ("mode", "pmode") if p.get(k)}
        got |= {k for k in ("pallas_counts", "pallas_prefix", "pallas_slots",
                            "pcube", "scube", "cube", "dense_mm", "wslots",
                            "plane_fanout", "mask_gather", "xpand",
                            "in_slot", "score")
                if p.get(k)}
        kind = p.get("kind")
        if kind == "percentiles" and not p["int_percents"]:
            got.add("phase2")  # ranks resolved on the host, rows in phase 2
        if kind == "terms" and p["sel"] == "host":
            got.add("sel_host")
        if kind == "terms" and p.get("facet_children") is not None:
            got.add("facet")
        if kind == "top_hits":
            got.add("top_hits")
        if got and kind in ("terms", "histogram", "percentiles",
                            "top_hits"):
            out["/".join(path[1:])] = got
    return out


def phase_plan_multi(torch, searchers):
    """Phase 3m: plan every request of the multi paths (and the select
    and catalog paths) at the default EngineConfig, each a device Program
    with the MULTI_MODES of its nodes; mv4 (terms over weights' 1000
    values with slot_rank percentiles: past the slot-state budget at 10M
    docs) and the HOST_SHAPES plan the host path, as in JAX."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    from tantivy_aggregations_tpu_torch.searcher import _HostFallback
    import tantivy_aggregations_tpu_torch as tt
    say("[3m] planning the multi-valued requests (default EngineConfig)")
    for label, dep, names, _, _, _ in MULTI_PATHS:
        for name in names:
            q, aggs = multi_requests(tt, name, 0)
            t0 = time.time()
            prog = searchers[dep]._program_for(q, aggs)
            torch.cuda.synchronize()
            check(type(prog) is Program,
                  f"{name} planned {type(prog).__name__}, not a device "
                  f"Program ({getattr(prog, 'reason', '')})")
            got = {k: v for k, v in multi_plan_modes(prog).items()
                   if k in MULTI_MODES[name]}
            check(got == MULTI_MODES[name],
                  f"{name} plans {got}, not {MULTI_MODES[name]}")
            say(f"  {name} ({label}): {got}, batch_cap {prog.batch_cap}, "
                f"planned in {time.time() - t0:.2f}s")
    for name in ("mv4",) + HOST_SHAPES:
        q, aggs = multi_requests(tt, name, 0)
        prog = searchers["bench"]._program_for(q, aggs)
        check(isinstance(prog, _HostFallback),
              f"{name} planned {type(prog).__name__}, not the host path")
        say(f"  {name} (bench): host path "
            f"({getattr(prog, 'reason', None)})")


def _cuda_ms(torch, fn, iters: int) -> float:
    """Median CUDA-event time of fn() over `iters` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over the outputs (0 where they are equal,
    without the int64 copies)."""
    err = 0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "kernel/plain output missing")
        if g is None:  # fused_metrics' min and max without minmax
            continue
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"kernel/plain output {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        if g.numel() and not torch.equal(g, w):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def every_op_queries(tt, B: int):
    """B queries of one Boolean shape over the bench schema whose mask
    program holds every opcode of the kernels' interpreter: EQ32 (keyword
    term), RANGE32 (narrow range), RANGE_WIDE (f64 range), EQ_WIDE_GUARD and
    EQ32_GUARD in OR pairs (f64 and narrow terms), SET32 (a TermSet of
    three skus, two of the most frequent among them: 4 run slots), SET_WIDE
    (a TermSet of four f64 prices: 4 slots), GT_IMM (a range over the
    multi-valued weights: an OR over its per-position planes, each compare
    guarded against the -1 fill), NOT, AND and TRUE. Their params are
    drawn from SEED."""
    rng = np.random.default_rng(SEED)
    statuses = ("active", "archived", "deleted", "pending")
    out = []
    for b in range(B):
        lo = int(rng.integers(0, 5000))
        plo = int(rng.integers(0, 4000)) / 100
        skus = [f"sku{1 + b % 3:07d}", f"sku{5 + b % 7:07d}",
                f"sku{int(rng.integers(1, 2000)):07d}"]
        prices = [round(plo + float(x), 2)
                  for x in rng.integers(0, 4000, 4) / 100]
        out.append(tt.BooleanQuery(
            must=[tt.TermQuery("status", statuses[b % 4]),
                  tt.RangeQuery("amount", lower=lo, upper=lo + 4000,
                                include_upper=True),
                  tt.RangeQuery("price", lower=plo, upper=plo + 40.0),
                  tt.RangeQuery("weights", lower=lo // 10,
                                upper=lo // 10 + 600)],
            must_not=[tt.TermQuery("price",
                                   round(float(rng.lognormal(3.0, 1.0)), 2)),
                      tt.TermQuery("qty", int(rng.integers(0, 100))),
                      tt.TermSetQuery("sku", skus),
                      tt.TermSetQuery("price", prices)]))
    return out


def wide_set_queries(tt, B: int):
    """B queries of one shape whose chain holds more than 256 params: a
    TermSet of 64 f64 prices (64 wide run slots, 256 params) AND an amount
    range, params from SEED."""
    rng = np.random.default_rng(SEED + 1)
    out = []
    for _ in range(B):
        prices = sorted(round(float(x), 2) for x in
                        (rng.choice(99_900, 64, replace=False) + 100) / 100)
        lo = int(rng.integers(0, 5000))
        out.append(tt.BooleanQuery(must=[
            tt.TermSetQuery("price", prices),
            tt.RangeQuery("amount", lower=lo, upper=lo + 4000,
                          include_upper=True)]))
    return out


def _chain_blocks_args(prog, pmat):
    """chain_blocks operands of a prefix-mode terms agg "t"."""
    pt = prog.plan[("a", "t")]
    e, pre = pt["chainp"], pt["prefix"]
    pay = [prog._arrays[pre + k] for meta in pt["pay_plan"].values()
           for k in meta["skeys"]]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"], pay)


def _chain_counts_args(prog, pmat):
    """chain_counts operands of a rank-mode percentiles agg "p"."""
    pp = prog.plan[("a", "p")]
    e, pre = pp["chainp"], pp["prefix"]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"])


def _chain_slot_args(prog, pmat):
    """chain_slot_counts operands of a slot_rank percentiles agg "t"/"p"."""
    pp = prog.plan[("a", "t", "p")]
    e, pre = pp["chainp"], pp["prefix"]
    return (prog._chain_pmat(e, pmat), e["ops"],
            [prog._arrays[pre + k] for k in e["mp"].plane_keys],
            prog._arrays[pre + "avalid"], prog._arrays[pre + pp["slotk"]],
            pp["nslots"])


def _gather_rows_args(prog, pmat):
    """gather_rows operands of a member-operand terms agg "t": the row
    index as the main path clamps it, and the resident operand's
    RowOperand (the plan's, as the main path passes it)."""
    mo = prog.plan[("a", "t")]["member_op"]
    rows = mo["rows"]
    idx = pmat[:, mo["tcol"]].clamp(0, rows.op.shape[0] - 1).contiguous()
    return idx, rows


def all_configs(flagship):
    """(config number, name, query, aggs) of c1-c5 and the EXTRA configs."""
    out = [(i + 1, name, q, aggs)
           for i, (name, q, aggs) in enumerate(flagship.judged_configs())]
    return out + [c for c in flagship.extra_configs() if c[0] in EXTRA]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def set_leaf_compares(qc, ops, pm) -> np.ndarray:
    """Compares per row of each query's mask program (kernel_bound's leaf
    costs) under the [B, P] params `pm`: int64 [B]."""
    fixed = {qc.OP_RANGE32: 2, qc.OP_EQ32: 1, qc.OP_EQ32_GUARD: 1,
             qc.OP_RANGE_WIDE: 4, qc.OP_EQ_WIDE_GUARD: 2, qc.OP_GT_IMM: 1}
    pm = pm.astype(np.int64)
    out = np.zeros(pm.shape[0], np.int64)
    for o in ops.tolist():
        if o[0] in fixed:
            out += fixed[o[0]]
        elif o[0] == qc.OP_SET32:
            p0, S = o[2], o[3]
            slots = pm[:, p0:p0 + 2 * S].reshape(-1, S, 2)
            out += 2 * (slots[..., 0] <= slots[..., 1]).sum(axis=1)
        elif o[0] == qc.OP_SET_WIDE:
            p0, S = o[3], o[4]
            s = pm[:, p0:p0 + 4 * S].reshape(-1, S, 4)
            lo = (s[..., 0] << 32) + s[..., 1]  # order of (hi, lo) pairs
            hi = (s[..., 2] << 32) + s[..., 3]
            out += 4 * (lo <= hi).sum(axis=1)
    return out


def kernel_bound(torch, qc, name, args, out):
    """(bound_ms, bound_by), printing both counts: the least time the card
    could take for one call — the larger of the bytes the call must move
    (each input read once, each output written once) over HBM_BYTES_PER_S
    and the int32 operations it must do on these inputs over
    INT32_OPS_PER_S. Counted per (query, row): fused_metrics 2 (count,
    sum) and 2 more with minmax (min, max), a mask of batch stride 0
    (one row shared by every query) counted as one row and one query;
    the chain kernels the compares of each leaf of the mask
    program and 1 per payload; chain_slot_counts also ns per (query,
    32-row block). Boolean ops and block counts go 32 rows to a word and
    are not counted. A leaf costs its compares: RANGE32 2, EQ32 1,
    EQ32_GUARD 1, RANGE_WIDE 4, EQ_WIDE_GUARD 2, GT_IMM 1; a set leaf 2
    (SET32) or 4 (SET_WIDE) per run slot that is not empty in the query's
    params (the kernel skips empty slots). gather_rows reads each distinct picked row
    once and writes B rows. dense_buckets reads each mask row (a stride-0
    mask as one), the bucket ids and the payload once and counts no ALU op
    (its adds are shared-memory atomics, one per selected row and piece);
    dense_extremes the same, each distinct payload plane once."""
    if name == "dense_extremes":
        mask, bid = args[:2]
        rows = 1 if mask.stride(0) == 0 else mask.shape[0]
        planes = {t.data_ptr(): t for ps in args[3:] if ps is not None
                  for t in ps}
        ins = rows * mask.shape[1] * mask.element_size() + _nbytes(
            (bid, *planes.values()))
        ops = 0
    elif name == "dense_buckets":
        mask, bid = args[:2]
        rows = 1 if mask.stride(0) == 0 else mask.shape[0]
        ins = rows * mask.shape[1] * mask.element_size() + _nbytes(
            (bid, args[3] if len(args) > 3 else None))
        ops = 0
    elif name == "fused_metrics":
        mask, plane = args[:2]
        minmax = args[2] if len(args) > 2 else True
        rows = 1 if mask.stride(0) == 0 else mask.shape[0]
        ins = rows * mask.shape[1] * mask.element_size() + _nbytes((plane,))
        ops = rows * mask.shape[1] * (4 if minmax else 2)
    elif name == "gather_rows":
        idx, op = args[0], _operand(torch, args[1])
        row = op.numel() // op.shape[0] * op.element_size()
        ins, ops = _nbytes((idx,)) + int(torch.unique(idx).numel()) * row, 0
    else:
        pmat, ops_t, planes, avalid = args[:4]
        extra = list(args[4]) if name == "chain_blocks" else (
            [args[4]] if name == "chain_slot_counts" else [])
        B, R = pmat.shape[0], avalid.shape[0]
        ops = B * R * (len(extra) if name == "chain_blocks" else 0)
        ops += R * int(set_leaf_compares(qc, ops_t.cpu().numpy(),
                                         pmat.cpu().numpy()).sum())
        if name == "chain_slot_counts":
            ops += B * (R // 32) * args[5]
        ins = _nbytes((pmat, ops_t, avalid, *planes, *extra))
    moved = ins + _nbytes(out)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    say(f"  {name:17s} bound of B={args[0].shape[0]}: {moved} bytes "
        f"({t_bytes:.4f} ms), {ops} int32 ops ({t_ops:.4f} ms)")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_ms(torch, fn, iters: int = 20):
    """Device time of one fn() call in torch.profiler: the summed kernel,
    fill and copy intervals of `iters` calls over iters; None where the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    except RuntimeError as exc:  # a profiler without CUPTI tracing
        say(f"  device time not measured: {exc}")
        return None
    return us / 1e3 / iters if us > 0 else None


def _outputs(got):
    return got if isinstance(got, tuple) else (got,)


def _operand(torch, op):
    """The tensor of a gather_rows operand (a tensor or a RowOperand)."""
    return op if isinstance(op, torch.Tensor) else op.op


def _check_equal(torch, name, label, got, want) -> int:
    got, want = _outputs(got), _outputs(want)
    err = _max_abs_err(torch, got, want)
    check(err == 0 and all(g is None or torch.equal(g, w)
                           for g, w in zip(got, want)),
          f"{name} ({label}) disagrees with its plain version "
          f"(max abs err {err})")
    return err


def phase_kernels(torch, K, qc, tt, searcher, flagship, against=None,
                  nomop=None):
    """Each kernel vs its plain version on the main path's operands; the
    chain kernels also under every opcode, on the same layouts, and
    chain_blocks / chain_counts at more batch sizes; chain_blocks also on
    c7's operands at use_member_ops=False (`nomop`'s plan: the sku layout
    under weights' per-position planes). With `against` (the kernels
    module of another tree), the AB_KERNELS are also timed against that
    tree's, in turns."""
    say("[4] kernels vs plain versions (exact ==)")
    cfgs = {name: (q, aggs) for _, name, q, aggs in all_configs(flagship)}
    progs = {n: searcher._program_for(q, a) for n, (q, a) in cfgs.items()}

    def pmat_of(prog, reqs):
        return qc.param_matrix([prog._extract(q, a) for q, a in reqs],
                               prog._pkeys, prog.device)

    def pmat_for(prog, cfg_no, aggs, B):
        return pmat_of(prog, flagship.varied_requests(cfg_no, aggs, B))

    p1 = progs["c1_count_sum"]
    p4 = progs["c4_terms_highcard_nested"]
    p5 = progs["c5_percentiles_mixed_postfilter"]
    p7 = progs["c7_terms_prefix_multiquery"]
    p9 = progs["c9_terms_nested_percentiles"]
    c5_aggs = cfgs["c5_percentiles_mixed_postfilter"][1]
    c4_aggs = cfgs["c4_terms_highcard_nested"][1]
    c7_aggs = cfgs["c7_terms_prefix_multiquery"][1]
    c9_aggs = cfgs["c9_terms_nested_percentiles"][1]
    amount = p1._arrays["amount:w"]
    # the c4, c5 and c9 trees under the every-opcode query: the same sku
    # bucket and price value layouts, with the query's planes permuted onto
    # them (and c9's status slot plane)
    every = every_op_queries(tt, 128)
    p4e = searcher._program_for(every[0], c4_aggs)
    p5e = searcher._program_for(every[0], c5_aggs)
    p9e = searcher._program_for(every[0], c9_aggs)
    for prog, key in ((p4e, ("a", "t")), (p5e, ("a", "p")),
                      (p9e, ("a", "t", "p"))):
        ops = prog.plan[key]["chainp"]["mp"].ops
        check(set(ops[:, 0].tolist())
              == set(range(qc.OP_GT_IMM + 1)),
              f"every-opcode chain on {key} has opcodes "
              f"{sorted(set(ops[:, 0].tolist()))}")
    # chain_blocks on c4's sku layout under a chain of more than 256 params
    wide = wide_set_queries(tt, 128)
    p4w = searcher._program_for(wide[0], c4_aggs)
    n_prm = len(p4w.plan[("a", "t")]["chainp"]["mp"].param_keys)
    check(type(p4w).__name__ == "Program" and n_prm > 256,
          f"the wide-set chain planned {type(p4w).__name__} with {n_prm} "
          "params")

    # c7 without the member operand: chain_blocks over the sku layout
    p7n = (None if nomop is None else
           nomop._program_for(*cfgs["c7_terms_prefix_multiquery"]))

    # (kernel, operands label, B) -> the kernel's arguments
    cases = {}
    for B in (1, 128):
        # fused_metrics: the c5 root masks (B queries) over amount, count
        # and sum as the main path asks; then with min and max
        pm5 = pmat_for(p5, 5, c5_aggs, B)
        mask = (p5._chain_mask(p5._root, pm5, p5._arrays)
                & (p5._arrays["alive"] > 0)).contiguous()
        cases[("fused_metrics", "c5", B)] = (mask, amount, False)
        cases[("fused_metrics", "c5 minmax", B)] = (mask, amount, True)
        # chain_blocks: c4's sku bucket layout + sum(amount) payload
        cases[("chain_blocks", "c4", B)] = _chain_blocks_args(
            p4, pmat_for(p4, 4, c4_aggs, B))
        # chain_counts: c5's price value layout under the c5 chain
        cases[("chain_counts", "c5", B)] = _chain_counts_args(p5, pm5)
        # both chain kernels under the every-opcode query
        cases[("chain_blocks", "every-op", B)] = _chain_blocks_args(
            p4e, pmat_of(p4e, [(q, c4_aggs) for q in every[:B]]))
        cases[("chain_counts", "every-op", B)] = _chain_counts_args(
            p5e, pmat_of(p5e, [(q, c5_aggs) for q in every[:B]]))
        cases[("chain_blocks", "wide-set", B)] = _chain_blocks_args(
            p4w, pmat_of(p4w, [(q, c4_aggs) for q in wide[:B]]))
        # chain_slot_counts: c9's price value layout, Range chain and
        # status slot plane; then under the every-opcode query
        cases[("chain_slot_counts", "c9", B)] = _chain_slot_args(
            p9, pmat_for(p9, 9, c9_aggs, B))
        cases[("chain_slot_counts", "every-op", B)] = _chain_slot_args(
            p9e, pmat_of(p9e, [(q, c9_aggs) for q in every[:B]]))
        # gather_rows: rows of c7's resident member operand
        cases[("gather_rows", "c7", B)] = _gather_rows_args(
            p7, pmat_for(p7, 7, c7_aggs, B))
        if p7n is not None:
            cases[("chain_blocks", "c7 nomop", B)] = _chain_blocks_args(
                p7n, pmat_for(p7n, 7, c7_aggs, B))
    # fused_metrics on c1's MatchAll root mask at B = 128: alive, one row
    # shared by the batch (batch stride 0), as aggs/compile.py hands it over
    cases[("fused_metrics", "c1 shared", 128)] = (
        (p1._arrays["alive"] > 0)[None].expand(128, -1), amount, False)

    records = {}
    for (name, label, B), args in cases.items():
        kern = lambda a=args, f=getattr(K, name): f(*a)  # noqa: E731
        plain = lambda a=args, f=getattr(K, name + "_plain"): f(*a)  # noqa
        got = kern()
        err = _check_equal(torch, name, f"{label} B={B}", got, plain())
        got = _outputs(got)
        matched = int(got[0].to(torch.int64).sum())
        # B = 1 times are mostly host time: more runs steady the median
        iters = 30 if B == 1 else 10
        ms = _cuda_ms(torch, kern, iters)
        plain_ms = _cuda_ms(torch, plain, 3)
        bound_ms, bound_by = kernel_bound(torch, qc, name, args, got)
        lib_ms = None
        if name == "gather_rows":  # the one PyTorch call of the same function
            idx, op = args[0], _operand(torch, args[1])
            lib_ms = _cuda_ms(torch, lambda: torch.index_select(op, 0, idx),
                              iters)
        say(f"  {name:17s} {label:10s} B={B:<4d} kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})"
            + (f"  index_select {lib_ms:.4f} ms" if lib_ms is not None
               else "")
            + f"  max_abs_err {err}  matched {matched}")
        rec = records.setdefault(name, {"name": name, "route": "cuda",
                                        "source": SOURCE,
                                        "replaces": REPLACES[name],
                                        "launches": 0,
                                        "max_abs_err": 0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label in ("every-op", "wide-set"):
            continue
        dev_ms = _device_ms(torch, kern)
        say(f"  {name:17s} {label:10s} B={B:<4d} device time {dev_ms} ms "
            "(torch.profiler)")
        if label in ("c5 minmax", "c1 shared", "c7 nomop"):  # variants
            rec.setdefault("variants", []).append(
                {"label": label, "B": B, "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by})
            continue
        sfx = "" if B == 1 else f"_b{B}"
        rec["ms" + sfx], rec["plain_ms" + sfx] = ms, plain_ms
        rec["bound_ms" + sfx], rec["bound_by" + sfx] = bound_ms, bound_by
        rec["library_ms" + sfx] = lib_ms
        rec["device_ms" + sfx] = dev_ms

    # the query split on the 10M layouts: more batch sizes, exact ==
    for B in (31, 33, 200):
        for name, args in (
                ("chain_blocks",
                 _chain_blocks_args(p4, pmat_for(p4, 4, c4_aggs, B))),
                ("chain_counts",
                 _chain_counts_args(p5, pmat_for(p5, 5, c5_aggs, B))),
                ("chain_slot_counts",
                 _chain_slot_args(p9, pmat_for(p9, 9, c9_aggs, B)))):
            err = _check_equal(torch, name, f"B={B}", getattr(K, name)(*args),
                               getattr(K, name + "_plain")(*args))
            say(f"  {name:17s} 10M      B={B:<4d} max_abs_err {err}")
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               err)
    gather_host_steps(torch, K, *cases[("gather_rows", "c7", 1)], against)
    if against is not None:
        phase_ab(torch, K, against, {k: v for k, v in cases.items()
                                     if k[0] in AB_KERNELS}, searcher,
                 flagship)
    del cases
    torch.cuda.empty_cache()
    return records


def phase_kernels_multi(torch, K, qc, tt, searchers, records):
    """Phase 4m: the chain kernels on the multi-valued paths' operands, at
    B = 1 and 128, exact == their plain versions, with times and bounds
    (each kept under its kernel's record as a variant): chain_counts on
    mv1's price layout under the permuted weights:mp{k} planes;
    chain_blocks on mv2's sku layout; chain_slot_counts on mv7's price
    layout and status slot plane; chain_counts on the weights value-row
    layout (mv5 in row modes: a query per status, its planes read at each
    value row's doc); chain_counts on t3's price layout under the wide ids
    planes (mph{k}, mpl{k}, mpn)."""
    say("[4m] chain kernels on the multi-valued layouts (exact ==)")
    varied = multi_varied(tt)
    sites = (("chain_counts", "mv1", "default", _chain_counts_args),
             ("chain_blocks", "mv2", "default", _chain_blocks_args),
             ("chain_slot_counts", "mv7", "default", _chain_slot_args),
             ("chain_counts", "mv5 rows", "row", _chain_counts_args),
             ("chain_counts", "t3", "tags", _chain_counts_args))
    for name, label, which, args_of in sites:
        q, aggs = multi_requests(tt, label.split()[0], 0)
        prog = searchers[which]._program_for(q, aggs)
        for B in (1, 128):
            pmat = qc.param_matrix(
                [prog._extract(rq, ra) for rq, ra in
                 varied(label.split()[0], aggs, B)], prog._pkeys,
                prog.device)
            args = args_of(prog, pmat)
            kern = lambda a=args, f=getattr(K, name): f(*a)  # noqa: E731
            plain = lambda a=args, f=getattr(K, name + "_plain"): f(*a)  # noqa
            got = kern()
            err = _check_equal(torch, name, f"{label} B={B}", got, plain())
            matched = int(_outputs(got)[0].to(torch.int64).sum())
            ms = _cuda_ms(torch, kern, 30 if B == 1 else 10)
            plain_ms = _cuda_ms(torch, plain, 3)
            bound_ms, bound_by = kernel_bound(torch, qc, name, args,
                                              _outputs(got))
            dev_ms = _device_ms(torch, kern)
            say(f"  {name:17s} {label:10s} B={B:<4d} kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})  device {dev_ms} ms  max_abs_err {err}  "
                f"matched {matched}  planes "
                f"{len(args[2])}  rows {args[3].shape[0]}")
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec.setdefault("variants", []).append(
                {"label": label, "B": B, "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by})
            del got, args, pmat
    torch.cuda.empty_cache()


def gather_host_steps(torch, K, idx, rows, old=None, n: int = 10_000):
    """gather_rows' host time per call at B = 1, step by step: a host clock
    around n enqueues of each step on the card (after 100 warm-up calls;
    the device keeps up, so it is the enqueue), in us per call, then the
    same with the closing synchronize. The steps: index_select; the wrapper
    on the plan's RowOperand (the main path); the wrapper on the bare
    tensor (every operand check on every call); the index checks alone;
    the output allocation (new_empty, torch.empty); the raw stream handle;
    the ctypes launch alone into a kept output; the same ctypes call with
    B = 0, which the C launcher refuses before any CUDA call; with `old`,
    the other tree's wrapper. index_select and the main-path wrapper run again at the
    end, in reverse order."""
    op = rows.op
    B = idx.shape[0]
    kept = op.new_empty((B, *rows.tail))
    stream = torch._C._cuda_getCurrentRawStream(rows.dev)
    steps = [
        ("index_select", lambda: torch.index_select(op, 0, idx)),
        ("gather_rows(RowOperand)", lambda: K.gather_rows(idx, rows)),
        ("gather_rows(tensor)", lambda: K.gather_rows(idx, op)),
        ("idx checks", lambda: (idx.dim() == 1 and idx.dtype is torch.int32
                                and idx.is_contiguous() and idx.is_cuda
                                and idx.get_device() == rows.dev)),
        ("new_empty", lambda: op.new_empty((B, *rows.tail))),
        ("torch.empty", lambda: torch.empty((B, *rows.tail), dtype=op.dtype,
                                            device=op.device)),
        ("stream handle",
         lambda: torch._C._cuda_getCurrentRawStream(rows.dev)),
        ("ctypes launch", lambda: rows.fn(idx.data_ptr(), B, *rows.args,
                                          kept.data_ptr(), stream)),
        ("ctypes call, refused (no launch)",
         lambda: rows.fn(idx.data_ptr(), 0, *rows.args, kept.data_ptr(),
                         stream)),
    ]
    if old is not None:
        steps.append(("other tree's gather_rows",
                      lambda: old.gather_rows(idx, op)))
    steps += [steps[1], steps[0]]
    out = []
    for label, fn in steps:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.append(f"{label} {(t1 - t0) / n * 1e6:.2f} "
                   f"({(t2 - t0) / n * 1e6:.2f})")
    say(f"  gather_rows host us per call at B={B}, {n} enqueues each "
        "(with the closing synchronize): " + "; ".join(out))


def edge_operands(torch, qc, R: int, B: int, rng):
    """Operands of a mask program over 8 int32 planes that holds every
    opcode of the kernels (OP_GT_IMM against a positive and a negative
    immediate), 16 payload planes (4 full-range, all INT32_MIN, all INT32_MAX,
    the two alternating, 9 more full-range), and an avalid plane with
    whole blocks 0, whole blocks 1 and stray negative bytes; params of B
    queries, with some ranges and set run slots empty and some guards off.
    All from `rng`."""
    o = qc
    prog = [(o.OP_TRUE,), (o.OP_RANGE32, 0, 0, 1), (o.OP_AND,),
            (o.OP_EQ32, 1, 2), (o.OP_NOT,), (o.OP_AND,),
            (o.OP_EQ32_GUARD, 2, 3, 4), (o.OP_RANGE32, 3, 5, 6), (o.OP_OR,),
            (o.OP_AND,), (o.OP_RANGE_WIDE, 4, 5, 7, 8, 9, 10), (o.OP_AND,),
            (o.OP_EQ_WIDE_GUARD, 6, 7, 11, 12, 13), (o.OP_NOT,),
            (o.OP_AND,), (o.OP_TRUE,), (o.OP_AND,),
            (o.OP_SET32, 0, 14, 3), (o.OP_NOT,), (o.OP_AND,),
            (o.OP_SET_WIDE, 6, 7, 20, 2), (o.OP_OR,),
            (o.OP_GT_IMM, 2, 3), (o.OP_GT_IMM, 6, -1), (o.OP_AND,),
            (o.OP_OR,)]
    ops = np.zeros((len(prog), qc.OP_WIDTH), np.int32)
    for i, ins in enumerate(prog):
        ops[i, :len(ins)] = ins
    small = [rng.integers(0, 16, R) for _ in range(4)]
    wide = [rng.integers(-2, 3, R), rng.integers(I32_MIN, I32_MAX, R,
                                                 endpoint=True),
            rng.integers(-1, 2, R), rng.integers(-3, 4, R)]
    planes = small + wide
    alt = np.where(np.arange(R) % 2 == 0, I32_MIN, I32_MAX)
    pays = [rng.integers(I32_MIN, I32_MAX, R, endpoint=True)
            for _ in range(4)]
    pays += [np.full(R, I32_MIN), np.full(R, I32_MAX), alt,
             alt[::-1].copy()]
    pays += [rng.integers(I32_MIN, I32_MAX, R, endpoint=True)
             for _ in range(8)]
    av = (rng.random(R) < 0.9).astype(np.int8)
    blocks = av.reshape(-1, 32)
    blocks[1::7] = 0
    blocks[2::5] = 1
    av[rng.random(R) < 0.02] = -1
    av[rng.random(R) < 0.02] = 2
    pm = np.zeros((B, 28), np.int32)
    lo = rng.integers(0, 16, B)
    pm[:, 0], pm[:, 1] = lo, lo + rng.integers(-2, 12, B)
    pm[:, 2] = rng.integers(0, 16, B)
    pm[:, 3], pm[:, 4] = rng.integers(0, 16, B), rng.integers(0, 2, B)
    lo = rng.integers(0, 16, B)
    pm[:, 5], pm[:, 6] = lo, lo + rng.integers(-1, 6, B)
    pm[:, 7] = rng.integers(-2, 1, B)
    pm[:, 8] = rng.integers(I32_MIN, I32_MAX, B, endpoint=True)
    pm[:, 9] = rng.integers(0, 3, B)
    pm[:, 10] = rng.integers(I32_MIN, I32_MAX, B, endpoint=True)
    pm[:, 11], pm[:, 12] = rng.integers(-1, 2, B), rng.integers(-3, 4, B)
    pm[:, 13] = rng.integers(0, 2, B)
    for j in range(14, 20, 2):  # 3 run slots over plane 0 (0..15)
        pm[:, j] = rng.integers(0, 16, B)
        pm[:, j + 1] = pm[:, j] + rng.integers(-3, 4, B)
    for j in range(20, 28, 4):  # 2 lexicographic slots over planes 6, 7
        pm[:, j], pm[:, j + 1] = rng.integers(-1, 2, B), rng.integers(-3, 4, B)
        pm[:, j + 2] = pm[:, j] + rng.integers(-1, 2, B)
        pm[:, j + 3] = rng.integers(-3, 4, B)

    def dev(a, dt=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(DEVICE)

    return (dev(pm), dev(ops), [dev(p) for p in planes], dev(av, np.int8),
            [dev(p) for p in pays])


def wide_edge_operands(torch, qc, R: int, B: int, rng):
    """edge_operands' program and operands, with 8 more planes (values
    0-63) and its top ORed with a chain of 8 OP_SET32 leaves of 200 run
    slots each over those planes (ORs and ANDs in turn): 16 planes and 16
    payloads (32 sources) and 3228 params, so that chain_blocks' CTA holds
    fewer than 8 warps' param rows at B > 5. Most slots are empty
    (lo > hi); all from `rng`."""
    pm, ops, planes, av, pays = edge_operands(torch, qc, R, B, rng)
    S, p0 = 200, pm.shape[1]
    planes += [torch.from_numpy(rng.integers(0, 64, R).astype(np.int32))
               .to(DEVICE) for _ in range(8)]
    lo = rng.integers(0, 64, (B, 8 * S))
    hi = lo + rng.integers(-40, 3, (B, 8 * S))
    slots = np.stack([lo, hi], -1).reshape(B, -1).astype(np.int32)
    prog = []
    for j in range(8):
        prog.append((qc.OP_SET32, 8 + j, p0 + 2 * S * j, S))
        if j:
            prog.append((qc.OP_OR if j % 2 else qc.OP_AND,))
    prog.append((qc.OP_OR,))
    more = np.zeros((len(prog), qc.OP_WIDTH), np.int32)
    for i, ins in enumerate(prog):
        more[i, :len(ins)] = ins
    return (torch.cat([pm, torch.from_numpy(slots).to(DEVICE)], 1),
            torch.cat([ops, torch.from_numpy(more).to(DEVICE)]), planes, av,
            pays)


def slot_plane(torch, rng, R: int, ns: int):
    """A slot plane [R] of values in [-1, ns) from `rng`: about 1 row in 8
    at -1 (no slot), block 3 all slot ns - 1, block 4 all slot 0, block 6
    all -1."""
    sp = rng.integers(0, ns, R).astype(np.int32)
    sp[rng.random(R) < 0.125] = -1
    blocks = sp.reshape(-1, 32)
    blocks[3], blocks[4], blocks[6] = ns - 1, 0, -1
    return torch.from_numpy(sp).to(DEVICE)


def gather_operands(torch, rng):
    """(label, idx, op) edge cases of gather_rows from SEED: B in {1, 128,
    200} with repeated indices over rows of one 16-byte word, of one whole
    32 KB chunk and of 6149 words (three chunks and a part); then B = 3
    rows of the largest row the wrapper accepts (GATHER_ROW_MAX bytes)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = []
    for label, shape, dt in (("rows of 1 word", (50, 2), torch.int64),
                             ("rows of 1 chunk", (40, 4096), torch.int64),
                             ("rows of 3.002 chunks", (40, 6149 * 4),
                              torch.int32)):
        op = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                           dtype=dt, device=DEVICE)
        for B in (1, 128, 200):
            idx = torch.from_numpy(rng.integers(0, shape[0], B)
                                   .astype(np.int32)).to(DEVICE)
            cases.append((label, idx, op))
    return cases


def fused_operands(torch, rng):
    """(label, mask, plane) edge cases of fused_metrics from `rng`: T below
    one 4096-row tile (1000), whole tiles (32768) and a tile tail whose
    rows are not 16-byte aligned (12308, T % 16 == 4) at B in {1, 31, 33,
    128, 200}, over int8 masks whose selected bytes include -1, 2, 127 and
    -128 with query 0's mask all 0 (the sentinels), and planes over the
    whole int32 range; INT32_MIN and INT32_MAX planes under full masks
    over the bench's 10,027,008 rows (sums far past 2^31); masks of batch
    stride 0 (one row shared by B = 33, 128, 200 queries; bool, uint8, and
    an all-0 row)."""
    vals = np.array([0, 0, 0, 1, -1, 2, 127, -128], np.int8)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    out = []
    for T, Bs in ((1000, (1, 33)), (32768, (1, 31, 33, 128, 200)),
                  (12308, (1, 33, 200))):
        plane = dev(rng.integers(I32_MIN, I32_MAX, T, endpoint=True)
                    .astype(np.int32))
        for B in Bs:
            m = rng.choice(vals, (B, T))
            m[0] = 0
            out.append((f"int8 T={T}", dev(m), plane))
    T = 10_027_008
    full = torch.ones(2, T, dtype=torch.bool, device=DEVICE)
    for v in (I32_MIN, I32_MAX):
        out.append((f"full, all {v}", full,
                    torch.full((T,), v, dtype=torch.int32, device=DEVICE)))
    T = 32768
    plane = dev(rng.integers(I32_MIN, I32_MAX, T, endpoint=True)
                .astype(np.int32))
    row = dev(rng.random(T) < 0.3)
    for B in (33, 128, 200):
        out.append(("stride 0, bool", row[None].expand(B, T), plane))
    out.append(("stride 0, uint8", row.to(torch.uint8)[None].expand(128, T),
                plane))
    out.append(("stride 0, all 0", torch.zeros(1, T, dtype=torch.bool,
                                               device=DEVICE).expand(33, T),
                plane))
    return out


def phase_edges(torch, K, qc):
    """The redesigned kernels' edge cases, exact == their plain versions:
    batch sizes around the warps' query split and past 128, the smallest
    padded layout (R = 32768) with 8 chain planes and 16 payloads, and with
    16 chain planes and 3228 params (wide_edge_operands: fewer warps), a
    tile tail (R = 33152: 12 blocks past the last whole 1024-row tile),
    and
    INT32_MIN / INT32_MAX payloads over fully matched blocks (a TRUE
    program) beside blocks whose avalid is all 0; chain_slot_counts at ns
    around its 32-slot chunk (1, 4, 32, 33) and at the cap (4096, with B
    past the 128 kept mask words), over slot_plane; gather_rows over
    gather_operands; fused_metrics over fused_operands, with and without
    min and max. Returns each kernel's largest max_abs_err."""
    say("[4b] edge cases (exact ==)")
    rng = np.random.default_rng(SEED)
    out = []
    for R, Bs in ((32768, (1, 31, 33, 128, 200)), (33152, (1, 33))):
        for B in Bs:
            pm, ops, planes, av, pays = edge_operands(torch, qc, R, B, rng)
            out.append((f"8 planes R={R}", "chain_counts",
                        (pm, ops, planes, av)))
            out.append((f"8 planes 16 pays R={R}", "chain_blocks",
                        (pm, ops, planes, av, pays)))
    R = 32768
    true_op = torch.zeros(1, qc.OP_WIDTH, dtype=torch.int32, device=DEVICE)
    av = torch.ones(R, dtype=torch.int8, device=DEVICE)
    av.view(-1, 32)[::3] = 0
    pays = [torch.full((R,), v, dtype=torch.int32, device=DEVICE)
            for v in (I32_MIN, I32_MAX)]
    for B in (1, 128):
        pm = torch.zeros(B, 1, dtype=torch.int32, device=DEVICE)
        out.append(("extremes, matched", "chain_blocks",
                    (pm, true_op, [], av, pays)))
        out.append(("extremes, matched", "chain_counts",
                    (pm, true_op, [], av)))
        out.append(("matched ns=4", "chain_slot_counts",
                    (pm, true_op, [], av, slot_plane(torch, rng, R, 4), 4)))
    for R, Bs, nss in ((32768, (1, 31, 33, 128, 200), (1, 4, 32, 33)),
                       (33152, (1, 33), (4, 33)),
                       (32768, (1, 33, 200), (4096,))):
        for B in Bs:
            pm, ops, planes, av, _ = edge_operands(torch, qc, R,
                                                   max(B, 32), rng)
            # the queries that match most first, so that B = 1 matches rows
            hits = K.chain_counts_plain(pm, ops, planes, av).sum(1)
            pm = pm[torch.argsort(hits, descending=True, stable=True)[:B]]
            for ns in nss:
                out.append((f"8 planes ns={ns} R={R}", "chain_slot_counts",
                            (pm, ops, planes, av,
                             slot_plane(torch, rng, R, ns), ns)))
    for R, Bs in ((32768, (1, 33, 200)), (33152, (33,))):
        for B in Bs:
            pm, ops, planes, av, pays = wide_edge_operands(torch, qc, R, B,
                                                           rng)
            label = f"16 planes, 3228 prm R={R}"
            out.append((label, "chain_blocks", (pm, ops, planes, av, pays)))
            out.append((label, "chain_counts", (pm, ops, planes, av)))
            out.append((label + " ns=33", "chain_slot_counts",
                        (pm, ops, planes, av, slot_plane(torch, rng, R, 33),
                         33)))
    worst = dict.fromkeys(("fused_metrics", "chain_blocks", "chain_counts",
                           "chain_slot_counts", "gather_rows"), 0)
    for label, mask, plane in fused_operands(torch, rng):
        for minmax in (False, True):
            got = K.fused_metrics(mask, plane, minmax)
            err = _check_equal(torch, "fused_metrics", label, got,
                               K.fused_metrics_plain(mask, plane, minmax))
            worst["fused_metrics"] = max(worst["fused_metrics"], err)
            say(f"  {'fused_metrics':17s} {label:26s} B={mask.shape[0]:<4d} "
                f"minmax {int(minmax)} max_abs_err {err}  selected "
                f"{int(got[0].sum())}  sum of sums {int(got[1].sum())}  "
                f"empty {int((got[0] == 0).sum())}")
        del got
    for label, name, args in out:
        got = getattr(K, name)(*args)
        err = _check_equal(torch, name, label, got,
                           getattr(K, name + "_plain")(*args))
        worst[name] = max(worst[name], err)
        c = _outputs(got)[0]
        full = int((c == (128 if name == "chain_counts" else 32)).sum())
        say(f"  {name:17s} {label:26s} B={args[0].shape[0]:<4d} "
            f"max_abs_err {err}  matched {int(c.to(torch.int64).sum())}  "
            f"full groups {full}  empty groups {int((c == 0).sum())}")
        del got, c
    del out
    cases = gather_operands(torch, rng)
    big = torch.randint(-128, 127, (2, K.GATHER_ROW_MAX), dtype=torch.int8,
                        device=DEVICE)
    cases.append(("largest row", torch.tensor([1, 0, 1], dtype=torch.int32,
                                              device=DEVICE), big))
    for label, idx, op in cases:
        got = K.gather_rows(idx, op)
        err = _check_equal(torch, "gather_rows", label, got,
                           K.gather_rows_plain(idx, op))
        worst["gather_rows"] = max(worst["gather_rows"], err)
        say(f"  {'gather_rows':17s} {label:26s} B={idx.shape[0]:<4d} "
            f"max_abs_err {err}  row bytes "
            f"{op.numel() // op.shape[0] * op.element_size()}  distinct "
            f"rows {int(torch.unique(idx).numel())}")
        del got
    del cases, big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def product_bound(name, B, rows, K, in_bytes, out_bytes):
    """(bound_ms, bound_by) of one product call, printing both counts: the
    larger of the bytes it must move (its indicator or mask, its operand,
    its output) over HBM_BYTES_PER_S and its 2 * B * rows * K tensor
    operations over the card's dense peak for the product's type
    (TENSOR_OPS_PER_S: int8 for the cube's, bf16 for the dense ones). A
    mask of batch stride 0 counts as one row."""
    moved = in_bytes + out_bytes
    ops = 2 * B * rows * K
    kind = PRODUCTS[name][2]
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / TENSOR_OPS_PER_S[kind] * 1e3
    say(f"  {name:22s} bound of B={B}: {moved} bytes ({t_bytes:.4f} ms), "
        f"{ops} {kind} tensor ops ({t_ops:.4f} ms)")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _digits_plain(torch, ind, hist, M):
    """Plain version of block_counts / slot_block_counts' product: the
    indicator by the two-digit histogram as a float64 product (exact: each
    dot < 2^24), digits combined -> int32 [B, M]."""
    D = ind.shape[1]
    d = (ind.to(torch.float64) @ hist[:2 * M, :D].t().to(torch.float64)
         ).to(torch.int32)
    return d[:, :M] + (d[:, M:2 * M] << 7)


def onehot_product(torch, R, bid, nb, payload=None, bound=None):
    """The bf16 one-hot product the dense bucket counts and sums ran as
    before the dense_buckets kernel (its yardstick, library_ms): a
    function of a [B, T] mask multiplying it by a resident operand built
    here — bid's one-hot, or the payload's 7-bit pieces under it (the JAX
    package's column order) — with R._mm_sums (a stride-0 mask as one
    row), recombined to [B, nb] int64; and the operand's bytes."""
    n = 1 if payload is None else R.npieces_for_bound(bound)

    def cols(a, b, dt):
        oh = bid[a:b, None] == torch.arange(nb, dtype=bid.dtype,
                                            device=bid.device)
        if payload is None:
            return oh.to(dt)
        return torch.cat([torch.where(oh, p[:, None], 0).to(dt)
                          for p in R._pieces(payload[a:b], n)], dim=1)
    op = R._fill(cols, bid.shape[0], n * nb, bid.device)

    def product(mask):
        acc = R._mm_sums(mask, n * nb, op)
        return acc if payload is None else R._recombine(
            acc.reshape(mask.shape[0], n, nb), n)
    return product, op.numel() * op.element_size()


def phase_dense(torch, K, records, label, B, args, lib=None):
    """One dense_buckets case of phase 4p: the kernel == its plain version
    (and == `lib`, the bf16 one-hot product, where given), CUDA-event
    median ms of each, the bound (kernel_bound), the torch.profiler device
    ms at B = 1 and 128; kept in the kernel's record as a variant, and as
    its B = 1 / B = 128 numbers where `label` is c3's sum / c5's counts."""
    kern = lambda: K.dense_buckets(*args)  # noqa: E731
    plain = lambda: K.dense_buckets_plain(*args)  # noqa: E731
    got = kern()
    err = _check_equal(torch, "dense_buckets", f"{label} B={B}", got,
                       plain())
    if lib is not None:
        err = max(err, _check_equal(torch, "dense_buckets",
                                    f"{label} B={B} vs the bf16 product",
                                    got, lib()))
    iters = 30 if B == 1 else 10
    ms = _cuda_ms(torch, kern, iters)
    plain_ms = _cuda_ms(torch, plain, 3)
    lib_ms = None if lib is None else _cuda_ms(torch, lib, iters)
    bound_ms, bound_by = kernel_bound(torch, None, "dense_buckets", args,
                                      _outputs(got))
    dev_ms = _device_ms(torch, kern) if B in (1, 128) else None
    say(f"  dense_buckets     {label:18s} B={B:<4d} kernel {ms:.4f} ms  "
        f"device {dev_ms} ms  plain {plain_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms ({bound_by})"
        + ("" if lib_ms is None else f"  bf16 product {lib_ms:.4f} ms")
        + f"  max_abs_err {err}")
    rec = records.setdefault("dense_buckets", {
        "name": "dense_buckets", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["dense_buckets"], "launches": 0,
        "max_abs_err": 0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    one = {"label": label, "B": B, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms}
    rec.setdefault("variants", []).append(one)
    if (label, B) in (("c3 sum shared", 1), ("c5 pf/h counts", 128)):
        sfx = "" if B == 1 else "_b128"
        rec.update({k + sfx: one[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "label")})


def nyc_extreme_operands(torch, T: int, seed: int):
    """The nyc_taxis cell's distance_amount_agg operands over T rows, made
    from `seed` as perfbench/data/nyc_taxis.py draws the trips, on the
    card: the range-laid-out bucket plane (distances lognormal, median 1.7
    mi, 1% zeros, 0.1% past the range; floor(d) where 0 <= d < 50, else -1,
    and -1 past the docs), its range mask [1, T], total_amount's wide (hi,
    lo) planes (amounts lognormal, median $11.80, 0.05% refunds, split from
    their order-preserving int64) and a second pair a little above it (a
    max plane beside a min plane), and the amounts in cents as a narrow
    int32 plane."""
    from tantivy_aggregations_tpu_torch.ops.cube import split_rm
    from tantivy_aggregations_tpu_torch.utils.mono import f64_to_mono
    rng = np.random.default_rng(seed)
    docs = min(T, NYC_DOCS)
    d = np.round(rng.lognormal(np.log(1.7), 0.9, T), 2)
    d[rng.random(T) < 0.01] = 0.0
    d[rng.random(T) < 0.001] = 75.0
    bid = np.where(d < 50.0, np.floor(d), -1).astype(np.int32)
    bid[docs:] = -1
    a = np.round(rng.lognormal(np.log(11.8), 0.6, T), 2)
    a[rng.random(T) < 0.0005] *= -1
    dev = torch.device(DEVICE)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    wide = tuple(map(put, split_rm(f64_to_mono(a))))
    wide_hi = tuple(map(put, split_rm(f64_to_mono(
        a + np.round(rng.random(T) * 5, 2)))))
    return {"bid": put(bid), "mask": put(bid >= 0)[None], "wide": wide,
            "wide_max": wide_hi,
            "narrow": put(np.round(a * 100).astype(np.int32))}


def phase_extremes(torch, K, R, records) -> None:
    """[4e] dense_extremes against its plain version (dense_bucket_min /
    dense_bucket_max over wide_recon), exact ==: on the nyc_taxis cell's
    distance histogram over its NYC_ROWS rows (nyc_extreme_operands: 50
    buckets; stats of a wide and of a narrow payload, a min and a max
    plane of their own) at B = 1 and 128 (distinct masks, and the range
    mask shared at batch stride 0); on the plane's first EXTREME_ROWS rows
    at B = 3, 31, 33 and 200; at its edges: 4096 buckets at B = 200 (the
    query tiles) and 100,000 at B = 3 (the bucket tiles), one bucket under
    full masks over pairs and values at INT32_MIN / INT32_MAX, sorted ids,
    T % 4 != 0, a min or a max alone. At B = 1 and 128 on the nyc shape,
    the CUDA-event median ms, the torch.profiler device ms, the plain
    version's ms, the bound (kernel_bound) and, at B = 1, `library_ms`:
    the two int64 scatter_reduce_ passes (amin, amax) the port ran before,
    on their prebuilt index and value planes. Adds the kernel's record to
    `records`."""
    say("[4e] dense_extremes vs its plain version (exact ==)")
    rec = records.setdefault("dense_extremes", {
        "name": "dense_extremes", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["dense_extremes"], "launches": 0,
        "max_abs_err": 0})
    t0 = time.time()
    nyc = nyc_extreme_operands(torch, NYC_ROWS, SEED)
    torch.cuda.synchronize()
    say(f"  nyc operands: {NYC_ROWS} rows, {NYC_NB} buckets, made in "
        f"{time.time() - t0:.1f}s")
    bid, mask = nyc["bid"], nyc["mask"]
    T = bid.shape[0]
    dev = bid.device
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def masks(B, rows, p):
        """B random masks of `rows` rows, each row selected with
        probability p, drawn on the card a few queries at a time."""
        out = torch.empty(B, rows, dtype=torch.bool, device=dev)
        step = max(1, (1 << 28) // rows)
        for b0 in range(0, B, step):
            b1 = min(B, b0 + step)
            out[b0:b1] = torch.rand((b1 - b0, rows), generator=gen,
                                    device=dev) < p
        return out

    def case(label, args, timed=False, lib=None):
        kern = lambda: K.dense_extremes(*args)  # noqa: E731
        plain = lambda: K.dense_extremes_plain(*args)  # noqa: E731
        t1 = time.time()
        got = kern()
        torch.cuda.synchronize()
        err = _check_equal(torch, "dense_extremes", label, got, plain())
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        B = args[0].shape[0]
        if not timed:
            say(f"  dense_extremes    {label:32s} B={B:<4d} == plain "
                f"({time.time() - t1:.1f}s)")
            return
        ms = _cuda_ms(torch, kern, 30 if B == 1 else 10)
        dev_ms = _device_ms(torch, kern)
        plain_ms = _cuda_ms(torch, plain, 3 if B == 1 else 1)
        lib_ms = None if lib is None else _cuda_ms(torch, lib, 10)
        bound_ms, bound_by = kernel_bound(torch, None, "dense_extremes",
                                          args, _outputs(got))
        say(f"  dense_extremes    {label:32s} B={B:<4d} kernel {ms:.4f} ms  "
            f"device {dev_ms} ms  plain {plain_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})"
            + ("" if lib_ms is None else
               f"  scatter_reduce_ amin + amax {lib_ms:.4f} ms")
            + f"  max_abs_err {err}")
        one = {"label": label, "B": B, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
        rec.setdefault("variants", []).append(one)
        sfx = "" if B == 1 else "_b128"
        if "ms" + sfx not in rec:
            rec.update({k + sfx: one[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "label")})

    # the parent's path at B = 1 (library_ms): its two int64 scatters over
    # their prebuilt flat index and value planes
    idx, ok = R._bucket_index(bid, mask, NYC_NB, slice(0, 1))
    rm = R.wide_recon(*nyc["wide"])
    vmin = torch.where(ok, rm, R.I64_MAX).reshape(-1)
    vmax = torch.where(ok, rm, R.I64_MIN).reshape(-1)
    outs = torch.empty(2, NYC_NB, dtype=torch.int64, device=dev)

    def scatters():
        outs[0].fill_(R.I64_MAX).scatter_reduce_(0, idx, vmin, "amin")
        outs[1].fill_(R.I64_MIN).scatter_reduce_(0, idx, vmax, "amax")
    wide, narrow = nyc["wide"], (nyc["narrow"],)
    case("nyc stats wide", (mask, bid, NYC_NB, wide, wide), timed=True,
         lib=scatters)
    scatters()
    check(torch.equal(outs[0], K.dense_extremes(mask, bid, NYC_NB,
                                                wide)[0][0])
          and torch.equal(outs[1], K.dense_extremes(mask, bid, NYC_NB, None,
                                                    wide)[1][0]),
          "dense_extremes on the nyc shape != the two scatter_reduce_ passes")
    del scatters, idx, ok, rm, vmin, vmax, outs
    case("nyc stats narrow", (mask, bid, NYC_NB, narrow, narrow),
         timed=True)
    case("nyc min and max planes wide",
         (mask, bid, NYC_NB, wide, nyc["wide_max"]), timed=True)
    case("nyc stats wide shared mask",
         (mask.expand(128, T), bid, NYC_NB, wide, wide))
    m128 = masks(128, T, 0.5) & mask
    case("nyc stats wide distinct masks", (m128, bid, NYC_NB, wide, wide),
         timed=True)
    del m128
    # the batch sizes past them, on the plane's first rows
    n = EXTREME_ROWS
    sb, sw = bid[:n], tuple(t[:n] for t in wide)
    sn = (nyc["narrow"][:n],)
    for B in (3, 31, 33, 200):
        mb = masks(B, n, 0.6)
        case(f"{n} rows wide", (mb, sb, NYC_NB, sw, sw))
        case(f"{n} rows narrow min and max planes",
             (mb, sb, NYC_NB, sn, (nyc["narrow"][n:2 * n],)))
    # the query tiles (4096 buckets, 200 distinct masks) and the bucket
    # tiles (100,000 buckets)
    for nbig, B in ((4096, 200), (100_000, 3)):
        ids = torch.from_numpy(rng.integers(-1, nbig + 1, n).astype(
            np.int32)).to(dev)
        mb = masks(B, n, 0.5)
        case(f"{nbig} buckets wide", (mb, ids, nbig, sw, sw))
        case(f"{nbig} buckets narrow", (mb, ids, nbig, sn, sn))
    del ids, mb
    # one bucket under full masks: pairs and values at the int32 extremes
    one = torch.zeros(n, dtype=torch.int32, device=dev)
    full = torch.ones(2, n, dtype=torch.bool, device=dev)
    ext = torch.from_numpy(rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0,
                                                I32_MAX - 1, I32_MAX],
                                               np.int32), (2, n))).to(dev)
    case("one bucket int32 extremes wide", (full, one, 1, tuple(ext),
                                            tuple(ext)))
    case("one bucket int32 extremes narrow", (full, one, 1, (ext[0],),
                                              (ext[1],)))
    del one, full, ext
    # sorted ids (every lane of a warp on one bucket), T % 4 != 0, one
    # extreme alone
    srt = torch.sort(sb).values
    case("sorted ids", (mask[:, :n], srt, NYC_NB, sw, sw))
    odd = n - 3
    m17 = masks(17, odd, 0.5)
    case("T%4=1", (m17, sb[:odd].contiguous(), NYC_NB,
                   tuple(t[:odd].contiguous() for t in sw),
                   tuple(t[:odd].contiguous() for t in sw)))
    case("min alone", (mask[:, :n], sb, NYC_NB, sw, None))
    case("max alone", (mask[:, :n], sb, NYC_NB, None, sn))
    del srt, m17, nyc, sb, sw, sn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_products(torch, K, C, R, qc, row, dflt, flagship, kernel_records):
    """[4p] The matrix products and the dense_buckets kernel against their
    plain versions, exact ==, on the main path's operands at B = 1 and 128
    (and 17, 31, 200): cube_dots on c5's post-filter site (and its count /
    sum(qty) against the row reduction under the same chain); block_counts
    on c5's pcube against chain_counts' per-128-row counts summed to G;
    slot_block_counts on c9's scube against chain_slot_counts' per-32-row
    counts summed to G; dense_buckets (phase_dense) on c3's histogram of
    ts and its sum(amount) under the shared MatchAll mask, on c5's
    post-filter histogram of qty (the row-mode c5's node: B distinct
    masks) and its sum(qty), and on a value-row plane (a histogram of the
    multi-valued weights with sum(amount): the plan's resident amount at
    the rows' docs, c5's masks read at them), each also against the bf16
    one-hot product at B = 1 and 128; dense_buckets' edges: one bucket
    under full masks of INT32_MIN / INT32_MAX and -2^15 / 2^15 - 1
    payloads, sorted ids, a row count that is not a
    multiple of 4 (its byte loads), 4096 buckets at B = 200 (the query
    tiles) and 100,000 at B = 2 (the bucket tiles); masked_sum_planes_mm
    on c2's avg(weights) pre-aggregates. Then cube_dots with Dprod 1003
    and K 13 (neither a multiple of 8) on seeded operands. Prints
    CUDA-event median ms, the plain version's, torch.profiler device ms
    and the bound; for c8 the cube product on a [Dprod, K] row-major
    operand. Adds dense_buckets' record to `kernel_records`; returns the
    product records (launches filled in later)."""
    say("[4p] matrix products and dense_buckets vs plain versions "
        "(exact ==)")
    cfgs = {n: (q, a) for n, _, q, a in all_configs(flagship)}

    def pmat_for(prog, n, B):
        reqs = flagship.varied_requests(n, cfgs[n][1], B)
        return qc.param_matrix([prog._extract(q, a) for q, a in reqs],
                               prog._pkeys, prog.device)

    d5, r5 = dflt._program_for(*cfgs[5]), row._program_for(*cfgs[5])
    d9, r9 = dflt._program_for(*cfgs[9]), row._program_for(*cfgs[9])
    d3, d8 = dflt._program_for(*cfgs[3]), dflt._program_for(*cfgs[8])
    r2 = row._program_for(*cfgs[2])
    records = {}

    def run(name, label, B, fn, plain, bound_args, iters=None, also=None):
        got = fn()
        err = _check_equal(torch, name, f"{label} B={B}", got, plain())
        for what, want in (also or ()):
            e2 = _check_equal(torch, name, f"{label} B={B} vs {what}",
                              got, want)
            err = max(err, e2)
        iters = iters or (30 if B == 1 else 10)
        ms = _cuda_ms(torch, fn, iters)
        plain_ms = _cuda_ms(torch, plain, 3)
        bound_ms, bound_by = product_bound(name, *bound_args)
        rec = records.setdefault(name, {
            "name": name, "route": "torch._int_mm" if PRODUCTS[name][2] ==
            "int8" else "torch.bmm bf16 (fp32 partials)",
            "source": PRODUCTS[name][0], "replaces": PRODUCTS[name][1],
            "launches": 0, "max_abs_err": 0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        say(f"  {name:22s} {label:14s} B={B:<4d} product {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
            f"max_abs_err {err}"
            + "".join(f"  == {w}" for w, _ in (also or ())))
        if B in (1, 128) and "ms" + ("" if B == 1 else "_b128") not in rec:
            sfx = "" if B == 1 else "_b128"
            dev_ms = _device_ms(torch, fn)
            say(f"  {name:22s} {label:14s} B={B:<4d} device time {dev_ms} ms "
                "(torch.profiler)")
            rec.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                        "bound_ms" + sfx: bound_ms,
                        "bound_by" + sfx: bound_by, "library_ms" + sfx: None,
                        "device_ms" + sfx: dev_ms, "label" + sfx: label})
        return got

    # dense_buckets on c3's histogram: the MatchAll mask shared by the
    # batch (stride 0), as the main path hands it over
    h = d3.plan[("a", "h")]
    bound3, key3 = d3.plan[("a", "h", "s")]["dense_mm"][h["bid_key"]][
        "sums"][0]
    bid, nb, amount = d3._arrays[h["bid_key"]], h["nb"], d3._arrays[key3]
    T = bid.shape[0]
    alive = (d3._arrays["alive"] > 0)[None]
    prod_c, op_c = onehot_product(torch, R, bid, nb)
    prod_s, op_s = onehot_product(torch, R, bid, nb, amount, bound3)
    say(f"  c3's one-hot operands (the bf16 product's, built here): "
        f"{op_c} + {op_s} bytes")
    for B in (1, 17, 31, 128, 200):
        mask = alive.expand(B, T)
        lib = B in (1, 128)
        phase_dense(torch, K, kernel_records, "c3 counts shared", B,
                    (mask, bid, nb),
                    (lambda m=mask: prod_c(m)) if lib else None)
        phase_dense(torch, K, kernel_records, "c3 sum shared", B,
                    (mask, bid, nb, amount),
                    (lambda m=mask: prod_s(m)) if lib else None)
    del prod_c, prod_s
    # the 16-bit pieces' edge: one bucket under full masks over every row
    one = torch.zeros_like(bid)
    full = torch.ones(2, T, dtype=torch.bool, device=bid.device)
    for v in (I32_MIN, I32_MAX, -2**15, 2**15 - 1):
        pl = torch.full((T,), v, dtype=torch.int32, device=bid.device)
        got = K.dense_buckets(full, one, 1, pl)
        check(torch.equal(got, K.dense_buckets_plain(full, one, 1, pl))
              and int(got[0, 0]) == v * T,
              f"dense_buckets at {v} over {T} rows != index_add_")
        say(f"  dense_buckets     all {v} over {T} rows, full masks: "
            f"{int(got[0, 0])} == index_add_")
    del one, full, pl
    # sorted ids (every lane of a warp on one bucket), then T % 4 != 0
    srt = torch.sort(bid).values
    phase_dense(torch, K, kernel_records, "c3 sum sorted ids", 1,
                (alive, srt, nb, amount))
    odd = T - 3
    rng = np.random.default_rng(SEED)
    m17 = torch.from_numpy(rng.random((17, odd)) < 0.5).to(bid.device)
    phase_dense(torch, K, kernel_records, "c3 sum T%4=1", 17,
                (m17, bid[:odd].contiguous(), nb,
                 amount[:odd].contiguous()))
    del srt, m17
    # the query tiles (4096 buckets, 200 distinct masks) and the bucket
    # tiles (100,000 buckets)
    for nbig, B in ((4096, 200), (100_000, 2)):
        ids = torch.from_numpy(rng.integers(-1, nbig + 1, T).astype(
            np.int32)).to(bid.device)
        mb = torch.from_numpy(rng.random((B, T)) < 0.5).to(bid.device)
        phase_dense(torch, K, kernel_records, f"{nbig} buckets counts",
                    B, (mb, ids, nbig))
        phase_dense(torch, K, kernel_records, f"{nbig} buckets sum", B,
                    (mb, ids, nbig, amount))
        del ids, mb
    # a value-row plane: a histogram of the multi-valued weights over its
    # value rows with sum(amount), planned on the default config
    mv_aggs = {"h": flagship.histogram_agg(
        "weights", interval=100,
        sub_aggs={"s": flagship.sum_agg("amount")})}
    dmv = dflt._program_for(flagship.MatchAllQuery(), mv_aggs)
    hv = dmv.plan[("a", "h")]
    _, key_v = dmv.plan[("a", "h", "s")]["dense_mm"][hv["bid_key"]][
        "sums"][0]
    bid_v, nb_v = dmv._arrays[hv["bid_key"]], hv["nb"]
    pay_v, doc_v = dmv._arrays[key_v], dmv._arrays[hv["row_doc"]]
    valid_v = dmv._arrays["weights:valid"] > 0
    check(key_v.startswith("DPAY#") and torch.equal(pay_v, amount[doc_v]),
          "the value-row payload is not amount read at the rows' docs")
    pf = d5.plan[("a", "pf")]["cube"]
    pfs = d5.plan[("a", "pf", "s")]["cube"]
    pc = d5.plan[("a", "p")]["pcube"]
    sc = d9.plan[("a", "t", "p")]["scube"]
    qty = r5._arrays["qty:w"]
    for B in (1, 17, 31, 128, 200):
        pm5 = pmat_for(d5, 5, B)
        d5._ind_cache = {}
        # cube_dots: c5's post-filter count site, then its sum(qty) site
        ind = d5._cube_ind(pf, pm5)
        op = d5._arrays[pf["key"]]
        D, Kp = ind.shape[1], op.shape[0]
        row_mask = (r5._root_mask(pm5, r5._arrays) & r5._chain_mask(
            r5.plan[("a", "pf")]["fmask"], pm5, r5._arrays))
        dots = run("cube_dots", "c5 pf count", B,
                   lambda: C.cube_dots(ind, op),
                   lambda: (ind.to(torch.float64) @ op[:, :D].t().to(
                       torch.float64)).to(torch.int32),
                   (B, D, Kp, B * D + op.numel(), B * Kp * 4))
        check(torch.equal(C.recombine(dots, pf["layout"])["cnt"],
                          R.ts_count(row_mask)),
              "c5 pf cube count != the row count under the same chain")
        ops = d5._arrays[pfs["key"]]
        dots = run("cube_dots", "c5 pf sum(qty)", B,
                   lambda: C.cube_dots(ind, ops),
                   lambda: (ind.to(torch.float64) @ ops[:, :D].t().to(
                       torch.float64)).to(torch.int32),
                   (B, D, ops.shape[0], B * D + ops.numel(),
                    B * ops.shape[0] * 4))
        rec = C.recombine(dots, pfs["layout"])
        check(torch.equal(rec["sum"], R.ts_sum_plane(qty, row_mask))
              and torch.equal(rec["cnt"], R.ts_count(row_mask)),
              "c5 pf cube sum(qty) != the row reduction")
        # block_counts: c5's pcube vs chain_counts per 128 rows, summed
        ind = d5._cube_ind(pc, pm5)
        hist = d5._arrays[pc["key"]]
        G, NB = pc["G"], pc["NB"]
        cc = K.chain_counts(*_chain_counts_args(r5, pm5))
        run("block_counts", "c5 pcube", B,
            lambda: C.block_counts(ind, hist, NB),
            lambda: _digits_plain(torch, ind, hist, NB),
            (B, ind.shape[1], 2 * NB, B * ind.shape[1] + hist.numel(),
             B * NB * 4),
            also=(("chain_counts summed to G",
                   cc.reshape(B, NB, G // 128).sum(-1, dtype=torch.int32)),))
        # slot_block_counts: c9's scube vs chain_slot_counts, summed
        pm9 = pmat_for(d9, 9, B)
        d9._ind_cache = {}
        ind = d9._cube_ind(sc, pm9)
        hist = d9._arrays[sc["key"]]
        ns = d9.plan[("a", "t", "p")]["nslots"]
        G, NB = sc["G"], sc["NB"]
        cs = K.chain_slot_counts(*_chain_slot_args(r9, pm9))
        run("slot_block_counts", "c9 scube", B,
            lambda: C.slot_block_counts(ind, hist, ns, NB),
            lambda: _digits_plain(torch, ind, hist, NB * ns).reshape(
                B, NB, ns).transpose(1, 2),
            (B, ind.shape[1], 2 * NB * ns, B * ind.shape[1] + hist.numel(),
             B * NB * ns * 4),
            also=(("chain_slot_counts summed to G",
                   cs.reshape(B, ns, NB, G // 32).sum(-1,
                                                      dtype=torch.int32)),))
        # dense_buckets on c5's post-filter histogram of qty (row-mode
        # node: B distinct masks over 10M rows) and its sum(qty); then the
        # value-row plane under the same masks read at the rows' docs
        h5 = r5.plan[("a", "pf", "h")]
        bid5, nb5 = r5._arrays[h5["bid_key"]], h5["nb"]
        lib = B in (1, 128)
        for what, extra in (("counts", ()), ("sum(qty)", (qty,))):
            prod = None
            if lib:
                prod, _ = onehot_product(torch, R, bid5, nb5, *extra,
                                         bound=(0, 99))
            phase_dense(torch, K, kernel_records, f"c5 pf/h {what}", B,
                        (row_mask, bid5, nb5, *extra),
                        (lambda m=row_mask: prod(m)) if lib else None)
            del prod
        vmask = row_mask[:, doc_v] & valid_v
        phase_dense(torch, K, kernel_records, "value rows sum", B,
                    (vmask, bid_v, nb_v, pay_v))
        del row_mask, cc, cs, vmask
    # masked_sum_planes_mm: c2's avg(weights) per-doc pre-aggregates
    col = r2.dindex.column("weights")
    pb = col.preagg_bounds(r2.dindex.T)
    planes = [r2._arrays["weights:pre:cnt"]] + [
        r2._arrays["weights:pre:sum"][:, i]
        for i in range(r2._arrays["weights:pre:sum"].shape[1])]
    bounds = [pb["cnt"]] + pb["sum"]
    op_p = R.sum_planes_operand(planes, bounds)
    T = planes[0].shape[0]
    for B in (1, 128):
        pm2 = pmat_for(r2, 2, B)
        m2 = r2._root_mask(pm2, r2._arrays)
        run("masked_sum_planes_mm", "c2 avg_w", B,
            lambda: R.masked_sum_planes_mm(m2, planes, bounds, op=op_p),
            lambda: R.masked_sum_planes(m2, planes),
            (B, T, op_p.shape[1], B * T + op_p.numel() * 2,
             B * len(planes) * 8), iters=5)
    del op_p, m2
    # c8's cube site: the product on a [Dprod, K] row-major operand
    c8 = d8.plan[("a", "n")]["cube"]
    pm8 = pmat_for(d8, 8, 128)
    d8._ind_cache = {}
    ind = d8._cube_ind(c8, pm8)
    op = d8._arrays[c8["key"]]
    a = torch.nn.functional.pad(ind.view(torch.int8),
                                (0, op.shape[1] - ind.shape[1]))
    op_rm = op.t().contiguous()
    t = [_cuda_ms(torch, f, 10) for f in (
        lambda: torch._int_mm(a, op.t()), lambda: torch._int_mm(a, op_rm),
        lambda: torch._int_mm(a, op_rm), lambda: torch._int_mm(a, op.t()))]
    check(torch.equal(torch._int_mm(a, op.t()), torch._int_mm(a, op_rm)),
          "c8 cube product layouts disagree")
    say(f"  c8 cube product B=128 Dprod {ind.shape[1]}: [K, Dprod] operand "
        f"(the resident layout) {t[0]:.4f} / {t[3]:.4f} ms, [Dprod, K] "
        f"row-major {t[1]:.4f} / {t[2]:.4f} ms (in turns)")
    records["cube_dots"]["c8_layouts_ms"] = {"resident": [t[0], t[3]],
                                             "row_major": [t[1], t[2]]}
    # padding: Dprod 1003 and K 13, neither a multiple of 8
    rng = np.random.default_rng(SEED)
    pieces = rng.integers(-128, 128, (1003, 13)).astype(np.int8)
    op = C.device_operand(pieces, DEVICE)
    for B in (1, 17, 31, 128, 200):
        ind = torch.from_numpy(rng.random((B, 1003)) < 0.5).to(DEVICE)
        got = C.cube_dots(ind, op)
        want = torch.from_numpy(ind.cpu().numpy().astype(np.int64)
                                @ pieces.astype(np.int64)).to(DEVICE)
        check(torch.equal(got[:, :13].to(torch.int64), want),
              f"cube_dots padded case B={B} != numpy")
        say(f"  cube_dots              Dprod 1003 K 13  B={B:<4d} == numpy "
            "int64 (max_abs_err 0)")
    del cfgs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def load_against(path: str, name: str = "tat_against"):
    """The kernels module of the port package in another tree (say the
    parent commit, unpacked with git archive), imported under the package
    name `name`; its kernels build into that tree."""
    import importlib
    import importlib.util
    root = Path(path).resolve() / "tantivy_aggregations_tpu_torch"
    check((root / "__init__.py").exists(), f"no port package under {path}")
    spec = importlib.util.spec_from_file_location(
        name, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.kernels")


def _other_kernel(torch, old, name):
    """The other tree's kernel `name`, called as the main path calls this
    tree's (its gather_rows takes the RowOperand's tensor; a fused_metrics
    without `minmax` gets a contiguous mask, as its caller made one, and
    its min and max are dropped where they are not asked for)."""
    f = getattr(old, name)
    if name == "gather_rows":
        return lambda idx, op: f(idx, _operand(torch, op))
    if name == "fused_metrics" and "minmax" not in f.__code__.co_varnames:
        def fused(mask, plane, minmax=True):
            cnt, tot, mn, mx = f(mask.contiguous(), plane)
            return (cnt, tot, mn, mx) if minmax else (cnt, tot, None, None)
        return fused
    return f


def phase_ab(torch, K, old, cases, searcher, flagship):
    """Median CUDA-event ms of the other tree's kernel and this tree's on
    the same operands, in turns (old, new, new, old; gather_rows with
    index_select between: old, new, lib, lib, new, old), outputs ==; then
    the AB_CONFIGS end to end through either tree's kernels
    (phase_ab_config)."""
    say("[4c] A/B against the other tree's kernels (old, new, new, old)")
    t0 = time.time()
    lib = old.build()
    say(f"  built the other tree's kernels in {time.time() - t0:.1f}s")
    _say_ptxas(lib)
    # the other tree's interpreter may lack the set opcodes of this tree's
    # every-opcode query
    old_qc = sys.modules[old.__name__.rsplit(".", 2)[0] + ".query.compile"]
    if not hasattr(old_qc, "OP_SET_WIDE"):
        cases = {k: v for k, v in cases.items() if k[1] != "every-op"}
    # ... and may refuse param rows past 256 (its wrappers' old limit)
    if not hasattr(old, "chain_fits"):
        cases = {k: v for k, v in cases.items() if k[1] != "wide-set"}
    for (name, label, B), args in cases.items():
        f_old = lambda a=args, f=_other_kernel(torch, old, name): f(*a)  # noqa
        f_new = lambda a=args, f=getattr(K, name): f(*a)  # noqa: E731
        err = _check_equal(torch, name, f"{label} B={B} old vs new",
                           f_new(), f_old())
        turns = [f_old, f_new, f_new, f_old]
        if name == "gather_rows":
            lib = lambda a=args: torch.index_select(  # noqa: E731
                _operand(torch, a[1]), 0, a[0])
            turns[2:2] = [lib, lib]
        t = [_cuda_ms(torch, f, 30) for f in turns]
        new_ms, old_ms = t[1] + t[-2], t[0] + t[-1]
        say(f"  {name:17s} {label:10s} B={B:<4d} "
            + " / ".join(f"{n} {x:.4f}" for n, x in zip(
                ["old", "new", "lib", "lib", "new", "old"] if len(t) == 6
                else ["old", "new", "new", "old"], t))
            + f" ms  speed-up {old_ms / new_ms:.2f}x  max_abs_err {err}")
    for n, names in AB_CONFIGS:
        phase_ab_config(torch, K, old, searcher, flagship, n, names)


def phase_ab_config(torch, K, old, searcher, flagship, n, names,
                    reps: int = 3):
    """Config n end to end with the other tree's kernels `names` swapped
    into this tree's kernels module and with its own, in turns (old, new,
    new, old) `reps` times: msearch ms/q with dedup off (256 requests) and
    the p50 of 20 single queries, fruits ==; then one dedup-off group of
    each under torch.profiler."""
    _, label, q, aggs = {c[0]: c for c in all_configs(flagship)}[n]
    reqs = flagship.varied_requests(n, aggs, 256)
    sides = {"old": {k: _other_kernel(torch, old, k) for k in names},
             "new": {k: getattr(K, k) for k in names}}
    dedup_on = searcher.config
    searcher.config = dataclasses.replace(dedup_on, msearch_dedup=False)
    msq = {"old": [], "new": []}
    p50 = {"old": [], "new": []}
    try:
        want = searcher.agg_search(q, aggs)
        batch = searcher.agg_search_batch(reqs)
        for side in ("old", "new", "new", "old") * reps:
            for k, f in sides[side].items():
                setattr(K, k, f)
            check(searcher.agg_search(q, aggs) == want,
                  f"c{n} through the {side} kernels != this tree's")
            if side == "old" and not msq["old"]:
                check(searcher.agg_search_batch(reqs) == batch,
                      f"c{n} msearch through the old kernels != this tree's")
            msq[side].append(_msearch_ms_per_q(torch, searcher, reqs))
            times = []
            for rq, ra in reqs[:20]:
                t0 = time.perf_counter()
                searcher.agg_search(rq, ra)
                times.append((time.perf_counter() - t0) * 1e3)
            p50[side].append(statistics.median(times))
        cap = min(dedup_on.max_batch, searcher._program_for(q, aggs).batch_cap
                  or dedup_on.max_batch)
        for side in ("old", "new"):
            for k, f in sides[side].items():
                setattr(K, k, f)
            say(f"  c{n} {side} kernels:", end="")
            _profile_group(torch, searcher, reqs[:cap])
    finally:
        for k, f in sides["new"].items():
            setattr(K, k, f)
        searcher.config = dedup_on
    for side in ("old", "new"):
        say(f"  {label} end to end, {side} kernels: msearch dedup off ms/q "
            + " ".join(f"{x:.4f}" for x in msq[side])
            + f" (median {statistics.median(msq[side]):.4f}); p50 single ms "
            + " ".join(f"{x:.3f}" for x in p50[side])
            + f" (median {statistics.median(p50[side]):.3f})")


def _msearch_ms_per_q(torch, searcher, reqs) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    searcher.agg_search_batch(reqs)
    return (time.perf_counter() - t0) * 1e3 / len(reqs)


def c6_reference(tt, idx, query, aggs) -> dict:
    """c6's fruit by plain numpy over the segments: terms over sku ordered
    by sum(amount) desc (ties key asc), with the sum and count subs. The
    oracle's own c6 path refines each of the 100k buckets over every row,
    which does not finish at 10M docs; the CPU tests hold the port's c6 to
    the oracle at small sizes."""
    t = aggs["t"]
    check(isinstance(query, tt.MatchAllQuery) and t.field == "sku"
          and t.order == ("s", "desc")
          and [(nm, type(s).__name__, getattr(s, "field", None))
               for nm, s in t.sub_aggs]
          == [("s", "SumAgg", "amount"), ("n", "CountAgg", None)],
          "c6 reference: unexpected request shape")
    cnt, tot = {}, {}
    for seg in idx.segments:
        sku, amount = seg.fields["sku"], seg.fields["amount"]
        reps = np.diff(sku.offsets.astype(np.int64))
        check(int(reps.max(initial=0)) <= 1, "sku is single-valued")
        doc = np.repeat(np.arange(seg.max_doc), reps)
        live = seg.alive_mask()[doc]
        ords = sku.values[live].astype(np.int64)
        c = np.bincount(ords, minlength=len(sku.terms))
        s = np.zeros(len(sku.terms), np.int64)
        np.add.at(s, ords, amount.values[doc[live]].astype(np.int64))
        for i in np.nonzero(c)[0].tolist():
            k = sku.terms[i]
            cnt[k] = cnt.get(k, 0) + int(c[i])
            tot[k] = tot.get(k, 0) + int(s[i])
    order = sorted(cnt, key=lambda k: (-tot[k], k))
    return {"t": {"buckets": [{"key": k, "doc_count": cnt[k],
                               "s": {"value": tot[k]}, "n": {"value": cnt[k]}}
                              for k in order[:t.size]],
                  "sum_other_doc_count": sum(cnt[k] for k in order[t.size:])}}


def _checked(reqs, n: int) -> list:
    """Indices of the first n distinct requests of a varied stream (the
    ones phase_main_path holds to the oracle)."""
    seen, out = [], []
    for i, r in enumerate(reqs):
        if r not in seen:
            seen.append(r)
            out.append(i)
            if len(out) == n:
                break
    return out


class _Pending:
    """An oracle answer computed in the background (OraclePool)."""

    def __init__(self, res):
        self._res = res

    def get(self):
        return self._res.get()


def _oracle_answer(path: str, query, aggs):
    """One oracle answer over the on-disk index at `path` (a worker of
    OraclePool, at the lowest CPU priority so that the host-bound phases
    of the main process keep their cores; its index is opened once per
    worker)."""
    import os
    sys.path.insert(0, str(REPO))
    import tantivy_aggregations_tpu_torch as tt
    cache = globals().setdefault("_ORACLES", {})
    if not cache:
        os.nice(19)
    if path not in cache:
        cache[path] = tt.Index.open(path).oracle_searcher()
    return cache[path].agg_search(query, aggs)


class OraclePool:
    """The oracle's answers for the select and catalog paths, computed by
    worker processes (the oracle is host Python, seconds to a minute a
    request at 10M docs) while the card runs the earlier phases. Closed,
    and its workers joined, by `close`."""

    def __init__(self, workers: int):
        import multiprocessing
        self._pool = multiprocessing.get_context("spawn").Pool(workers)

    def submit(self, path, query, aggs) -> _Pending:
        return _Pending(self._pool.apply_async(_oracle_answer,
                                               (str(path), query, aggs)))

    def close(self) -> None:
        self._pool.close()
        self._pool.join()

    def terminate(self) -> None:
        self._pool.terminate()
        self._pool.join()


def prefetch_answers(tt, pool, paths, answers) -> int:
    """Queue the oracle answers phase_main_path will ask for on the
    select and catalog paths: each request's base query and the first
    MULTI_CHECKED distinct requests of its varied stream. The slowest
    (top_hits over most docs) go first. Returns the count queued."""
    varied = multi_varied(tt)
    jobs = []
    for label, dep, names, _, _, _ in MULTI_PATHS:
        if label not in ("select", "catalog"):
            continue
        for name in names:
            q, aggs = multi_requests(tt, name, 0)
            reqs = varied(name, aggs, 256)
            for i in [None] + _checked(reqs, MULTI_CHECKED):
                rq, ra = (q, aggs) if i is None else reqs[i]
                key = (name, repr(rq), repr(ra))
                if key not in answers:
                    answers[key] = None
                    jobs.append((name not in ("h1", "h2", "th", "f4", "tp"),
                                 key, paths[dep], rq, ra))
    for _, key, path, rq, ra in sorted(jobs, key=lambda j: j[0]):
        answers[key] = pool.submit(path, rq, ra)
    return len(jobs)


def _profile_group(torch, searcher, reqs, top: int = 6) -> None:
    """One msearch group under torch.profiler: its wall ms (host clock,
    profiled), the device ms (the summed kernel, fill and copy intervals)
    and busy share, the device ops that took the most and the port's own
    kernels; then, unprofiled, the group's submit (host dispatch and the
    device work, synchronized) and collect (the fruit copy and the host
    harvest) ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        searcher.agg_search_batch(reqs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    port = [(nm, ms) for nm, ms in ranked
            if any(k in nm for k in ("chain_", "gather_rows", "fused_"))]
    e0, e1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    e0.record()
    groups = searcher._submit_batch(reqs)
    e1.record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for g in groups:
        searcher._collect_group(g)
    t2 = time.perf_counter()
    say(f"    profiled group of {len(reqs)} (dedup off): wall {wall:.3f} ms, "
        f"device {busy:.3f} ms ({busy / wall:.1%} busy); top: "
        + "; ".join(f"{nm[:48]} {ms:.3f}" for nm, ms in ranked[:top])
        + "; port kernels: " + ("; ".join(f"{nm[:60]} {ms:.3f}"
                                          for nm, ms in port) or "none")
        + f"; unprofiled: submit + device {(t1 - t0) * 1e3:.3f} ms "
        f"(CUDA events around the submit {e0.elapsed_time(e1):.3f} ms), "
        f"collect {(t2 - t1) * 1e3:.3f} ms")


def _counters(K, C, R) -> dict:
    return {**K.launches, **C.calls, **R.mm_calls}


def _reset_counters(K, C, R) -> None:
    K.reset_launches()
    C.reset_calls()
    R.reset_mm_calls()


def _set_counters(K, C, R, counts) -> None:
    """Put the launch and product counters back to `counts` (_counters)."""
    for d in (K.launches, C.calls, R.mm_calls):
        for k in d:
            d[k] = counts[k]


def phase_main_path(torch, K, C, R, tt, idx, searcher, oracle, flagship,
                    card, path, answers, reps=1, configs=None, varied=None,
                    profiled=None, n_checked=3, also=None, timings=None):
    """Drive one slice's main path with the launch counters (the kernels'
    and the products') set to 0; returns the counts it left. `answers`
    keeps the oracle's (and c6's reference's) answers by request, so a
    later path compares with the same answers without asking again;
    `reps`: msearch timing runs per dedup setting (the median is
    printed), but one for c6, whose host-bound dedup-off stream is one
    group of C6_STREAM where the others run 256 requests, and whose
    dedup-off time is its checked run's. `configs`
    ((key, name, query, aggs), ...) and `varied` (key, aggs, n ->
    requests) replace the flagship configs and streams, `profiled` the
    keys whose dedup-off group is profiled;
    `n_checked`: distinct varied requests held to the oracle per config;
    `also`: a second searcher whose agg_search must give the same fruits
    (the sharded path's unsharded one), and which gives the per-query
    answers that the batch is held to; `timings` ({(label, name): (p50,
    msearch dedup on, dedup off)}) collects the times printed."""
    label, cfg_nos, kernels, products, _ = path
    say(f"[5] main path {label}: agg_search / agg_search_batch vs the "
        "oracle (c6: its numpy reference)")
    _reset_counters(K, C, R)
    dedup_on = searcher.config
    dedup_off = dataclasses.replace(dedup_on, msearch_dedup=False)
    if profiled is None:
        profiled = PROFILED_DEFAULT if label == "default" else PROFILED
    for n, name, q, aggs in (configs or all_configs(flagship)):
        if n not in cfg_nos:
            continue
        t_cfg = time.time()

        def reference(rq, ra, n=n):
            key = (n, repr(rq), repr(ra))
            if key not in answers:
                answers[key] = (oracle.agg_search(rq, ra) if n != 6
                                else c6_reference(tt, idx, rq, ra))
            elif isinstance(answers[key], _Pending):
                answers[key] = answers[key].get()
            return answers[key]
        t0 = time.time()
        want = reference(q, aggs)
        t_oracle = time.time() - t0
        got = searcher.agg_search(q, aggs)
        check(got == want, f"{name}: agg_search != oracle")
        if also is not None:
            # the other searcher's launches are not this path's
            before = _counters(K, C, R)
            check(also.agg_search(q, aggs) == got,
                  f"{name}: agg_search != the other searcher's")
            _set_counters(K, C, R, before)
        # c6's stream is one group of C6_STREAM (its host-bound dedup-off
        # pass, on three paths)
        reqs = (varied or flagship.varied_requests)(n, aggs,
                                                    C6_STREAM if n == 6
                                                    else 256)
        prog = searcher._program_for(q, aggs)
        group = reqs[:searcher.config.max_batch]
        # a request is its params and its agg tree (f2 and f3 rotate the
        # facet path, one agg tree per path)
        distinct = len({(id(ra), prog.param_key(rq, ra))
                        for rq, ra in group})
        batch = searcher.agg_search_batch(reqs)
        check(len(batch) == len(reqs), f"{name}: batch length")
        # one agg_search per distinct param set (a program is a pure
        # function of its params, so repeats would recompute the same)
        keys = [(id(ra), prog.param_key(rq, ra)) for rq, ra in reqs]
        one = {}
        # with `also`, its per-query answers (a sharded c5 or c9 request
        # takes a third of a second on the host; the timed requests below
        # hold this searcher's own to them)
        single = searcher.agg_search if also is None else also.agg_search
        before = _counters(K, C, R)
        for k, (rq, ra) in zip(keys, reqs):
            if k not in one:
                one[k] = single(rq, ra)
        if also is not None:  # the other searcher's launches
            _set_counters(K, C, R, before)
        singles = [one[k] for k in keys]
        check(batch == singles, f"{name}: agg_search_batch != per-query")
        searcher.config = dedup_off
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = searcher.agg_search_batch(reqs)
        off_ms = (time.perf_counter() - t0) * 1e3 / len(reqs)
        check(off == singles,
              f"{name}: agg_search_batch (dedup off) != per-query")
        searcher.config = dedup_on
        seen = _checked(reqs, n_checked)
        for i in seen:
            rq, ra = reqs[i]
            check(batch[i] == (want if (rq, ra) == (q, aggs)
                               else reference(rq, ra)),
                  f"{name}: varied request {rq!r} != oracle")
        # timings (every agg_search ends in the device->host fruit copy)
        times = []
        for i, (rq, ra) in enumerate(reqs[:20]):
            t0 = time.perf_counter()
            got = searcher.agg_search(rq, ra)
            times.append((time.perf_counter() - t0) * 1e3)
            check(got == singles[i], f"{name}: agg_search of {rq!r} != "
                  "the per-query answer")
        n_reps = 1 if n == 6 else reps
        msq = statistics.median(_msearch_ms_per_q(torch, searcher, reqs)
                                for _ in range(n_reps))
        if n == 6:
            # c6's host-bound dedup-off pass is timed once: the checked
            # run above
            msq_all = off_ms
        else:
            searcher.config = dedup_off
            msq_all = statistics.median(
                _msearch_ms_per_q(torch, searcher, reqs)
                for _ in range(n_reps))
            searcher.config = dedup_on
        if timings is not None:
            timings[(label, name)] = (statistics.median(times), msq, msq_all)
        say(f"  {name}: == oracle ({len(seen)} distinct varied checked; "
            f"oracle {t_oracle:.1f}s)  p50 {statistics.median(times):.3f} ms  "
            f"msearch {msq:.4f} ms/q dedup on ({distinct} distinct of "
            f"{len(group)} per group), {msq_all:.4f} ms/q dedup off  "
            f"[{card}]  ({time.time() - t_cfg:.1f}s)")
        if n in profiled:
            searcher.config = dedup_off
            _profile_group(torch, searcher, group)
            searcher.config = dedup_on
            if any(p.get("kind") == "percentiles" and not p["int_percents"]
                   for _, p in plan_nodes(prog)):
                _profile_phase2(torch, searcher, group)
    counts = _counters(K, C, R)
    say(f"[6] kernel launches and product calls during the main path "
        f"{label}:", counts)
    for k in kernels + products:
        check(counts[k] > 0,
              f"{k} was never launched by the main path {label}")
    for k in NOT_LAUNCHED.get(label, ()):
        check(counts[k] == 0, f"{k} was launched by the main path {label}")
    return counts


def _bigs(raw) -> list:
    """A step's phase-1 state as a list of {path: state}: one for a
    Program, one per shard for a mesh (ShardedProgram.raw_fn)."""
    big = raw["big"]
    return big if isinstance(big, list) else [big]


def _raw_clone(torch, raw) -> dict:
    """A step's fruits copied out of whatever buffers hold them."""
    big = [{path: {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in st.items()}
            for path, st in b.items()} for b in _bigs(raw)]
    return {"packed": raw["packed"].clone(),
            "big": big if isinstance(raw["big"], list) else big[0]}


def _raw_same(torch, a, b, big=True) -> bool:
    """Two steps' fruits are equal: packed, and (`big`) every phase-1
    tensor (every shard's on a mesh)."""
    if not torch.equal(a["packed"], b["packed"]):
        return False
    if not big:
        return True
    ba, bb = _bigs(a), _bigs(b)
    return len(ba) == len(bb) and all(
        x.keys() == y.keys() and all(
            (torch.equal(v, y[path][k]) if torch.is_tensor(v)
             else v == y[path][k])
            for path, st in x.items() for k, v in st.items())
        for x, y in zip(ba, bb))


def _eager_raw(prog, rows):
    """raw_fn run eagerly on the param matrix of `rows` (extracted params):
    a Program over its arrays, a mesh over every shard's."""
    from tantivy_aggregations_tpu_torch.query import compile as qc
    progs = getattr(prog, "progs", None)
    p0 = progs[0] if progs else prog
    arrays = [pg._arrays for pg in progs] if progs else prog._arrays
    return prog.raw_fn(qc.param_matrix(rows, p0._pkeys, p0.device), arrays)


def _big_bytes(torch, raw) -> int:
    return sum(v.numel() * v.element_size() for b in _bigs(raw)
               for st in b.values() for v in st.values()
               if torch.is_tensor(v))


def graph_pool_bytes(torch):
    """Bytes the port's CUDA graph pools (aggs/compile.py: each device's
    _GraphBook, its current pool and those its graphs still hold) hold
    reserved, from the caching allocator's snapshot; None where the
    snapshot names no segment's pool."""
    from tantivy_aggregations_tpu_torch.aggs import compile as AC
    pools = {tuple(h) for b in AC._BOOKS.values()
             for h in (b.pool, *b.pools)}
    segs = torch.cuda.memory._snapshot()["segments"]
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) in pools)


def _diff(after, before) -> dict:
    return {k: after[k] - before[k] for k in after}


#: the launch counter of each chain_tile_kernel instance, by its first
#: template argument (csrc/kernels.cu ChainMode)
CHAIN_MODES = ("chain_blocks", "chain_counts", "chain_slot_counts")


def graph_kernel_nodes(K, graph, tmp):
    """(the port's kernels among a captured graph's nodes, by launch
    counter; the graph's node count): what each replay of it launches,
    as CUDA's own record of the graph gives it (CUDAGraph.debug_dump, a
    DOT file, of a graph captured with _StepGraph.keep_nodes). Fails
    where no file or no node was written."""
    import re
    dot = Path(tmp) / "graph.dot"
    dot.unlink(missing_ok=True)
    graph.debug_dump(str(dot))
    check(dot.exists(), "a captured graph kept no nodes (keep_nodes off?)")
    text = dot.read_text(errors="replace")
    nodes = re.split(r'(?m)^\s*"?graph_\d+_node_\d+"?\s*\[', text)[1:]
    check(nodes, f"no node in the graph's DOT file: {text[:400]!r}")
    counts = dict.fromkeys(K.launches, 0)
    for nd in nodes:
        m = re.search(r"chain_tile_kernel(?:ILi|<)(\d)", nd)
        if m:
            counts[CHAIN_MODES[int(m.group(1))]] += 1
        elif "fused_metrics_kernel" in nd:
            counts["fused_metrics"] += 1
        elif "gather_rows_kernel" in nd:
            counts["gather_rows"] += 1
        elif "dense_buckets_kernel" in nd:
            counts["dense_buckets"] += 1
        elif "dense_extremes_kernel" in nd:
            counts["dense_extremes"] += 1
    return counts, len(nodes)


def graph_memory(torch, dev) -> dict:
    """What the captured steps of `dev` hold (aggs/compile.py _GraphBook):
    graphs booked, their own buffers' bytes, the pool bytes booked for
    them, the pools' reserved bytes from the allocator's snapshot, the
    budget and the graphs dropped for it."""
    from tantivy_aggregations_tpu_torch.aggs import compile as AC
    book = AC._BOOKS[dev.index if dev.index is not None
                     else torch.cuda.current_device()]
    own = sum(e[3] for e in book.graphs.values())
    return {"graphs": len(book.graphs), "own_bytes": own,
            "pool_bytes_booked": book.total() - own,
            "pool_bytes_reserved": graph_pool_bytes(torch),
            "budget": book.budget, "dropped": book.dropped}


def graph_programs(tt, flagship, searchers):
    """(path label, config key, name, searcher, query, aggs, up to
    GRAPH_GROUP varied requests of that agg tree) of every unsharded
    main path's requests (PATHS and MULTI_PATHS)."""
    varied = multi_varied(tt)
    out = []
    for label, cfg_nos, *_ in PATHS:
        s = searchers[label if label in searchers else "row"]
        for n, name, q, aggs in all_configs(flagship):
            if n in cfg_nos:
                out.append((label, n, name, s, q, aggs,
                            flagship.varied_requests(n, aggs, GRAPH_GROUP)))
    for label, dep, names, *_ in MULTI_PATHS:
        s = searchers["default" if dep == "bench" else "tags"]
        for nm in names:
            q, aggs = multi_requests(tt, nm, 0)
            reqs = [r for r in varied(nm, aggs, GRAPH_GROUP) if r[1] is aggs]
            out.append((label, nm, nm, s, q, aggs, reqs))
    return out


def phase_graphs(torch, K, C, R, qc, tt, flagship, searchers, answers,
                 card) -> dict:
    """Phase 5g: the compiled step. Every unsharded path's programs plan
    their step captured (plan["graph"]); each is replayed at B = 1, an
    odd group of 3 padded to 4, and a full group (GRAPH_SIZES, within the
    group's cap), and its replay's packed and big fruits == raw_fn's on
    the same padded param matrix, the launch and product counts a replay
    credits == the eager step's, and its fruits == the oracle where the
    main paths asked it (c6 at B = 1 only: its host selection takes a
    quarter of a second a query); then every graph is replayed again in
    a shuffled order (graphs of different programs and sizes share one
    memory pool) and held == again. The credited launches are held to the
    kernel nodes CUDA's own record of each graph holds
    (graph_kernel_nodes). Then the memory the graphs hold (graph_memory),
    and the bound on it: a budget below the book's total drops the three
    least recently used graphs, and their programs capture them again at
    their next use, == raw_fn. Returns {"credited": the launch and product
    counts the replays credited, "nodes": the kernel nodes of the graphs
    replayed, "memory": graph_memory after the replays}."""
    import tempfile
    from tantivy_aggregations_tpu_torch.aggs import compile as AC
    say("[5g] the compiled step: each program's CUDA graph == its raw_fn, "
        "at B = 1, 3 -> 4 and a full group, in capture and shuffled order")
    t0 = time.time()
    dev = torch.device(DEVICE)
    credited = dict.fromkeys(_counters(K, C, R), 0)
    nodes = dict.fromkeys(K.launches, 0)
    tmp = tempfile.TemporaryDirectory()
    kept, n_new = [], 0
    for label, key, name, s, q, aggs, reqs in graph_programs(
            tt, flagship, searchers):
        prog = s._program_for(q, aggs)
        check(isinstance(prog, AC.Program) and prog.plan["graph"] is True,
              f"{label} {name}: no captured step ({type(prog).__name__})")
        cap = s._group_cap(prog)
        sizes = []
        for b, pad in GRAPH_SIZES:
            b, pad = min(b, cap, len(reqs)), min(pad, cap)
            pad = max(b, pad)
            group = [(q, aggs)] if b == 1 else reqs[:b]
            qs = [rq for rq, _ in group]
            rows = [prog._extract(rq, aggs) for rq in qs]
            rows += rows[-1:] * (pad - len(rows))
            c0 = _counters(K, C, R)
            eager = _raw_clone(torch, _eager_raw(prog, rows))
            d_eager = _diff(_counters(K, C, R), c0)
            if pad not in prog._graphs:  # captured at first use
                n_new += 1
                prog.submit_many(qs, aggs, pad_to=pad)
            c0 = _counters(K, C, R)
            got = _raw_clone(torch, prog.submit_many(qs, aggs, pad_to=pad))
            d_graph = _diff(_counters(K, C, R), c0)
            check(_raw_same(torch, got, eager),
                  f"{label} {name} B={b} (padded {pad}): the graph's fruits "
                  "!= raw_fn's")
            check(d_graph == d_eager,
                  f"{label} {name} B={pad}: a replay credited {d_graph}, "
                  f"the eager step launched {d_eager}")
            in_graph, _ = graph_kernel_nodes(K, prog._graphs[pad].graph,
                                             tmp.name)
            check(in_graph == {k: d_graph[k] for k in K.launches},
                  f"{label} {name} B={pad}: the graph holds the kernel "
                  f"nodes {in_graph}, a replay credited {d_graph}")
            for k, v in d_graph.items():
                credited[k] += v
            for k, v in in_graph.items():
                nodes[k] += v
            if key != 6 or b == 1:
                fruits = prog.finalize_many(got, aggs, len(qs))
                for (rq, ra), fr in zip(group, fruits):
                    ak = (key, repr(rq), repr(ra))
                    if ak in answers:
                        check(fr == _answer(answers, ak),
                              f"{label} {name} B={b}: graph fruits != the "
                              "oracle")
            keep_big = _big_bytes(torch, eager) <= GRAPH_KEEP_BIG
            kept.append((f"{label} {name} B={pad}", prog, qs, aggs, pad,
                         eager if keep_big else
                         {"packed": eager["packed"], "big": {}}, keep_big))
            sizes.append(pad)
        say(f"  {label} {name}: graphs at B = {sizes} == raw_fn; replays "
            f"credit the eager launches")
        del eager, got
    tmp.cleanup()
    for i in np.random.default_rng(SEED).permutation(len(kept)):
        what, prog, qs, aggs, pad, eager, keep_big = kept[i]
        got = prog.submit_many(qs, aggs, pad_to=pad)
        check(_raw_same(torch, got, eager, keep_big),
              f"{what}: replayed in shuffled order != raw_fn")
    for k in K.launches:
        check(credited[k] > 0 and nodes[k] > 0,
              f"no replayed graph launched {k}")
    mem = graph_memory(torch, dev)
    say(f"[5g] {len(kept)} graphs (of {len({id(k[1]) for k in kept})} "
        f"programs; {n_new} captured here) == raw_fn in capture order and "
        f"shuffled; launches credited by the replays {credited}, kernel "
        f"nodes in the replayed graphs {nodes}; memory {mem}  [{card}]")
    # the bound: three of the graphs above made the least recently used,
    # then a budget that their own bytes exceed
    book = AC._BOOKS[dev.index if dev.index is not None
                     else torch.cuda.current_device()]
    again = list({(id(k[1]), k[4]): k for k in kept}.values())[:3]
    chosen = {(id(k[1]), k[4]) for k in again}
    for n in [n for n, e in book.graphs.items()
              if (id(e[0]()), e[1]) not in chosen]:
        book.touch(book.graphs[n][2]())
    budget, dropped = book.budget, book.dropped
    book.budget = book.total() - sum(e[3] for e in list(
        book.graphs.values())[:3]) + 1
    book.trim()
    check(book.dropped > dropped and book.total() <= book.budget
          and all(k[4] not in k[1]._graphs for k in again),
          f"a budget below the book's total dropped "
          f"{book.dropped - dropped} graphs, leaving {book.total()} bytes "
          f"of {book.budget}")
    book.budget = budget
    for what, prog, qs, aggs, pad, eager, keep_big in again:
        got = prog.submit_many(qs, aggs, pad_to=pad)
        check(_raw_same(torch, got, eager, keep_big),
              f"{what}: captured again after a drop != raw_fn")
    say(f"[5g] the 3 least recently used graphs dropped for a budget below "
        f"the total, captured again at their next use == raw_fn: "
        + "; ".join(k[0] for k in again) + f"  ({time.time() - t0:.1f}s)")
    return {"credited": credited, "nodes": nodes, "memory": mem}


def _step_once(torch, prog, qs, aggs, way, pad_to=None):
    """One request group through submit_many, stage and finalize: "graph"
    replays the graphs (the group padded to `pad_to`), "eager" runs
    raw_fn and phase 2's selection eagerly (unpadded; a Program's or a
    mesh's: its `_captures` made false for the call): ((dispatch, wait,
    harvest, total host ms, device ms between CUDA events recorded before
    the dispatch and after the staged copy), the fruits)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    if way == "eager":
        prog._captures = lambda: False
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        raw = prog.submit_many(qs, aggs,
                               pad_to=pad_to if way == "graph" else None)
        t1 = time.perf_counter()
        staged = prog.stage(raw, aggs)
        e1.record()
        staged.numpy()
        t2 = time.perf_counter()
        fruits = prog.finalize_many(raw, aggs, len(qs), staged=staged)
        t3 = time.perf_counter()
    finally:
        if way == "eager":
            del prog._captures
    return ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
            (t3 - t0) * 1e3, e0.elapsed_time(e1)), fruits


def phase_step_timings(torch, flagship, searchers, card) -> list:
    """Phase 5t: c1-c10 in the row modes and at the default config, at
    B = 1 and B = 128 (within the cap; c6 at B = 1 only), one group
    through its graph and eagerly (raw_fn, _step_once), in turns
    (STEP_REPS[B] each, medians): dispatch / wait / harvest / total host ms
    and the CUDA-event ms from the dispatch to the staged copy, the fruits
    of both ways ==; and the eager steps' peak of allocated bytes above
    what was allocated before each (per config set) beside the graph
    pool's reserved bytes. Then the cost of padding in a device-bound row
    mode: c2's group of PAD_ODD[0] padded to PAD_ODD[1] through its graph
    against raw_fn on the group unpadded. Returns {"steps": the records,
    "eager_peak_bytes", "pool_bytes"}."""
    say("[5t] the step through its graph vs raw_fn (medians of "
        f"{STEP_REPS[1]} at B = 1, {STEP_REPS[128]} at 128; dispatch / wait "
        "/ harvest / total host ms, device ms between events)")
    out = []
    peak = {}
    groups = [(label, n, q, aggs, B, None)
              for label in ("row", "default")
              for n, name, q, aggs in all_configs(flagship)
              for B in (1, 128) if n != 6 or B == 1]
    groups.append(("row", 2, *next((q, aggs) for n, _, q, aggs in
                                   all_configs(flagship) if n == 2),
                   *PAD_ODD))
    for label, n, q, aggs, B, pad in groups:
        s = searchers[label]
        prog = s._program_for(q, aggs)
        b = min(B, s._group_cap(prog))
        qs = ([q] if b == 1 else
              [rq for rq, _ in flagship.varied_requests(n, aggs, b)])
        prog.submit_many(qs, aggs, pad_to=pad)  # this B's graph, captured
        runs = {"graph": [], "eager": []}
        for _ in range(STEP_REPS[1 if B == 1 else 128]):
            for way in runs:
                if way == "eager":
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                runs[way].append(_step_once(torch, prog, qs, aggs, way,
                                            pad))
                if way == "eager":
                    peak[label] = max(peak.get(label, 0),
                                      torch.cuda.max_memory_allocated()
                                      - base)
        check(runs["graph"][-1][1] == runs["eager"][-1][1],
              f"{label} c{n} B={b}: the graph's fruits != raw_fn's")
        rec = {"path": label, "config": f"c{n}", "B": b}
        if pad is not None:
            rec["graph_padded_to"] = pad
        for way, rs in runs.items():
            med = [statistics.median(x) for x in zip(*(r[0] for r in rs))]
            rec[way] = dict(zip(("dispatch_ms", "wait_ms", "harvest_ms",
                                 "total_ms", "device_ms"), med))
        out.append(rec)
        g, e = rec["graph"], rec["eager"]
        say(f"  {label} c{n} B={b}"
            + (f" (graph padded to {pad})" if pad else "")
            + f": graph {g['dispatch_ms']:.3f} / "
            f"{g['wait_ms']:.3f} / {g['harvest_ms']:.3f} / "
            f"{g['total_ms']:.3f} ms, device {g['device_ms']:.3f}; "
            f"raw_fn {e['dispatch_ms']:.3f} / {e['wait_ms']:.3f} / "
            f"{e['harvest_ms']:.3f} / {e['total_ms']:.3f} ms, "
            f"device {e['device_ms']:.3f}  [{card}]")
    pool = graph_pool_bytes(torch)
    say(f"[5t] eager steps' peak allocated bytes, c1-c10 row modes "
        f"{peak['row']}, default {peak['default']}; graph pool reserved "
        "now: "
        + ("not measured" if pool is None else f"{pool} bytes")
        + f"  [{card}]")
    return {"steps": out, "eager_peak_bytes": peak, "pool_bytes": pool}


#: phase 2's graphs: the unsharded programs checked (deployment, name) and
#: their group sizes (B, padded B; the full group within the cap)
PHASE2_GRAPHS = (("bench", "p1"), ("bench", "p2"), ("bench", "p3"),
                 ("bench", "p4"), ("tags", "tp"))
PHASE2_SIZES = ((1, 1), (4, 4), (GRAPH_GROUP, GRAPH_GROUP))


def _phase2_eager(torch, prog, ranks, big, B) -> dict:
    """Phase 2's selection run eagerly (what the CPU and a mesh over
    several cards run): each node's select_raw over its state's first B
    rows, the ranks uploaded; on a mesh every shard's bisection, shard
    0's values."""
    from tantivy_aggregations_tpu_torch.aggs.compile import ShardedProgram
    out = {}
    for path, rk in ranks:
        r = torch.from_numpy(rk).to(prog.device)

        def cut(st):
            return {k: (v[:B] if torch.is_tensor(v) else v)
                    for k, v in st.items()}
        if isinstance(prog, ShardedProgram):
            out[path] = prog.mesh.run(
                lambda s: prog.progs[s].select_raw(
                    path, cut(big[s][path]), prog.progs[s]._arrays, r))[0]
        else:
            out[path] = prog.select_raw(path, cut(big[path]), prog._arrays,
                                        r)
    return out


def check_phase2_graphs(torch, label, prog, reqs, cap, answers, key) -> list:
    """Phase 2's graphs of one program (unsharded or a mesh): at each of
    PHASE2_SIZES within the cap, the group's step replayed, its host ranks,
    then each node's selection through its graph (_phase2_select, captured
    at its first use) == the eager selection (_phase2_eager) on the same
    state, and the fruits == the oracle where it was asked. Returns the
    (B, padded B, selection ms through the graph, eager ms) of each
    size."""
    q, aggs = reqs[0]
    p0 = getattr(prog, "progs", [prog])[0]
    out = []
    for b, pad in PHASE2_SIZES:
        b, pad = min(b, cap, len(reqs)), min(pad, cap)
        pad = max(b, pad)
        group = reqs[:b]
        raw = prog.submit_many([rq for rq, _ in group], aggs, pad_to=pad)
        staged = prog.stage(raw, aggs)
        hosts = [p0._unpack_host(v) for v in staged.numpy()[:b]]
        ranks = p0._phase2_ranks(hosts, _bigs(raw)[0])
        prog._phase2_select(ranks, raw["big"], b)  # captured at first use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = {k: v.clone() for k, v in
               prog._phase2_select(ranks, raw["big"], b).items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = _phase2_eager(torch, prog, ranks, raw["big"], b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) for k in got),
            f"{label} B={b} (padded {pad}): phase 2's graph selection != "
            "the eager selection")
        check(("phase2", ranks[0][0], pad) in prog._graphs,
              f"{label} B={b}: no phase-2 graph at {pad}")
        fruits = prog.finalize_many(raw, aggs, b, staged=staged)
        asked = 0
        for (rq, ra), fr in zip(group, fruits):
            ak = (key, repr(rq), repr(ra))
            if ak in answers:
                asked += 1
                check(fr == _answer(answers, ak),
                      f"{label} B={b}: phase-2 fruits != the oracle")
        out.append((b, pad, (t1 - t0) * 1e3, (t2 - t1) * 1e3))
        say(f"  {label} B={b} (padded {pad}): phase-2 graph == eager "
            f"({len(ranks)} node), selection {(t1 - t0) * 1e3:.3f} ms "
            f"graph vs {(t2 - t1) * 1e3:.3f} ms eager; {asked} fruits "
            "== the oracle")
    return out


def phase_phase2_graphs(torch, tt, searchers, answers, card) -> None:
    """Phase 5g2: phase 2's selection as graphs on the unsharded programs
    (PHASE2_GRAPHS): each at B = 1, 4 and a full group == the eager
    selection, fruits == the oracle (check_phase2_graphs)."""
    say("[5g2] phase 2's selection: each node's graph == the eager "
        "selection, at B = 1, 4 and a full group  [" + card + "]")
    varied = multi_varied(tt)
    for dep, name in PHASE2_GRAPHS:
        s = searchers["default" if dep == "bench" else "tags"]
        q, aggs = multi_requests(tt, name, 0)
        reqs = [(q, aggs)] + [r for r in varied(name, aggs, GRAPH_GROUP)
                              if r[1] is aggs][1:]
        prog = s._program_for(q, aggs)
        check_phase2_graphs(torch, name, prog, reqs, s._group_cap(prog),
                            answers, name)


def phase_phase2_rows(torch, tt, searchers, card):
    """Phase 5p: phase 2 against the integer path on the card. For p1's
    and p2's layouts in row modes (chain_counts, chain_slot_counts) and at
    the default config (pcube, scube; p2's terms in key order, so that it
    selects on the host as above a non-integer percentile and its fruits
    keep every slot), at B = 1 and 128: their integer
    percents' rank rows selected in the run, then the same program run
    again with its percentile nodes set to phase 2 and the ranks the host
    resolves for the same percents (exact.percentile_rank, _slot_ranks):
    the selected rows must be ==."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    say("[5p] phase 2 == the integer path's rank rows (exact ==)")
    pct = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
    for cfg in ("row", "default"):
        s = searchers[cfg]
        for name, aggs in (
                ("p1", {"p": tt.percentiles_agg("price", pct)}),
                # key order: the terms node ships all 4 slots in both
                # runs, as it does above a non-integer percentile
                ("p2", {"t": tt.terms_agg("status", 4, order=("_key", "asc"),
                                          sub_aggs={"p": tt.percentiles_agg(
                                              "price", (50.0, 99.0))})})):
            prog = Program(s._get_device_index(), *multi_requests(
                tt, name, 0)[:1], aggs, config=s.config)
            nodes = [p for _, p in plan_nodes(prog)
                     if p.get("kind") == "percentiles"]
            for B in (1, 128):
                qs = [multi_requests(tt, name, j % 32)[0] for j in range(B)]
                raw = prog.submit_many(qs, aggs)
                vecs = prog.stage(raw, aggs).numpy()
                want = [prog._unpack_host(vecs[b]) for b in range(B)]
                # the changed plan is another step: its graphs are
                # captured anew (and again after it is restored)
                prog._graphs.clear()
                for p in nodes:
                    p["int_percents"] = False
                try:
                    raw = prog.submit_many(qs, aggs)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    staged = prog.stage(raw, aggs)
                    hosts = [prog._unpack_host(v) for v in staged.numpy()]
                    prog._phase2(hosts, staged.big)
                    ms = (time.perf_counter() - t0) * 1e3
                finally:
                    for p in nodes:
                        p["int_percents"] = True
                    prog._graphs.clear()
                for p in nodes:
                    for b in range(B):
                        got = prog._node_at(hosts[b], p["path"])["pvals"]
                        rows = prog._node_at(want[b], p["path"])["rows"]
                        check(np.array_equal(got, rows),
                              f"{name} ({cfg}, B={B}): phase-2 rows != the "
                              "integer path's")
                modes = sorted(set().union(*multi_plan_modes(prog).values()))
                say(f"  {name} {cfg} ({', '.join(modes)}) B={B}: rows == "
                    f"({len(nodes)} node, phase 2 with its copies "
                    f"{ms:.3f} ms)  [{card}]")


def _stream_requests(tt, dep):
    """Phase 5s's mixed stream on one deployment: runs of c1, c4, p1, h2
    (varied parameters) and, once, the huge top_hits shape on the bench
    index; runs of f1 and tp on the tags deployment."""
    from tantivy_aggregations_tpu_torch.models import flagship
    if dep == "bench":
        cfg = {n: (q, a) for n, _, q, a in all_configs(flagship)}
        runs = [([cfg[1]] * 16, None), ([cfg[4]] * 16, None),
                (None, "p1"), (None, "h2")]
    else:
        runs = [(None, "f1"), (None, "tp")]
    reqs = []
    for cyc in range(STREAM_CYCLES if dep == "bench" else 2):
        for fixed, name in runs:
            if fixed is not None:
                reqs += fixed
                continue
            q0, aggs = multi_requests(tt, name, 0)
            reqs += [(multi_requests(tt, name, (cyc * 32 + j) % 32)[0], aggs)
                     for j in range(32)]
        if dep == "bench" and cyc == 1:
            reqs += [multi_requests(tt, "huge_top_hits", 0)] * 2
    return reqs


def phase_stream(torch, tt, searchers, card):
    """Phase 5s: agg_search_stream over a mixed stream of about 512
    requests (c1, c4, p1, h2 and a host-path shape on the bench index; f1
    and tp on the tags deployment) == agg_search_batch over it, in request
    order, at lookahead 1 and 2; ms/q of both, and the device's busy share
    over one lookahead-2 pass under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    say("[5s] agg_search_stream == agg_search_batch (mixed streams)")
    for dep, s in (("bench", searchers["default"]),
                   ("tags", searchers["tags"])):
        reqs = _stream_requests(tt, dep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = s.agg_search_batch(reqs)
        batch_ms = (time.perf_counter() - t0) * 1e3 / len(reqs)
        line = []
        for la in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = list(s.agg_search_stream(iter(reqs), lookahead=la))
            ms = (time.perf_counter() - t0) * 1e3 / len(reqs)
            check(got == batch, f"{dep}: stream (lookahead {la}) != batch")
            line.append(f"lookahead {la} {ms:.4f} ms/q")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            list(s.agg_search_stream(iter(reqs), lookahead=2))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        say(f"  {dep}: {len(reqs)} requests, stream == batch; batch "
            f"{batch_ms:.4f} ms/q, stream " + ", ".join(line)
            + f"; profiled lookahead-2 pass: wall {wall:.1f} ms, device "
            f"{busy:.1f} ms ({busy / wall:.1%} busy, {1 - busy / wall:.1%} "
            f"idle)  [{card}]")


def _profile_phase2(torch, searcher, reqs) -> None:
    """Phase 2 of one dedup-off group under torch.profiler: its wall ms
    (host ranks, the device selection, the second copy), the device ms
    and the device->host copy's ms."""
    from torch.profiler import ProfilerActivity, profile
    q0, aggs = reqs[0]
    prog = searcher._program_for(q0, aggs)
    # the group the searcher would run: within the program's cap (tp's
    # 26; its phase-1 state, 75 MB a query, lives in the graph's pool, its
    # output buffer and the replay's clone)
    reqs = reqs[:searcher._group_cap(prog)]
    raw = prog.submit_many([q for q, _ in reqs], aggs)
    staged = prog.stage(raw, aggs)
    hosts = [prog._unpack_host(v) for v in staged.numpy()]
    # the selection's graphs at this B, captured before the profile
    prog._phase2(hosts, staged.big)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog._phase2(hosts, staged.big)
        wall = (time.perf_counter() - t0) * 1e3
    dev = copy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            dev += ms
            if "DtoH" in e.name or "Device -> Host" in e.name:
                copy += ms
    say(f"    phase 2 of the group of {len(reqs)} ({len(staged.big)} "
        f"node): wall {wall:.3f} ms, device {dev:.3f} ms, of it the "
        f"device->host copy {copy:.3f} ms")


def phase_doc_space(torch, tt):
    """Phase 5d: the doc-space shapes on the card, on an index made from
    SEED (3000 docs, 3 segments): a text field and multi-valued keyword
    and u64 fields, some docs holding 9-12 values (overflow tails past
    DENSE_MULTI_K) and 9-13 tokens. Term and range leaves whose values
    lie only in the tails, a phrase over the CSR token stream, Exists, rank
    percentiles and prefix terms through the gathered doc mask
    (`mask_gather`), and a multi-valued terms agg under a multi-valued one
    (the cross-product expansion `xpand`): each a device Program whose
    chain evaluates with torch ops over the doc axis, == the oracle."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    from tantivy_aggregations_tpu_torch.schema import Cardinality
    say("[5d] doc-space shapes on the card (tails, CSR phrase, xpand)")
    schema = (tt.SchemaBuilder().add_keyword_field("cat")
              .add_u64_field("qty").add_f64_field("price")
              .add_keyword_field("tags", cardinality=Cardinality.MULTI)
              .add_u64_field("counts", cardinality=Cardinality.MULTI)
              .add_text_field("body").build())
    idx = tt.Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in range(12)]
    for i in range(3000):
        big = rng.random() < 0.05
        k = (lambda: int(rng.integers(9, 13))) if big else \
            (lambda: int(rng.integers(0, 4)))
        w.add_document({
            "cat": f"c{int(rng.integers(0, 6))}",
            "qty": int(rng.integers(0, 200)),
            "price": float(np.round(rng.normal() * 50, 2)),
            "tags": [f"t{int(x)}" for x in rng.integers(0, 16, k())],
            # values 60-99 only past the 8th position of a doc: the tail
            "counts": [int(x) if j < 8 else 60 + int(x) % 40
                       for j, x in enumerate(rng.integers(0, 60, k()))],
            "body": " ".join(words[int(x)] for x in rng.integers(
                0, 12, int(rng.integers(9, 14) if big
                           else rng.integers(0, 7))))})
        if i in (1000, 2000):
            w.commit()
    w.commit()
    pct = (25.0, 50.0, 75.0)
    reqs = [
        (tt.TermQuery("counts", 77), {"n": tt.count_agg(),
                                      "s": tt.sum_agg("qty")}, ()),
        (tt.RangeQuery("counts", lower=62, upper=90),
         {"n": tt.count_agg(), "p": tt.percentiles_agg("price")},
         ("mask_gather",)),
        (tt.PhraseQuery("body", "w3 w4"),
         {"n": tt.count_agg(), "p": tt.percentiles_agg("qty", pct),
          "t": tt.terms_agg("cat", size=3, sub_aggs={
              "s": tt.sum_agg("qty")})}, ("mask_gather",)),
        (tt.BooleanQuery(must=[tt.ExistsQuery("counts")],
                         must_not=[tt.TermQuery("tags", "t3")]),
         {"n": tt.count_agg(), "h": tt.histogram_agg("counts", interval=10)},
         ()),
        (tt.RangeQuery("qty", lower=10, upper=150),
         {"t": tt.terms_agg("tags", size=5, sub_aggs={
             "t2": tt.terms_agg("counts", size=3, sub_aggs={
                 "s": tt.sum_agg("qty")})})}, ("xpand",)),
    ]
    oracle = idx.oracle_searcher()
    for config in (EngineConfig(dense_nb=4), EngineConfig()):
        s = idx.searcher(device="cuda", config=config)
        for q, aggs, need in reqs:
            prog = s._program_for(q, aggs)
            check(type(prog) is Program,
                  f"{q!r} planned {type(prog).__name__} "
                  f"({getattr(prog, 'reason', '')})")
            modes = set().union(*multi_plan_modes(prog).values()) \
                if multi_plan_modes(prog) else set()
            check(set(need) <= modes, f"{q!r} plans {modes}")
            got = s.agg_search(q, aggs)
            check(got == oracle.agg_search(q, aggs), f"{q!r} != oracle")
            batch = s.agg_search_batch([(q, aggs)] * 3)
            check(batch == [got] * 3, f"{q!r}: batch != single")
            say(f"  {type(q).__name__} dense_nb={config.dense_nb}: == "
                f"oracle, modes {sorted(modes)}")


def plan_modes(prog) -> dict:
    """{plan path: the cube / pcube / scube / dense_mm modes it carries}
    of a Program's plan (paths without one left out)."""
    out = {}
    for path, p in plan_nodes(prog):
        got = [m for m in ("cube", "pcube", "scube", "dense_mm") if p.get(m)]
        if got:
            out["/".join(path[1:])] = got
    return out


def phase_plan(torch, searcher, flagship, label="row modes", modes=None):
    """Plan every config (layouts, planes and operands ship here), each a
    device Program: the exact host fallback must never stand in for the
    device path. c7 is planned after c4 and c9 after c5, so their plan
    seconds are the build of what they add: c7's member operand (on c4's
    sku layout) and c9's slot plane (on c5's price layout, under the same
    chain planes). With `modes` ({config: set of modes}), each plan's
    cube / pcube / scube / dense_mm modes are printed and must be those."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    say(f"[3b] planning c1-c10 ({label})")
    for n, name, q, aggs in all_configs(flagship):
        t0 = time.time()
        prog = searcher._program_for(q, aggs)
        torch.cuda.synchronize()
        check(type(prog) is Program,
              f"{name} planned {type(prog).__name__}, not a device Program "
              f"({getattr(prog, 'reason', '')})")
        if modes is not None:
            dump = plan_modes(prog)
            got = set().union(*map(set, dump.values())) if dump else set()
            say(f"  {name}: modes {dump}")
            check(got == modes[n], f"{name} plans modes {sorted(got)}, not "
                                   f"{sorted(modes[n])}")
        extra = ""
        mo = prog.plan.get(("a", "t"), {}).get("member_op")
        if mo is not None:
            op = prog._arrays[mo["key"]]
            extra = (f"  (member operand built here: {tuple(op.shape)} "
                     f"int64, {op.numel() * op.element_size()} bytes)")
        pp = prog.plan.get(("a", "t", "p"), {})
        if pp.get("pmode") == "slot_rank":
            extra = (f"  (slot plane built here: {pp['slotk']} over "
                     f"{pp['layout'].n_rows} rows, ns {pp['nslots']}; "
                     f"batch_cap {prog.batch_cap})")
        say(f"  {name}: planned in {time.time() - t0:.2f}s{extra}")


def _merged_fruits(fruits) -> dict:
    """c10's fruits of disjoint queries merged into their union's: counts
    and sums added, histogram doc counts added per key (empty buckets
    dropped)."""
    hist = {}
    for f in fruits:
        for b in f["h"]["buckets"]:
            hist[b["key"]] = hist.get(b["key"], 0) + b["doc_count"]
    return {"n": sum(f["n"]["value"] for f in fruits),
            "s": sum(f["s"]["value"] for f in fruits),
            "h": {k: c for k, c in sorted(hist.items()) if c}}


def phase_set_overflow(tt, searcher, oracle, flagship, card):
    """Phase 5b on the 10M index, under c10's aggs: a RegexQuery over sku
    whose runs fit the 64 regex slots answers on the device Program, one
    whose runs exceed them (the even skus 100-398 between odd ones: 150
    runs) on the exact host path (a routing check: that path is the
    oracle), then the fitting one again; each == the oracle, and the
    Program stays cached. The overflowing answer is also held against the
    device Program's answers for its three fitting thirds (the even skus
    100-198, 200-298, 300-398: 50 runs each), merged (_merged_fruits)."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    from tantivy_aggregations_tpu_torch.query.compile import match_runs
    from tantivy_aggregations_tpu_torch.searcher import _HostFallback
    say("[5b] set-query run overflow: device and host paths vs the oracle")
    aggs = {c[0]: c for c in all_configs(flagship)}[10][3]
    fitting = tt.RegexQuery("sku", "sku00000[1-3].")
    over = tt.RegexQuery("sku", "sku0000[1-3][0-9][02468]")
    thirds = [tt.RegexQuery("sku", f"sku0000{d}[0-9][02468]")
              for d in "123"]
    dindex = searcher._get_device_index()
    runs = {q.pattern: len(match_runs(dindex, q))
            for q in (fitting, over, *thirds)}
    check(max(runs[q.pattern] for q in (fitting, *thirds)) <= 64
          < runs[over.pattern], f"regex runs {runs} do not straddle the 64 "
          "slots")
    progs, fruits = [], {}
    for q, host in ((fitting, False), (over, True), (fitting, False),
                    *((t, False) for t in thirds)):
        prog = searcher._program_for(q, aggs)
        check(isinstance(prog, _HostFallback) == host
              and (host or type(prog) is Program),
              f"{q!r} planned {type(prog).__name__}")
        progs.append(prog)
        t0 = time.perf_counter()
        got = fruits[q.pattern] = searcher.agg_search(q, aggs)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.time()
        want = oracle.agg_search(q, aggs)
        check(got == want, f"{q!r}: agg_search != oracle")
        say(f"  {q.pattern}: {runs[q.pattern]} runs, "
            f"{'host path' if host else 'device Program'}, == oracle "
            f"(oracle {time.time() - t0:.1f}s)  agg_search {ms:.3f} ms  "
            f"[{card}]")
    check(all(p is progs[0] for p in progs[2:]),
          "the overflow evicted the device Program")
    merged = _merged_fruits([fruits[t.pattern] for t in thirds])
    check(_merged_fruits([fruits[over.pattern]]) == merged,
          "the host path's overflowing regex != its thirds on the device")
    say(f"  {over.pattern} on the host path == its three thirds on the "
        f"device, merged (count {merged['n']}, {len(merged['h'])} buckets)")


# ---------------------------------------------------------------------------
# sharded meshes, replica groups and the prep cache (phases 7-11)
# ---------------------------------------------------------------------------

#: the shards of the "sharded" path's mesh: four cards where there are four,
#: else four shards on cuda:0
SHARDS = 4
#: the sharded path: c1-c10 at the default EngineConfig on the SHARDS-shard
#: mesh, and the kernels its shard bodies must launch (fused_metrics for
#: c1's root metrics, chain_blocks for c4 / c6 / c7's prefix terms,
#: chain_counts under c5's rank bisection, chain_slot_counts under c9's
#: slot bisection)
SHARDED_PATH = ("sharded", (1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
                ("fused_metrics", "chain_blocks", "chain_counts",
                 "chain_slot_counts"),
                ("cube_dots", "dense_bucket_counts_mm",
                 "dense_bucket_sum_mm"), {})
#: the modes of each sharded plan's bucket, percentile and top_hits nodes
#: (the multi_plan_modes vocabulary, plus bisect / slot_bisect): the JAX
#: package's sharded planner's (__graft_entry__.py
#: `_dryrun_multichip_inproc`: prefix terms, rank + bisect, slot_rank +
#: slot_bisect, in-slot top_hits; no member operand, so c7 plans prefix; no
#: pcube or scube), with the kernel the port runs in each shard body where
#: the JAX package turns Pallas off (pallas_*)
SHARDED_MODES = {
    1: {}, 2: {}, 3: {"h": {"dense", "dense_mm"}},
    4: {"t": {"prefix", "pallas_prefix"}},
    5: {"p": {"rank", "bisect", "pallas_counts"},
        "pf/h": {"dense", "cube"}, "t": {"dense", "cube"}},
    6: {"t": {"prefix", "pallas_prefix", "sel_host"}},
    7: {"t": {"prefix", "pallas_prefix"}},
    8: {"h": {"dense", "cube"}},
    9: {"t": {"dense", "cube"},
        "t/p": {"slot_rank", "slot_bisect", "pallas_slots"}},
    10: {"h": {"dense", "cube"}},
    "mv1": {"p": {"rank", "bisect", "pallas_counts"}},
    "p1": {"p": {"rank", "bisect", "pallas_counts", "phase2"}},
    "h2": {"t": {"dense", "dense_mm"}, "t/h": {"top_hits", "in_slot"}},
}
#: the cube / dense_mm modes of c1-c10's sharded plans (plan_modes): the
#: default path's DEFAULT_MODES without the pcube and scube
SHARDED_CUBE_MODES = {n: m - {"pcube", "scube"}
                      for n, m in DEFAULT_MODES.items()}
#: replica groups of the "replicas" path, and its mixed stream: per config,
#: a run of REPLICA_RUN varied requests (c6: 8)
REPLICAS, REPLICA_RUN = 2, 24


def sharded_plan_modes(prog) -> dict:
    out = multi_plan_modes(prog)
    for path, p in plan_nodes(prog):
        key = "/".join(path[1:])
        for k in ("bisect", "slot_bisect"):
            if p.get(k) and key in out:
                out[key].add(k)
    return out


def mesh_devices(torch, n: int):
    """(devices, what): n cards where there are n, else n shards on
    cuda:0 (n CPU shards where DEVICE is the CPU: a rehearsal)."""
    if DEVICE == "cpu":
        return ["cpu"] * n, f"{n} shards on the CPU"
    if torch.cuda.device_count() >= n:
        return ([f"cuda:{i}" for i in range(n)],
                f"{n} cards, one shard each")
    return (["cuda:0"] * n,
            f"{n} shards on cuda:0 (this machine has "
            f"{torch.cuda.device_count()} card(s))")


def _free(torch, *searchers) -> None:
    """Drop searchers' device indexes and return their memory."""
    import gc
    for s in searchers:
        for sub in getattr(s, "searchers", [s]):
            sub._device_index = None
            sub._programs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _answer(answers, key):
    a = answers[key]
    if isinstance(a, _Pending):
        a = answers[key] = a.get()
    return a


def phase_plan_sharded(torch, tt, searcher, flagship):
    """Phase 7: plan c1-c10 and mv1 / p1 / h2 on the mesh (timed: the
    per-shard layouts and cube operands are built here, or read from the
    prep cache, and the dense operands built), each a ShardedProgram with
    the SHARDED_MODES of its nodes and the SHARDED_CUBE_MODES."""
    from tantivy_aggregations_tpu_torch.aggs.compile import ShardedProgram
    reqs = [(n, name, q, a) for n, name, q, a in all_configs(flagship)]
    reqs += [(nm, nm, *multi_requests(tt, nm, 0))
             for nm in ("mv1", "p1", "h2")]
    t_all = time.time()
    for n, name, q, aggs in reqs:
        t0 = time.time()
        prog = searcher._program_for(q, aggs)
        torch.cuda.synchronize()
        check(type(prog) is ShardedProgram,
              f"{name} planned {type(prog).__name__}, not a ShardedProgram "
              f"({getattr(prog, 'reason', '')})")
        check(all(pg.device.type == torch.device(DEVICE).type
                  for pg in prog.progs),
              f"{name}: a shard body is not on a card")
        got = sharded_plan_modes(prog)
        check(got == SHARDED_MODES[n],
              f"{name} plans {got}, not {SHARDED_MODES[n]}")
        if isinstance(n, int):
            dump = plan_modes(prog)
            cm = set().union(*map(set, dump.values())) if dump else set()
            check(cm == SHARDED_CUBE_MODES[n],
                  f"{name} plans {sorted(cm)}, not "
                  f"{sorted(SHARDED_CUBE_MODES[n])}")
        say(f"  {name}: {got}, batch_cap {prog.batch_cap}, planned in "
            f"{time.time() - t0:.2f}s")
    return time.time() - t_all


def phase_sharded(torch, K, C, R, tt, idx, dflt, oracle, flagship, card,
                  answers, timings):
    """Phases 7-8: the bench index over a SHARDS-shard mesh at the default
    EngineConfig. Plans (phase_plan_sharded), then c1-c10 through
    phase_main_path with the counters set to 0 (on one card through the
    mesh's graphs): agg_search == the oracle (c6: c6_reference) and ==
    the unsharded searcher's, agg_search_batch over the varied stream ==
    the per-query answers with dedup on and off, p50 and msearch ms/q
    printed beside the default path's; then one request each of mv1, p1
    (non-integer percents through the sharded phase 2) and h2 (the
    in-slot top_hits merge) == the oracle; then phase 8t (graph vs eager
    raw_fn). Returns (the path's counts, the mesh searcher, 8t's
    records)."""
    devices, what = mesh_devices(torch, SHARDS)
    say(f"[7] sharded: the bench index over a {SHARDS}-shard mesh ({what})")
    from tantivy_aggregations_tpu_torch.utils import stats
    t0 = time.time()
    s = tt.Index.open(idx.path).searcher(mesh=tt.make_mesh(devices=devices))
    di = s._get_device_index()
    say(f"  mesh {[str(d) for d in di.devices]}, T {di.T} "
        f"({di.T // SHARDS} rows a shard)")
    stats.reset_prep()
    t_plan = phase_plan_sharded(torch, tt, s, flagship)
    say(f"  planned c1-c10, mv1, p1, h2 in {t_plan:.1f}s "
        f"(load {time.time() - t0 - t_plan:.1f}s; the mesh's cold plan, "
        f"prep cache: {_prep_io(stats.prep_cache)})")
    counts = phase_main_path(
        torch, K, C, R, tt, idx, s, oracle, flagship, card, SHARDED_PATH,
        answers, profiled=(5, 9), also=dflt, timings=timings)
    for n, name, _, _ in all_configs(flagship):
        p50, on, off = timings[("sharded", name)]
        d50, don, doff = timings[("default", name)]
        say(f"  {name}: sharded p50 {p50:.3f} ms vs {d50:.3f} unsharded; "
            f"msearch {on:.4f} / {off:.4f} ms/q (dedup on / off) vs "
            f"{don:.4f} / {doff:.4f}  [{card}]")
    for nm in ("mv1", "p1", "h2"):
        q, aggs = multi_requests(tt, nm, 0)
        t0 = time.perf_counter()
        got = s.agg_search(q, aggs)
        ms = (time.perf_counter() - t0) * 1e3
        check(got == _answer(answers, (nm, repr(q), repr(aggs))),
              f"{nm} (sharded) != oracle")
        say(f"  {nm}: sharded == oracle ({ms:.1f} ms, its first call: "
            "the capture)")
    return counts, s, phase_mesh_step_timings(torch, tt, flagship, s, card)


#: the sharded path's kernels and the config whose shard bodies launch
#: each: c1's root metrics, c4's prefix terms, the counts under c5's rank
#: bisection and c9's slot bisection
SHARD_KERNELS = (("fused_metrics", 1), ("chain_blocks", 4),
                 ("chain_counts", 5), ("chain_slot_counts", 9),
                 ("dense_buckets", 3))


def _capture(K, name, fn):
    """Run fn() with K.<name> recording the arguments of each launch
    (positional, fused_metrics' minmax among them); returns them."""
    calls, real = [], getattr(K, name)

    def rec(*a, **kw):
        calls.append(a + tuple(kw.values()))
        return real(*a, **kw)
    setattr(K, name, rec)
    try:
        fn()
    finally:
        setattr(K, name, real)
    return calls


def phase_shard_kernels(torch, K, qc, searcher, flagship, records):
    """Phase 8k: each kernel of the sharded path == its plain version on
    the operands its shard bodies give it on the SHARDS-shard mesh:
    SHARD_KERNELS' config run once at B = 1 and once on max_batch varied
    requests through the mesh's eager raw_fn (the step its graphs replay:
    phase 8g holds the two ==, launches and fruits), every launch's
    arguments captured (each shard's own: its shard-local layout, slot
    plane and padded tail) and checked; shard 0's time, plain time and
    bound kept as variants of the kernel's record. Runs after the sharded
    path's counts are read, so its launches count on no path."""
    say(f"[8k] the sharded path's kernels on the {SHARDS} shards' operands "
        "(exact ==)")
    cfgs = {n: (q, a) for n, _, q, a in all_configs(flagship)}
    B = searcher.config.max_batch
    for name, n in SHARD_KERNELS:
        q, aggs = cfgs[n]
        prog = searcher._program_for(q, aggs)
        p0 = prog.progs[0]
        rows = [p0._extract(rq, ra)
                for rq, ra in flagship.varied_requests(n, aggs, B)]
        calls = (_capture(K, name, lambda: _eager_raw(
            prog, [p0._extract(q, aggs)]))
            + _capture(K, name, lambda: _eager_raw(prog, rows)))
        by_b = {}
        for args in calls:
            by_b.setdefault(args[0].shape[0], []).append(args)
        check(all(len(by_b.get(b, ())) >= SHARDS for b in (1, B)),
              f"{name} on c{n}: launches "
              f"{ {b: len(v) for b, v in by_b.items()} } by B, not "
              f"{SHARDS} or more at B = 1 and {B}")
        rec = records[name]
        for b, launched in sorted(by_b.items()):
            for args in launched:
                err = _check_equal(torch, name, f"c{n} shard B={b}",
                                   getattr(K, name)(*args),
                                   getattr(K, name + "_plain")(*args))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if b not in (1, B):
                continue
            args = launched[0]
            kern = lambda a=args, f=getattr(K, name): f(*a)  # noqa: E731
            plain = lambda a=args, f=getattr(K, name + "_plain"): f(*a)  # noqa
            ms = _cuda_ms(torch, kern, 30 if b == 1 else 10)
            plain_ms = _cuda_ms(torch, plain, 3)
            bound_ms, bound_by = kernel_bound(torch, qc, name, args,
                                              _outputs(kern()))
            rows = (args[0] if name in ("fused_metrics", "dense_buckets")
                    else args[3]).shape[-1]
            say(f"  {name:17s} c{n} B={b:<4d} {len(launched)} launches == "
                f"plain; shard 0 ({rows} rows): kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
            rec.setdefault("variants", []).append(
                {"label": f"c{n} shard 0 of {SHARDS}", "B": b, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by})
        del calls, by_b
    torch.cuda.empty_cache()


def mesh_graph_programs(tt, flagship):
    """(key, name, query, aggs, up to GRAPH_GROUP varied requests) of every
    mesh program of phases 7-8: c1-c10, mv1, p1, h2."""
    varied = multi_varied(tt)
    out = [(n, name, q, aggs, flagship.varied_requests(n, aggs, GRAPH_GROUP))
           for n, name, q, aggs in all_configs(flagship)]
    for nm in ("mv1", "p1", "h2"):
        q, aggs = multi_requests(tt, nm, 0)
        out.append((nm, nm, q, aggs, [r for r in varied(nm, aggs,
                                                          GRAPH_GROUP)
                                      if r[1] is aggs]))
    return out


def phase_mesh_graphs(torch, K, C, R, tt, flagship, s4, dflt, answers,
                      card) -> dict:
    """Phase 8g: the mesh step as graphs (JAX's jitted shard_map). Every
    mesh program of phases 7-8 plans its step captured; each is replayed
    at B = 1, 3 -> 4 and a full group (GRAPH_SIZES within the cap), and
    the replay's packed and every shard's big == the eager raw_fn's on the
    same padded param matrix, the launches a replay credits == the eager
    step's (the S shard bodies') == the kernel nodes of the graph
    (graph_kernel_nodes), and the fruits == the oracle where the main
    path asked it (c6 at B = 1 only). Then every mesh graph again in a
    shuffled order, interleaved with the default path's unsharded graphs
    at B = 1, each == its raw_fn; then p1's phase-2 graphs on the mesh ==
    the eager bisection (check_phase2_graphs). Prints each graph's node
    count and its first call's seconds (an eager warm-up, the capture and
    one replay). Returns {"credited", "nodes" (kernel nodes by kernel),
    "graph_nodes" ({program B=pad: nodes}), "capture_s"}."""
    import tempfile
    from tantivy_aggregations_tpu_torch.aggs import compile as AC
    say(f"[8g] the mesh step as graphs: each mesh program's CUDA graph == "
        f"its raw_fn, at B = 1, 3 -> 4 and a full group  [{card}]")
    t_all = time.time()
    credited = dict.fromkeys(_counters(K, C, R), 0)
    nodes = dict.fromkeys(K.launches, 0)
    all_nodes, capture_s, kept = {}, {}, []
    tmp = tempfile.TemporaryDirectory()
    for key, name, q, aggs, reqs in mesh_graph_programs(tt, flagship):
        prog = s4._program_for(q, aggs)
        check(isinstance(prog, AC.ShardedProgram)
              and prog.plan["graph"] is True,
              f"{name}: no captured mesh step ({type(prog).__name__}, "
              f"{getattr(prog, 'plan', {}).get('graph_reason')})")
        cap = s4._group_cap(prog)
        p0 = prog.progs[0]
        for b, pad in GRAPH_SIZES:
            b, pad = min(b, cap, len(reqs)), min(pad, cap)
            pad = max(b, pad)
            group = [(q, aggs)] if b == 1 else reqs[:b]
            qs = [rq for rq, _ in group]
            rows = [p0._extract(rq, aggs) for rq in qs]
            rows += rows[-1:] * (pad - len(rows))
            c0 = _counters(K, C, R)
            eager = _raw_clone(torch, _eager_raw(prog, rows))
            d_eager = _diff(_counters(K, C, R), c0)
            what = f"{name} B={pad}"
            if pad not in prog._graphs:  # captured at first use
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.submit_many(qs, aggs, pad_to=pad)
                torch.cuda.synchronize()
                capture_s[what] = time.perf_counter() - t0
            c0 = _counters(K, C, R)
            got = _raw_clone(torch, prog.submit_many(qs, aggs, pad_to=pad))
            d_graph = _diff(_counters(K, C, R), c0)
            check(_raw_same(torch, got, eager),
                  f"{name} B={b} (padded {pad}): the mesh graph's fruits "
                  "!= raw_fn's")
            check(d_graph == d_eager,
                  f"{what}: a replay credited {d_graph}, the eager step "
                  f"launched {d_eager}")
            in_graph, n_nodes = graph_kernel_nodes(
                K, prog._graphs[pad].graph, tmp.name)
            check(in_graph == {k: d_graph[k] for k in K.launches},
                  f"{what}: the graph holds the kernel nodes {in_graph}, a "
                  f"replay credited {d_graph}")
            all_nodes[what] = n_nodes
            for k, v in d_graph.items():
                credited[k] += v
            for k, v in in_graph.items():
                nodes[k] += v
            if key != 6 or b == 1:
                fruits = prog.finalize_many(got, aggs, len(qs))
                for (rq, ra), fr in zip(group, fruits):
                    ak = (key, repr(rq), repr(ra))
                    if ak in answers:
                        check(fr == _answer(answers, ak),
                              f"{name} B={b}: mesh graph fruits != the "
                              "oracle")
            keep_big = _big_bytes(torch, eager) <= GRAPH_KEEP_BIG
            kept.append((f"mesh {what}", prog, qs, aggs, pad,
                         eager if keep_big else
                         {"packed": eager["packed"], "big": []}, keep_big))
            del eager, got
        firsts = [f"B={w.split('B=')[1]} {t:.3f}s"
                  for w, t in capture_s.items() if w.startswith(name + " ")]
        say(f"  {name}: mesh graphs == raw_fn; nodes "
            + ", ".join(f"B={w.split('B=')[1]} {n}"
                        for w, n in all_nodes.items()
                        if w.startswith(name + " "))
            + "; first call here (warm-up + capture + replay): "
            + (", ".join(firsts) or "none, all captured by phase 8"))
    tmp.cleanup()
    # the default path's unsharded graphs at B = 1, replayed among them
    for n, name, q, aggs in all_configs(flagship):
        prog = dflt._program_for(q, aggs)
        rows = [prog._extract(q, aggs)]
        kept.append((f"unsharded {name} B=1", prog, [q], aggs, 1,
                     _raw_clone(torch, _eager_raw(prog, rows)), True))
    for i in np.random.default_rng(SEED).permutation(len(kept)):
        what, prog, qs, aggs, pad, eager, keep_big = kept[i]
        got = prog.submit_many(qs, aggs, pad_to=pad)
        check(_raw_same(torch, got, eager, keep_big),
              f"{what}: replayed in shuffled order != raw_fn")
    for k in SHARDED_PATH[2]:
        check(credited[k] > 0 and nodes[k] > 0,
              f"no replayed mesh graph launched {k}")
    say(f"[8g] {len(all_nodes)} mesh graphs == raw_fn in capture order and "
        f"shuffled among {len(kept) - len(all_nodes)} unsharded ones; "
        f"launches credited {credited}, kernel nodes {nodes}, "
        f"{sum(all_nodes.values())} nodes in all (largest "
        f"{max(all_nodes.values())}); first calls "
        f"{sum(capture_s.values()):.1f}s; memory "
        f"{graph_memory(torch, torch.device(DEVICE))}  [{card}]")
    q, aggs = multi_requests(tt, "p1", 0)
    prog = s4._program_for(q, aggs)
    reqs = [r for r in multi_varied(tt)("p1", aggs, GRAPH_GROUP)
            if r[1] is aggs]
    check_phase2_graphs(torch, "p1 mesh", prog, reqs, s4._group_cap(prog),
                        answers, "p1")
    say(f"[8g] ({time.time() - t_all:.1f}s)")
    return {"credited": credited, "nodes": nodes, "graph_nodes": all_nodes,
            "capture_s": capture_s}


def phase_mesh_step_timings(torch, tt, flagship, s4, card) -> list:
    """Phase 8t: c1-c10, mv1 and p1 on the mesh through its graphs and
    eagerly (raw_fn on every shard thread, and p1's phase 2 eagerly), in
    turns, in the same run: p50 of a single query (B = 1,
    MESH_STEP_REPS[1] runs) and ms/q of a group of 128 (c6: B = 1 only;
    MESH_STEP_REPS[128] runs), host ms around submit, stage and finalize
    (_step_once); the fruits of both ways ==."""
    say("[8t] the mesh step through its graph vs eagerly (p50 of "
        f"{MESH_STEP_REPS[1]} at B = 1, ms/q medians of "
        f"{MESH_STEP_REPS[128]} at 128)")
    out = []
    for key, name, q, aggs, reqs in mesh_graph_programs(tt, flagship):
        if key == "h2":
            continue
        prog = s4._program_for(q, aggs)
        label = f"c{key}" if isinstance(key, int) else key
        rec = {"config": label}
        for B in ((1,) if key == 6 else (1, 128)):
            b = min(B, s4._group_cap(prog))
            qs = [q] if b == 1 else [rq for rq, _ in reqs[:b]]
            # every graph of this B captured first: the step's and, for p1,
            # phase 2's (the first finalize captures it)
            _step_once(torch, prog, qs, aggs, "graph")
            runs = {"graph": [], "eager": []}
            for _ in range(MESH_STEP_REPS[1 if B == 1 else 128]):
                for way in runs:
                    runs[way].append(_step_once(torch, prog, qs, aggs, way))
            check(runs["graph"][-1][1] == runs["eager"][-1][1],
                  f"mesh {label} B={b}: the graph's fruits != the eager "
                  "step's")
            for way, rs in runs.items():
                ms = statistics.median(r[0][3] for r in rs)
                rec[f"{way}_{'p50_ms' if b == 1 else 'ms_per_q'}"] = (
                    ms if b == 1 else ms / b)
        out.append(rec)
        say(f"  mesh {label}: p50 {rec['graph_p50_ms']:.3f} ms graph vs "
            f"{rec['eager_p50_ms']:.3f} eager"
            + (f"; group of 128 {rec['graph_ms_per_q']:.4f} ms/q graph vs "
               f"{rec['eager_ms_per_q']:.4f} eager" if key != 6 else "")
            + f"  [{card}]")
    return out


def phase_replicas(torch, K, C, R, tt, idx, dflt, flagship, card):
    """Phase 9: ReplicatedSearcher with REPLICAS groups (REPLICAS cards,
    or REPLICAS one-shard groups on cuda:0): a mixed stream of c1-c10
    (REPLICA_RUN varied requests a config, c6 8), its agg_search_batch and
    agg_search_stream == the single unsharded searcher's answers in
    request order, every replica submitting msearch groups in the timed
    batch and in the stream; ms/q beside the single searcher's. The
    counters are set to 0 first; returns the counts."""
    devices, what = mesh_devices(torch, REPLICAS)
    say(f"[9] replicas: ReplicatedSearcher({REPLICAS} groups: {what})")
    reqs = []
    for n, name, q, aggs in all_configs(flagship):
        reqs += flagship.varied_requests(n, aggs,
                                         8 if n == 6 else REPLICA_RUN)
    t0 = time.time()
    want = dflt.agg_search_batch(reqs)
    t_single = time.time() - t0
    t0 = time.time()
    rs = tt.ReplicatedSearcher(tt.Index.open(idx.path), replicas=REPLICAS,
                               devices=devices)
    # every replica plans the shapes of its chunks (layouts and operands
    # from the prep cache) in an untimed first pass
    check(rs.agg_search_batch(reqs) == want,
          "replicas: agg_search_batch != the single searcher")
    say(f"  loaded, planned and answered once in {time.time() - t0:.1f}s")
    # the msearch groups each replica submits in the timed batch and the
    # stream
    served = {"batch": [0] * REPLICAS, "stream": [0] * REPLICAS}
    part = ["batch"]

    def counting(r, submit):
        def run(chunk):
            groups = submit(chunk)
            served[part[0]][r] += len(groups)
            return groups
        return run
    for r, sub in enumerate(rs.searchers):
        sub._submit_batch = counting(r, sub._submit_batch)
    _reset_counters(K, C, R)
    t0 = time.time()
    got = rs.agg_search_batch(reqs)
    t_rep = time.time() - t0
    check(got == want, "replicas: agg_search_batch != the single searcher")
    part[0] = "stream"
    check(list(rs.agg_search_stream(iter(reqs), lookahead=2)) == want,
          "replicas: agg_search_stream != the single searcher")
    check(all(n > 0 for v in served.values() for n in v),
          f"a replica served no group: {served}")
    # each replica group is a one-card mesh: its programs replay graphs
    graphs = [len(p._graphs) for sub in rs.searchers
              for p in sub._programs.values() if hasattr(p, "_graphs")]
    check(DEVICE == "cpu" or (graphs and all(graphs)),
          f"a replica's program captured no graph: {graphs}")
    counts = _counters(K, C, R)
    t0 = time.time()
    dflt.agg_search_batch(reqs)
    t_single = min(t_single, time.time() - t0)
    say(f"  {len(reqs)} mixed requests == the single searcher's (batch and "
        f"stream), msearch groups per replica {served}; msearch "
        f"{t_rep * 1e3 / len(reqs):.4f} ms/q on {REPLICAS} replicas vs "
        f"{t_single * 1e3 / len(reqs):.4f} ms/q on one searcher, "
        f"{sum(graphs)} graphs in the replicas' {len(graphs)} programs "
        f"[{card}]" + ("" if torch.cuda.device_count() >= REPLICAS else
                       " (one card: the replicas share it, no gain "
                       "expected)"))
    say("[9] kernel launches and product calls during the replicas path:",
        counts)
    _free(torch, rs)
    return counts


def _prep_io(c) -> str:
    """The prep cache's counters (utils/stats.prep_cache), printed."""
    return (f"hits {c['hits']} misses {c['misses']}, read "
            f"{c['read_bytes'] / 2**20:.1f} MiB in {c['read_s']:.2f}s, "
            f"wrote {c['write_bytes'] / 2**20:.1f} MiB in "
            f"{c['write_s']:.2f}s")


def _plan_c1_c10(torch, searcher, flagship, oracle_of):
    """(seconds to plan c1-c10, fruits == the oracle's) on a fresh
    searcher."""
    t0 = time.time()
    for _, _, q, aggs in all_configs(flagship):
        searcher._program_for(q, aggs)
    torch.cuda.synchronize()
    t = time.time() - t0
    for n, name, q, aggs in all_configs(flagship):
        check(searcher.agg_search(q, aggs) == oracle_of(n, q, aggs),
              f"{name}: fruits after a prep-cache plan != oracle")
    return t


def phase_prep(torch, tt, idx, flagship, card, answers, mesh_devices_=None):
    """Phase 10 (cold / warm plans through the prep cache): with
    <index>/.prep_cache_torch emptied, c1-c10 planned at the default
    EngineConfig on a fresh searcher (cold: every artifact built and
    saved), then on another fresh searcher (a new DeviceIndex: warm, every
    artifact read; no miss); fruits == the oracle both times. With
    `mesh_devices_`, only the warm plan of that mesh (its cold plan was
    the sharded path's). Prints seconds, hits and misses."""
    import shutil
    from tantivy_aggregations_tpu_torch.utils import prep_cache as PC
    from tantivy_aggregations_tpu_torch.utils import stats

    def oracle_of(n, q, aggs):
        return _answer(answers, (n, repr(q), repr(aggs)))

    def fresh():
        ix = tt.Index.open(idx.path)
        if mesh_devices_ is None:
            return ix.searcher(device=DEVICE)
        return ix.searcher(mesh=tt.make_mesh(devices=mesh_devices_))

    label = ("unsharded" if mesh_devices_ is None
             else f"{len(mesh_devices_)}-shard mesh")
    out = {}
    if mesh_devices_ is None:
        shutil.rmtree(Path(idx.path) / PC.DIR_NAME, ignore_errors=True)
        stats.reset_prep()
        s = fresh()
        out["cold"] = _plan_c1_c10(torch, s, flagship, oracle_of)
        out["cold_counts"] = dict(stats.prep_cache)
        _free(torch, s)
    stats.reset_prep()
    s = fresh()
    out["warm"] = _plan_c1_c10(torch, s, flagship, oracle_of)
    out["warm_counts"] = dict(stats.prep_cache)
    check(out["warm_counts"]["misses"] == 0,
          f"prep ({label}): the warm plan missed "
          f"{out['warm_counts']['misses']} artifacts")
    check(out["warm_counts"]["hits"] > 0, f"prep ({label}): no hits")
    files = list((Path(idx.path) / PC.DIR_NAME).glob("*.npz"))
    say(f"[10] prep cache ({label}): " + (
        f"cold plan of c1-c10 {out['cold']:.2f}s "
        f"({_prep_io(out['cold_counts'])}), " if "cold" in out else "")
        + f"warm {out['warm']:.2f}s ({_prep_io(out['warm_counts'])}); "
        f"fruits == the oracle; {len(files)} files, "
        f"{sum(f.stat().st_size for f in files) / 2**20:.1f} MiB  [{card}]")
    _free(torch, s)
    return out


def phase_device_guard(torch, K, qc, tt, idx, flagship, oracle_of):
    """Phase 11: with two or more cards, a 2-shard mesh over cuda:0 and
    cuda:1 answers c1, c4, c5 and c9 == the oracle (shard 1's kernels
    launch on cuda:1 while cuda:0 is current), and chain_counts on cuda:1
    operands == its plain version; with one card it says why it skips."""
    if torch.cuda.device_count() < 2:
        say("[11] device guard: skipped — one card "
            f"(torch.cuda.device_count() == {torch.cuda.device_count()}); "
            "it needs a shard on cuda:1")
        return
    say("[11] device guard: a shard on cuda:1")
    torch.cuda.set_device(0)
    s = tt.Index.open(idx.path).searcher(
        mesh=tt.make_mesh(devices=["cuda:0", "cuda:1"]))
    for n, name, q, aggs in all_configs(flagship):
        if n in (1, 4, 5, 9):
            check(s.agg_search(q, aggs) == oracle_of(n, q, aggs),
                  f"{name} on cuda:0 + cuda:1 != oracle")
    prog = s._program_for(*[(q, a) for n, _, q, a in all_configs(flagship)
                            if n == 5][0])
    p1 = prog.progs[1]
    pp = p1.plan[("a", "p")]
    entry, prefix = pp["chainp"], pp["prefix"]
    pm = qc.param_matrix([p1._extract(q, a) for n, _, q, a
                          in all_configs(flagship) if n == 5],
                         p1._pkeys, "cuda:1")
    sub = p1._chain_pmat(entry, pm)
    planes = [p1._arrays[prefix + k] for k in entry["mp"].plane_keys]
    avalid = p1._arrays[prefix + "avalid"]
    check(torch.cuda.current_device() == 0, "cuda:0 is not current")
    got = K.chain_counts(sub, entry["ops"], planes, avalid)
    want = K.chain_counts_plain(sub, entry["ops"], planes, avalid)
    check(got.device == torch.device("cuda:1") and torch.equal(got, want),
          "chain_counts on cuda:1 != its plain version")
    say("  c1, c4, c5, c9 == oracle on cuda:0 + cuda:1; chain_counts on "
        "cuda:1 == plain with cuda:0 current")
    _free(torch, s)


def phase_plan_nomop(searcher, flagship) -> None:
    """Phase 3n: c7 at use_member_ops=False plans the chain_blocks kernel
    over the sku layout (`pallas_prefix`, the chain over weights'
    per-position planes), no member operand, and its chain fits the tile
    kernel (the planner checks K.chain_fits)."""
    t0 = time.time()
    q, aggs = next((q, a) for n, _, q, a in all_configs(flagship) if n == 7)
    prog = searcher._program_for(q, aggs)
    check(type(prog).__name__ == "Program",
          f"c7 without member operands planned {type(prog).__name__}")
    p = prog.plan[("a", "t")]
    check(p.get("pallas_prefix") and "member_op" not in p,
          f"c7 without member operands: plan {sorted(p)}")
    say(f"[3n] c7 at use_member_ops=False: prefix + chain_blocks over "
        f"{len(p['chainp']['mp'].plane_keys)} planes "
        f"({', '.join(p['chainp']['mp'].plane_keys)}), no member operand, "
        f"planned in {time.time() - t0:.1f}s")


def phase_quickstart() -> None:
    """Phase 5q: examples/quickstart_torch.py on the card, in a process of
    its own, to its oracle-parity line."""
    script = REPO / "examples" / "quickstart_torch.py"
    res = subprocess.run([sys.executable, str(script), "--device", "cuda"],
                         capture_output=True, text=True, timeout=600)
    for ln in res.stdout.splitlines():
        say("  quickstart:", ln)
    check(res.returncode == 0 and "oracle parity: OK" in res.stdout,
          f"examples/quickstart_torch.py exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    say("[5q] examples/quickstart_torch.py on cuda == the oracle")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="also time the AB_KERNELS, and the AB_CONFIGS end "
                         "to end, against the port package of the tree at "
                         "DIR, in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "tantivy_aggregations_tpu_torch").is_dir():
        print("chip_smoke: tantivy_aggregations_tpu_torch not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    from tantivy_aggregations_tpu_torch.models import flagship
    from tantivy_aggregations_tpu_torch.ops import cube as C
    from tantivy_aggregations_tpu_torch.ops import kernels as K
    from tantivy_aggregations_tpu_torch.ops import reductions as R
    from tantivy_aggregations_tpu_torch.query import compile as qc
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.time()
    phases = {}

    def lap(phase, t0):
        phases[phase] = time.time() - t0
        say(f"    [{phase}: {phases[phase]:.1f}s]")

    t0 = time.time()
    card = phase_versions(torch, K)
    lap("versions", t0)
    t0 = time.time()
    phase_build(K)
    lap("build", t0)
    t0 = time.time()
    idx = phase_index(tt, flagship)
    lap("index", t0)
    t0 = time.time()
    tags_idx = phase_tags_index(tt)
    lap("tags index", t0)
    # the select and catalog paths' oracle answers, computed meanwhile
    import os
    pool = OraclePool(max(1, min(4, (os.cpu_count() or 2) - 2)))
    try:
        return main_paths(torch, tt, EngineConfig, flagship, args, t_run,
                          lap, phases, card, idx, tags_idx, pool)
    finally:
        pool.terminate()


def main_paths(torch, tt, EngineConfig, flagship, args, t_run, lap, phases,
               card, idx, tags_idx, pool) -> int:
    """Phases 3 on (see the module docstring), on the built indexes, with
    the oracle's worker processes in `pool`."""
    from tantivy_aggregations_tpu_torch.ops import cube as C
    from tantivy_aggregations_tpu_torch.ops import kernels as K
    from tantivy_aggregations_tpu_torch.ops import reductions as R
    from tantivy_aggregations_tpu_torch.query import compile as qc
    from tantivy_aggregations_tpu_torch.aggs import compile as AC
    # every graph keeps its nodes, so phase 5g reads the kernels in each
    AC._StepGraph.keep_nodes = True
    answers = {}
    t0 = time.time()
    n = prefetch_answers(tt, pool, {"bench": idx.path, "tags": tags_idx.path},
                         answers)
    say(f"[3o] {n} oracle answers of the select and catalog paths queued "
        "on worker processes")
    lap("oracle queue", t0)
    t0 = time.time()
    searcher = idx.searcher(device="cuda", config=EngineConfig(**ROW_MODES))
    phase_plan(torch, searcher, flagship)
    lap("plan", t0)
    t0 = time.time()
    # the default EngineConfig's searcher, on the same device index (its
    # planes and layouts are shipped once)
    dflt = idx.searcher(device="cuda")
    dflt._device_index = searcher._get_device_index()
    dflt._device_epoch = searcher._device_epoch
    phase_plan(torch, dflt, flagship, "default EngineConfig", DEFAULT_MODES)
    lap("plan default", t0)
    t0 = time.time()
    nomop = idx.searcher(device="cuda", config=EngineConfig(**NOMOP))
    nomop._device_index = searcher._get_device_index()
    nomop._device_epoch = searcher._device_epoch
    phase_plan_nomop(nomop, flagship)
    lap("plan nomop", t0)
    searchers = {"row": searcher, "default": dflt, "nomop": nomop,
                 "tags": tags_idx.searcher(device="cuda")}
    t0 = time.time()
    phase_plan_multi(torch, {"bench": dflt, "tags": searchers["tags"]})
    lap("plan multi", t0)
    t0 = time.time()
    against = load_against(args.against) if args.against else None
    records = phase_kernels(torch, K, qc, tt, searcher, flagship, against,
                            nomop)
    lap("kernels", t0)
    t0 = time.time()
    phase_kernels_multi(torch, K, qc, tt, searchers, records)
    lap("kernels multi", t0)
    t0 = time.time()
    for name, err in phase_edges(torch, K, qc).items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    lap("edge cases", t0)
    t0 = time.time()
    products = phase_products(torch, K, C, R, qc, searcher, dflt, flagship,
                              records)
    lap("products", t0)
    t0 = time.time()
    phase_extremes(torch, K, R, records)
    lap("extremes", t0)
    oracle = idx.oracle_searcher()
    counts = dict.fromkeys(_counters(K, C, R), 0)
    by_path = {}
    timings = {}
    for path in PATHS:
        t0 = time.time()
        label = path[0]
        s = searchers[label if label in searchers else "row"]
        by_path[label] = phase_main_path(
            torch, K, C, R, tt, idx, s, oracle, flagship, card, path,
            answers, reps=3 if label in ("default", "nomop") else 1,
            timings=timings, profiled=(7,) if label == "nomop" else None)
        for k, n in by_path[label].items():
            counts[k] += n
        lap(f"main path {label}", t0)
    pool_bytes = graph_pool_bytes(torch)
    say("[5] graph pool after c1-c10 (row modes, default, nomop): "
        + ("not measured" if pool_bytes is None
           else f"{pool_bytes} bytes reserved")
        + f", {torch.cuda.memory_reserved()} bytes reserved in all  [{card}]")
    c7 = "c7_terms_prefix_multiquery"
    for label, how in (("default", "member operand, gather_rows"),
                       ("nomop", "chain_blocks")):
        p50, on, off = timings[(label, c7)]
        say(f"[5n] c7 {label} ({how}): p50 {p50:.3f} ms, msearch {on:.4f} "
            f"ms/q dedup on, {off:.4f} ms/q dedup off  [{card}]")
    oracles = {"bench": oracle, "tags": tags_idx.oracle_searcher()}
    for label, dep, names, kernels, prods, prof in MULTI_PATHS:
        t0 = time.time()
        cfgs = [(nm, nm, *multi_requests(tt, nm, 0)) for nm in names]
        by_path[label] = phase_main_path(
            torch, K, C, R, tt, idx if dep == "bench" else tags_idx,
            searchers["default" if dep == "bench" else "tags"],
            oracles[dep], flagship, card,
            (label, names, kernels, prods, {}), answers, configs=cfgs,
            varied=multi_varied(tt), profiled=prof, n_checked=MULTI_CHECKED)
        for k, n in by_path[label].items():
            counts[k] += n
        lap(f"main path {label}", t0)
    t0 = time.time()
    replayed = phase_graphs(torch, K, C, R, qc, tt, flagship, searchers,
                            answers, card)
    lap("graphs", t0)
    t0 = time.time()
    step = phase_step_timings(torch, flagship, searchers, card)
    step["graph_memory_5g"] = replayed["memory"]
    lap("step timings", t0)
    t0 = time.time()
    phase_phase2_graphs(torch, tt, searchers, answers, card)
    lap("phase 2 graphs", t0)
    pool.close()
    t0 = time.time()
    for name in ("mv4",) + HOST_SHAPES:
        q, aggs = multi_requests(tt, name, 0)
        check(dflt.agg_search(q, aggs) == oracle.agg_search(q, aggs),
              f"{name} (host path) != oracle")
        say(f"[5m] {name} on the host path == the oracle")
    lap("host shapes", t0)
    t0 = time.time()
    phase_phase2_rows(torch, tt, searchers, card)
    lap("phase 2 rows", t0)
    t0 = time.time()
    phase_stream(torch, tt, searchers, card)
    lap("stream", t0)
    t0 = time.time()
    phase_doc_space(torch, tt)
    lap("doc space", t0)
    t0 = time.time()
    phase_set_overflow(tt, searcher, oracle, flagship, card)
    lap("set-query overflow", t0)
    t0 = time.time()
    phase_quickstart()
    lap("quickstart", t0)
    _free(torch, searchers.pop("tags"))
    t0 = time.time()
    phase_prep(torch, tt, idx, flagship, card, answers)
    lap("prep unsharded", t0)
    t0 = time.time()
    by_path["sharded"], s4, step["mesh_steps"] = phase_sharded(
        torch, K, C, R, tt, idx, dflt, oracle, flagship, card, answers,
        timings)
    lap("sharded", t0)
    t0 = time.time()
    phase_shard_kernels(torch, K, qc, s4, flagship, records)
    lap("shard kernels", t0)
    t0 = time.time()
    mesh_replayed = phase_mesh_graphs(torch, K, C, R, tt, flagship, s4,
                                      dflt, answers, card)
    step["mesh_graph_nodes_8g"] = mesh_replayed["graph_nodes"]
    step["mesh_capture_s_8g"] = mesh_replayed["capture_s"]
    mesh4 = [str(d) for d in s4._get_device_index().devices]
    _free(torch, s4)
    lap("mesh graphs", t0)
    t0 = time.time()
    phase_prep(torch, tt, idx, flagship, card, answers, mesh4)
    lap("prep sharded", t0)
    t0 = time.time()
    by_path["replicas"] = phase_replicas(torch, K, C, R, tt, idx, dflt,
                                         flagship, card)
    lap("replicas", t0)
    for label in ("sharded", "replicas"):
        for k, n in by_path[label].items():
            counts[k] += n
    t0 = time.time()
    phase_device_guard(torch, K, qc, tt, idx, flagship,
                       lambda n, q, a: _answer(answers, (n, repr(q),
                                                         repr(a))))
    lap("device guard", t0)
    check(set(records) == set(K.launches),
          f"kernel records {sorted(records)} != kernels "
          f"{sorted(K.launches)}")
    for name, rec in records.items():
        check(counts[name] > 0, f"kernel {name} was never launched")
        rec["launches"] = counts[name]
        rec["launches_by_path"] = {lb: c[name] for lb, c in by_path.items()}
    for name, rec in records.items():
        rec["launches_replayed_5g"] = replayed["credited"][name]
        rec["graph_nodes_5g"] = replayed["nodes"][name]
        rec["launches_replayed_8g"] = mesh_replayed["credited"][name]
        rec["graph_nodes_8g"] = mesh_replayed["nodes"][name]
    check(set(products) == set(PRODUCTS),
          f"product records {sorted(products)} != {sorted(PRODUCTS)}")
    for name, rec in products.items():
        rec["launches"] = by_path["default"][name]
        rec["launches_by_path"] = {lb: c[name] for lb, c in by_path.items()}
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    say(f"whole run {time.time() - t_run:.1f}s: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in phases.items()))
    say(json.dumps({"graph_step": step}))
    say(json.dumps({"products": list(products.values())}))
    say(json.dumps({"kernels": list(records.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
