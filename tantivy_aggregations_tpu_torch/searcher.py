"""Searcher: the engine's `agg_search` entry point (SURVEY.md §2.1 C1/C3).

Reference analog: `AggSearcher::agg_search(query, agg)` — prepare the agg
tree against the schema, drive collection, merge fruits. Here: load the
index's columns to the device once (cached per index epoch), compile the
(query shape, agg tree shape) pair to one batch-first Program (cached,
LRU), execute, and harvest host-side fruits.

The arguments are the JAX package's, `Searcher(index, mesh=None,
config=None)`, with the device keyword-only: `Searcher(index,
device=...)` defaults to "cuda" and never falls back to the CPU; the CPU
tests pass device="cpu". `Searcher(index, mesh)` with a mesh from
`make_mesh(...)` (parallel/shard.py; a mesh and a device are exclusive)
loads the index doc-sharded over the mesh's devices and runs every
program once per shard (aggs/compile.py ShardedProgram); the entry
points are the same. A tree the planner cannot lower (it raises
NotImplementedError) answers through the exact host path
(`_HostFallback` over the index's oracle), with one warning on the
package logger, and so does a request whose set-query runs exceed its
program's run slots; the program stays cached for the requests of its
shape that fit. Under `EngineConfig(host_fallback=False)` such a request
raises NotImplementedError instead. Nothing else falls back: a kernel
that fails raises.

`agg_search_batch` and the `agg_search_stream` generator dispatch a
group, stage its packed fruits' copy to the host (Program.stage: a
pinned buffer and an event on the card) and collect it later; the stream
keeps `lookahead` groups in flight. A group of two or more distinct
requests is padded to the next power of two, within its cap (the
program's batch_cap, a mesh's shared by the shards of one device), as
the JAX package pads it: on the card each Program, and each mesh whose
shards share one card, replays one CUDA graph per padded batch size
(aggs/compile.py `_StepGraph`), captured at the first group of that size,
and phase 2's selection one graph per node and padded batch size.

Every request is one `tat.request` span root (every group a `tat.group`
and a `tat.collect`), the layers below it spanned where they run
(utils/stats.py); spans are on under `EngineConfig.collect_stats`,
whose `last_stats` is read from them, and inside `stats.trace`.
"""

from __future__ import annotations

from typing import Dict

import torch

from .aggs import ir as agg_ir
from .query import ir as query_ir
from .utils.stats import QueryStats, counters, request_spans, root, span


def _copy_fruits(v):
    """Independent copy of a fruit tree (dicts/lists of scalars — the
    only shapes harvest produces)."""
    if isinstance(v, dict):
        return {k: _copy_fruits(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_fruits(x) for x in v]
    return v


class _RangePrograms:
    """The program cache's entry of a shape whose f64 histograms are laid
    out over its query's range (aggs/compile.py `_range_layout`): the
    histograms' fields, and the shape's programs by the range's bounds,
    insertion-ordered, the Searcher's newest `_max_range_programs` of
    them. Each such program holds its own bucket plane, which goes with
    it."""

    __slots__ = ("fields", "programs")

    def __init__(self, fields):
        self.fields = fields
        self.programs = {}


class _HostFallback:
    """Exact host execution for the rare agg-tree shapes the device planner
    cannot lower yet (SURVEY.md §2.1: the spec defines semantics for every
    tree; the engine must never refuse one). The oracle IS the engine's
    host path — same index, same exact arithmetic — so results are
    identical by construction. Carries just enough of the Program protocol
    for the msearch/stream drivers to pass groups through synchronously."""

    def __init__(self, oracle, reason: str):
        self.oracle = oracle
        self.reason = reason

    def run(self, query, aggs):
        return self.oracle.agg_search(query, aggs)


class Searcher:
    def __init__(self, index, mesh=None, config=None, *, device=None):
        from .engine_config import EngineConfig
        if mesh is not None and device is not None:
            raise ValueError("a Searcher takes a device or a mesh, not both")
        if isinstance(mesh, (str, torch.device)):
            raise TypeError(f"mesh {mesh!r} is a device: pass device= (the "
                            "second argument is the mesh, as in the JAX "
                            "package)")
        self.index = index
        self.schema = index.schema
        self.mesh = None if mesh is None else list(mesh)
        self.device = None if mesh is not None else (device or "cuda")
        self.config = (config or EngineConfig()).validate()
        #: QueryStats of the most recent agg_search (when collect_stats)
        self.last_stats = None
        self._device_index = None
        self._device_epoch = None
        #: shape key -> its Program (or _HostFallback), or its
        #: _RangePrograms; insertion-ordered, pruned LRU-style
        self._programs = {}
        self._max_programs = 256
        #: the programs a _RangePrograms keeps (each holds an int32 bucket
        #: plane of one row per doc)
        self._max_range_programs = 4
        self._program_was_cached = False
        self._overflow_fb = None  # host path for set-query run overflow

    # -- device index ----------------------------------------------------------

    def _get_device_index(self):
        from .index.loader import load_device_index, load_sharded_index
        if self._device_index is None or self._device_epoch != self.index.epoch:
            self._device_index = (
                load_device_index(self.index, self.device)
                if self.mesh is None
                else load_sharded_index(self.index, self.mesh))
            self._device_epoch = self.index.epoch
            self._programs.clear()
        return self._device_index

    # -- entry point -----------------------------------------------------------

    def _program_for(self, query, aggs):
        """The cached Program of the request's shape (planned on a miss), a
        `_HostFallback` where the planner has no device lowering for the
        shape (cached like a program), or the overflow fallback where this
        request's set-query runs exceed the slots of its shape. Spanned
        `tat.plan` (`tat.load` and `tat.build` nest in it on a miss)."""
        with span("tat.plan"):
            prog = self._lookup(query, aggs)
        if isinstance(prog, _HostFallback):
            if not self.config.host_fallback:
                raise NotImplementedError(
                    f"no device path for this request ({prog.reason}), and "
                    "EngineConfig.host_fallback is off")
            counters["host_fallbacks"] += 1
        return prog

    def _lookup(self, query, aggs):
        from .aggs.compile import (Program, get_program, range_layout_fields,
                                   range_layout_key)
        dindex = self._get_device_index()
        key = (query_ir.structural_key(query), agg_ir.structural_key(aggs))
        entry = self._programs.pop(key, None)  # re-inserted: LRU refresh
        if entry is None:
            # an f64 histogram laid out over its query's range (a column
            # too wide for the device) reads the range's bounds at plan
            # time: such a shape keeps a program per bounds
            with span("tat.build"):  # it loads the histograms' columns
                fields = range_layout_fields(dindex, query, aggs)
            if fields:
                entry = _RangePrograms(fields)
        progs = bounds = None
        if isinstance(entry, _RangePrograms):
            self._programs[key] = entry
            progs = entry.programs
            bounds = range_layout_key(dindex, query, entry.fields)
            entry = progs.pop(bounds, None)
        prog = entry
        self._program_was_cached = prog is not None
        if prog is None:
            if not Program.accepts_on(dindex, query, aggs):
                # the planner extracts this request's params, which do not
                # fit the slots: plan nothing, so that the first fitting
                # request of the shape plans its program
                return self._overflow()
            try:
                prog = get_program(dindex, query, aggs, config=self.config)
                counters["programs_planned"] += 1
            except NotImplementedError as e:
                from .utils.stats import log
                if self.config.host_fallback:
                    log.warning("agg tree has no device lowering (%s); "
                                "running the exact host path", e)
                prog = _HostFallback(self.index.oracle_searcher(), str(e))
        if progs is None:
            self._programs[key] = prog
        else:
            progs[bounds] = prog
            while len(progs) > self._max_range_programs:
                progs.pop(next(iter(progs)))
                counters["programs_evicted"] += 1
        while len(self._programs) > self._max_programs:
            gone = self._programs.pop(next(iter(self._programs)))
            counters["programs_evicted"] += (
                len(gone.programs) if isinstance(gone, _RangePrograms)
                else 1)
        if (not isinstance(prog, _HostFallback)
                and not prog.accepts(query, aggs)):
            # same shape, but THIS request's set-query expansion exceeds
            # the compiled run slots: answer it on the exact host path
            # without evicting the program (fitting requests keep using it)
            return self._overflow()
        return prog

    def _overflow(self):
        from .utils.stats import log
        if self.config.host_fallback:
            log.warning("set query expansion exceeds the program's run "
                        "slots; running the exact host path")
        if self._overflow_fb is None:
            self._overflow_fb = _HostFallback(
                self.index.oracle_searcher(), "set-query run overflow")
        return self._overflow_fb

    def agg_search(self, query: query_ir.Query,
                   aggs: Dict[str, agg_ir.Agg]) -> Dict[str, dict]:
        """Run `aggs` over docs matching `query`; returns host-side fruits
        bit-identical to OracleSearcher.agg_search on the same index. One
        `tat.request` root; under collect_stats, `last_stats` is read from
        its spans."""
        counters["requests"] += 1
        collect = self.config.collect_stats
        with root("tat.request", collect):
            prog = self._program_for(query, aggs)
            if isinstance(prog, _HostFallback):
                with span("tat.fallback"):
                    out = prog.run(query, aggs)
            else:
                out = prog.run(query, aggs)
        if collect:
            self.last_stats = QueryStats.from_spans(
                request_spans(), self._program_was_cached)
        return out

    def agg_search_batch(self, requests) -> list:
        """Multi-search ("msearch") execution of [(query, aggs), ...].

        Runs of consecutive requests sharing the same (query shape, agg
        shape) run as ONE [B, P] param-matrix program: plane passes are
        shared across the group (the chain kernels read each plane once per
        group), and the fruits of a group come back in one device->host
        copy, staged as the group is dispatched. Groups are dispatched back
        to back before any is collected."""
        submitted = self._submit_batch(requests)
        results = []
        for group in submitted:
            results.extend(self._collect_group(group))
        return results

    def _submit_batch(self, requests) -> list:
        """Group consecutive same-shape requests (capped at max_batch, and
        at the program's batch_cap where its per-query device state must
        fit a memory budget) and dispatch every group."""
        groups = []  # (prog, [queries], aggs)
        for query, aggs in requests:
            prog = self._program_for(query, aggs)
            cap = self._group_cap(prog)
            if (groups and groups[-1][0] is prog and groups[-1][2] is aggs
                    and len(groups[-1][1]) < cap):
                groups[-1][1].append(query)
            else:
                groups.append((prog, [query], aggs))
        return [self._submit_group(prog, queries, aggs)
                for prog, queries, aggs in groups]

    def _group_cap(self, prog) -> int:
        """msearch group size for one program: the serving batch, shrunk by
        the program's own HBM-residency cap (per-query [rows] state in the
        rare slot_rank / in-slot-top_hits / sort paths must fit alongside
        the resident columns — see Program.batch_cap)."""
        cap = self.config.max_batch
        pc = getattr(prog, "batch_cap", None)
        return cap if pc is None else max(1, min(cap, pc))

    def _collect_group(self, group):
        """The answers of a submitted group, in request order (one
        `tat.collect` root, args as its `tat.group`'s plus the distinct
        rows and the padded batch size)."""
        prog, queries, aggs, raw, staged, idxmap, nuniq, B, serial = group
        with root("tat.collect", self.config.collect_stats, serial=serial,
                  rows=len(queries), distinct=nuniq, padded=B):
            if isinstance(prog, _HostFallback):
                with span("tat.fallback"):
                    return [prog.run(q, aggs) for q in queries]
            uniq_outs = prog.finalize_many(raw, aggs, nuniq, staged=staged)
        if len(queries) == nuniq:
            return uniq_outs
        # duplicated requests: each caller gets its own result object
        seen = [False] * nuniq
        out = []
        for i in idxmap:
            out.append(uniq_outs[i] if not seen[i]
                       else _copy_fruits(uniq_outs[i]))
            seen[i] = True
        return out

    def agg_search_stream(self, requests, lookahead: int = 2):
        """Sustained-serving generator over an iterable of (query, aggs):
        keeps `lookahead` msearch groups in flight so each group's
        device->host transfer lands while later groups compute — the final
        round trip amortizes over the whole stream instead of every
        agg_search_batch call. Yields result dicts in request order."""
        from collections import deque
        it = iter(requests)
        pending = deque()  # (prog, queries, aggs, raw, staged)
        holdover = []  # request that ended the previous group (shape change)

        def next_group():
            group_q, group_aggs, prog = [], None, None
            cap = self.config.max_batch
            while True:
                if holdover:
                    query, aggs = holdover.pop()
                else:
                    try:
                        query, aggs = next(it)
                    except StopIteration:
                        break
                p = self._program_for(query, aggs)
                if prog is None:
                    prog, group_aggs = p, aggs
                    cap = self._group_cap(p)
                elif p is not prog or aggs is not group_aggs:
                    holdover.append((query, aggs))  # starts the next group
                    break
                group_q.append(query)
                if len(group_q) >= cap:
                    break
            if not group_q:
                return False
            pending.append(self._submit_group(prog, group_q, group_aggs))
            return True

        for _ in range(lookahead):
            if not next_group():
                break
        while pending:
            group = pending.popleft()
            next_group()
            yield from self._collect_group(group)

    def _submit_group(self, prog, queries, aggs):
        """Dedup, pad and submit one group, its fruits' copy staged; one
        `tat.group` root (args: serial and rows)."""
        counters["groups"] += 1
        counters["group_rows"] += len(queries)
        with root("tat.group", self.config.collect_stats,
                  rows=len(queries)) as r:
            return self._submit_rows(prog, queries, aggs, r.serial)

    def _submit_rows(self, prog, queries, aggs, serial):
        if isinstance(prog, _HostFallback):  # answered at collect
            return (prog, queries, aggs, None, None, None, 0, None, serial)
        # dedup identical requests (config.msearch_dedup): a program is a
        # pure function of its extracted params — compute each distinct
        # param set ONCE and fan the fruits out
        if self.config.msearch_dedup:
            keymap, uniq, idxmap = {}, [], []
            for q in queries:
                k = prog.param_key(q, aggs)
                j = keymap.get(k)
                if j is None:
                    j = keymap[k] = len(uniq)
                    uniq.append(q)
                idxmap.append(j)
        else:
            uniq = list(queries)
            idxmap = list(range(len(queries)))
        counters["distinct_rows"] += len(uniq)
        pad = 1
        if len(uniq) == 1:
            raw = prog.submit(uniq[0], aggs)
        else:
            # JAX's padding: a group of distinct requests runs at the next
            # power of two (within the group's cap), so that a few batch
            # sizes serve every group — on the card, a few captured graphs
            # per program; finalize_many harvests the first len(uniq) rows
            while pad < len(uniq):
                pad *= 2
            pad = max(len(uniq), min(pad, self._group_cap(prog)))
            counters["padded_rows"] += pad - len(uniq)
            raw = prog.submit_many(uniq, aggs, pad_to=pad)
        return (prog, queries, aggs, raw, prog.stage(raw, aggs),
                idxmap, len(uniq), pad, serial)
