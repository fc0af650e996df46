"""Replica groups: the Elasticsearch replica-shard analog.

The port of the JAX package's parallel/replica.py. parallel/shard.py splits
one index's docs over a mesh (latency); this module adds the throughput
axis: R device groups, each holding a FULL copy of the index (each group a
doc-sharded mesh; a one-device group is a 1-shard mesh), and msearch
groups round-robined across the replicas. Every replica runs the same
exact programs over the same columns, so results are identical whatever R
is, and they come back in request order. A group's kernels run
asynchronously on its devices, so replicas on different cards overlap
their device work; on one card (`["cuda:0"] * 2`) they share it.
"""

from __future__ import annotations

from .shard import make_mesh


class ReplicatedSearcher:
    """R Searchers over disjoint device groups + round-robin msearch.

    `devices` (default: every CUDA device) split into `replicas` equal
    contiguous groups, each a mesh. The single-query API serves from
    rotating replicas; the batch / stream APIs split work at msearch-group
    granularity."""

    def __init__(self, index, replicas: int = 2, devices=None, config=None):
        devices = make_mesh(devices=devices)
        if replicas < 1 or len(devices) % replicas:
            raise ValueError(
                f"{len(devices)} devices do not split into "
                f"{replicas} equal replica groups")
        per = len(devices) // replicas
        self.index = index
        self.searchers = [
            index.searcher(mesh=devices[r * per:(r + 1) * per],
                           config=config)
            for r in range(replicas)]
        self._rr = 0

    @property
    def replicas(self) -> int:
        return len(self.searchers)

    def agg_search(self, query, aggs):
        s = self.searchers[self._rr]
        self._rr = (self._rr + 1) % len(self.searchers)
        return s.agg_search(query, aggs)

    def _chunks(self, requests):
        cap = self.searchers[0].config.max_batch
        reqs = list(requests)
        return [reqs[i:i + cap] for i in range(0, len(reqs), cap)]

    def agg_search_batch(self, requests) -> list:
        """msearch across all replicas: chunk j dispatches on replica
        j % R (async), results collect in request order while later
        chunks execute on the other replicas."""
        sub = []
        for j, chunk in enumerate(self._chunks(requests)):
            s = self.searchers[j % len(self.searchers)]
            sub.append((s, s._submit_batch(chunk)))
        out = []
        for s, groups in sub:
            for g in groups:
                out.extend(s._collect_group(g))
        return out

    def agg_search_stream(self, requests, lookahead: int = 2):
        """Sustained-serving generator: keeps `lookahead` chunks in flight
        PER REPLICA, yielding results in request order."""
        from collections import deque
        it = iter(requests)
        cap = self.searchers[0].config.max_batch
        R = len(self.searchers)
        pending = deque()  # (searcher, submitted groups)
        nxt = 0

        def next_chunk():
            nonlocal nxt
            chunk = []
            for _ in range(cap):
                try:
                    chunk.append(next(it))
                except StopIteration:
                    break
            if not chunk:
                return False
            s = self.searchers[nxt % R]
            nxt += 1
            pending.append((s, s._submit_batch(chunk)))
            return True

        for _ in range(lookahead * R):
            if not next_chunk():
                break
        while pending:
            s, groups = pending.popleft()
            next_chunk()
            for g in groups:
                yield from s._collect_group(g)
