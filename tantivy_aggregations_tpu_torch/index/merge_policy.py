"""Automatic segment-merge policies (tantivy's LogMergePolicy analog,
SURVEY.md §2.2 T2: "merge policy compacts segments").

tantivy buckets segments into logarithmic size levels and merges a level
once enough segments accumulate in it, so write-heavy indexes stay at
O(log N) segments without user intervention. This engine keeps the same
shape with one deliberate difference: merge candidates are CONTIGUOUS runs
in segment-list order, never arbitrary subsets — segment order defines
global doc order here (segments concatenate into one device plane,
index/loader.py), and contiguous-run merges preserve it, so top_hits
doc-id tie-breaks stay stable across compactions except for the dropped
deletes.

Defaults mirror tantivy's LogMergePolicy (min 8 segments per level,
10M-doc ceiling per mergeable segment, 10k-doc level floor, 0.75 decades
per level)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class LogMergePolicy:
    #: segments of one level that must accumulate before that level merges
    min_num_segments: int = 8
    #: segments at/above this many alive docs are never auto-merged
    max_docs_before_merge: int = 10_000_000
    #: sizes below this floor count as one level (tiny segments merge
    #: together regardless of exact size)
    min_layer_size: int = 10_000
    #: level width in log10 docs: segments within one width share a level
    level_log_size: float = 0.75

    def _level(self, alive_docs: int) -> int:
        sz = max(int(alive_docs), 1, self.min_layer_size)
        return int(math.floor(math.log10(sz) / self.level_log_size))

    def select(self, segments) -> Optional[Tuple[int, int]]:
        """(start, count) of the first contiguous same-level run of at
        least min_num_segments mergeable segments, or None."""
        sizes = [int(s.alive_mask().sum()) for s in segments]
        levels = [self._level(sz) for sz in sizes]
        ok = [sz < self.max_docs_before_merge for sz in sizes]
        i, n = 0, len(segments)
        while i < n:
            if not ok[i]:
                i += 1
                continue
            j = i + 1
            while j < n and ok[j] and levels[j] == levels[i]:
                j += 1
            # a run must shrink the segment count: never "merge" one
            # segment into itself (maybe_merge would loop forever)
            if j - i >= max(2, self.min_num_segments):
                return i, j - i
            i = j
        return None


def no_merge_policy() -> None:
    """Assign to `Index.merge_policy` to disable automatic compaction."""
    return None
