"""Term-match predicates for the expanded-set query surface (SURVEY.md
§A.14): FuzzyTermQuery / RegexQuery term-level semantics, shared by the
oracle and the device engine exactly like utils/exact.py shares the
arithmetic spec — the oracle applies a predicate to its per-segment term
table (spec-first, per-term); the device planner applies the SAME predicate
to the global term table and collapses the matched ordinals into compare
runs (query/compile.py match_runs).

Reference analog: tantivy's FuzzyTermQuery (Levenshtein automaton over the
FST term dictionary) and RegexQuery (regex-compiled FST intersection) —
SURVEY.md §2.2 T7's era query surface. The automaton-vs-table distinction
is an implementation detail of the reference's term dictionary; semantics
here are defined directly on the term strings.

Spec choices (§A.14):
- Matching is against the STORED terms exactly as indexed (for TEXT fields
  that is post-tokenization tokens, i.e. lowercased); no query-side
  normalization is applied.
- Fuzzy distance is the Damerau-Levenshtein OSA ("optimal string
  alignment") edit distance when `transpositions` (default, the
  ES/Lucene-compatible mode: a transposition of two adjacent characters
  costs 1), plain Levenshtein otherwise; `distance` must be 0, 1 or 2
  (the reference's automata bound).
- `prefix_length` requires the stored term to start with
  `term[:prefix_length]` verbatim; the distance is still computed over the
  FULL strings (with equal prefixes, that equals the suffix distance).
- Regex patterns use Python `re` syntax, anchored (`fullmatch`): the whole
  term must match, as in the reference's RegexQuery.
"""

from __future__ import annotations

import re

import numpy as np


def check_set_query_field(ftype, q) -> None:
    """Shared prepare-time field-type gate (both engines raise the same
    TypeError): fuzzy matches keyword/text terms, regex additionally facet
    paths; bytes terms are not str-matchable (spec §A.14)."""
    from ..query import ir as Q
    name = ftype.value
    if isinstance(q, Q.FuzzyTermQuery):
        if name not in ("keyword", "text"):
            raise TypeError("fuzzy query requires a keyword or text field")
        check_fuzzy(q.distance)
    elif isinstance(q, Q.RegexQuery):
        if name not in ("keyword", "text", "facet"):
            raise TypeError(
                "regex query requires a keyword, text, or facet field")


def check_fuzzy(distance: int) -> None:
    if distance not in (0, 1, 2):
        raise ValueError(
            f"fuzzy distance must be 0, 1 or 2, got {distance!r}")


def regex_term_mask(terms, pattern: str) -> np.ndarray:
    """bool[len(terms)]: term fully matches `pattern`."""
    rx = re.compile(pattern)
    n = len(terms)
    if n == 0:
        return np.zeros(0, dtype=bool)
    return np.fromiter((rx.fullmatch(t) is not None for t in terms),
                       dtype=bool, count=n)


def fuzzy_term_mask(terms, term: str, distance: int = 1,
                    transpositions: bool = True,
                    prefix_length: int = 0) -> np.ndarray:
    """bool[len(terms)]: edit_distance(stored, term) <= distance (OSA when
    `transpositions`), with the exact-prefix gate. Vectorized: one DP over
    ALL candidate terms at once (rows = terms, columns = query chars)."""
    check_fuzzy(distance)
    n = len(terms)
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    lens = np.fromiter((len(t) for t in terms), dtype=np.int64, count=n)
    cand = np.abs(lens - len(term)) <= distance
    if prefix_length > 0:
        pfx = term[:prefix_length]
        cand &= np.fromiter((t.startswith(pfx) for t in terms),
                            dtype=bool, count=n)
    idx = np.flatnonzero(cand)
    if idx.size == 0:
        return out
    sub = [terms[i] for i in idx]
    lens = lens[idx]
    L = int(lens.max()) if len(sub) else 0
    m = len(term)
    if L == 0:  # every candidate is the empty string
        out[idx] = m <= distance
        return out
    # pad candidate chars into [N, L]; -1 never equals a query codepoint
    T = np.full((len(sub), L), -1, dtype=np.int64)
    for r, t in enumerate(sub):
        if t:
            T[r, : len(t)] = np.fromiter(map(ord, t), dtype=np.int64,
                                         count=len(t))
    q = np.fromiter(map(ord, term), dtype=np.int64, count=m)
    N = len(sub)
    dist = np.full(N, m, dtype=np.int64)  # distance for zero-length terms
    prev = np.broadcast_to(np.arange(m + 1, dtype=np.int64),
                           (N, m + 1)).copy()
    prev2 = None
    for j in range(1, L + 1):
        cur = np.empty((N, m + 1), dtype=np.int64)
        cur[:, 0] = j
        tj = T[:, j - 1]
        for i in range(1, m + 1):
            cost = (tj != q[i - 1]).astype(np.int64)
            cur[:, i] = np.minimum(
                np.minimum(prev[:, i] + 1, cur[:, i - 1] + 1),
                prev[:, i - 1] + cost)
            if transpositions and i > 1 and j > 1:
                tr = (tj == q[i - 2]) & (T[:, j - 2] == q[i - 1])
                np.minimum(cur[:, i],
                           np.where(tr, prev2[:, i - 2] + 1, cur[:, i]),
                           out=cur[:, i])
        done = lens == j
        if done.any():
            dist[done] = cur[done, m]
        prev2, prev = prev, cur
    out[idx] = dist <= distance
    return out


def runs_from_sorted(vals) -> list:
    """Collapse a sorted iterable of distinct ints into inclusive (lo, hi)
    runs of consecutive values (exact python ints; works for u64-wide w's)."""
    runs = []
    for v in vals:
        if runs and v == runs[-1][1] + 1:
            runs[-1][1] = v
        else:
            runs.append([v, v])
    return [(lo, hi) for lo, hi in runs]
