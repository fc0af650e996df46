"""Observability: per-query stats and structured logging.

- `QueryStats`: wall-time breakdown of one agg_search (param prep, device
  dispatch, the blocking wait for execution + the device->host fruit copy,
  harvest).
- module logger `log`: std-logging, structured key=value formatting.
- `prep_cache`: hits and misses of the cross-process prep cache
  (utils/prep_cache.py) since the last `reset_prep()`.

Device-side profiling is `torch.profiler` around the calls of interest; the
engine adds no wrapper of its own.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("tantivy_aggregations_tpu_torch")

#: prep cache lookups that found their artifact (hits) or not (misses),
#: and the seconds and bytes of its reads (hits) and writes
prep_cache = {"hits": 0, "misses": 0, "read_s": 0.0, "read_bytes": 0,
              "write_s": 0.0, "write_bytes": 0}
_prep_lock = threading.Lock()


def count_prep(hit: bool, seconds: float = 0.0, nbytes: int = 0) -> None:
    with _prep_lock:
        prep_cache["hits" if hit else "misses"] += 1
        if hit:
            prep_cache["read_s"] += seconds
            prep_cache["read_bytes"] += nbytes


def count_prep_write(seconds: float, nbytes: int) -> None:
    with _prep_lock:
        prep_cache["write_s"] += seconds
        prep_cache["write_bytes"] += nbytes


def reset_prep() -> None:
    with _prep_lock:
        for k in prep_cache:
            prep_cache[k] = type(prep_cache[k])()


@dataclass
class QueryStats:
    prepare_ms: float = 0.0
    device_ms: float = 0.0  # dispatch + execute + transfer
    harvest_ms: float = 0.0
    total_ms: float = 0.0
    #: finer split of device_ms (collect_stats only): host-side dispatch of
    #: the program's device work vs the blocking wait for execution + the
    #: device->host fruit copy
    dispatch_ms: float = 0.0
    wait_ms: float = 0.0
    docs_matched: Optional[int] = None
    batch_size: int = 1
    program_cached: bool = True

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("prepare_ms", "device_ms", "dispatch_ms", "wait_ms",
                 "harvest_ms", "total_ms", "docs_matched", "batch_size",
                 "program_cached")}


class _Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        out = (t - self.t0) * 1000.0
        self.t0 = t
        return out


def timer() -> _Timer:
    return _Timer()
