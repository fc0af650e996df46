"""Cross-process persistence of the port's one-time prep artifacts.

The port's counterpart of the JAX package's utils/prep_cache.py, with a
format and a directory of its own. The cube's operands and block
histograms, the OrderedLayout permutations and the static top_hits orders
are pure functions of the index CONTENTS, expensive to rebuild (argsorts,
bincounts, device builds at 10M rows) and reusable across processes. (The
masked-sums product's bf16 operands and dense_buckets' payload planes at
value rows are not kept: the card builds them from resident planes, the
one-hot operands faster than they read back from disk; PERF.md.) Their
HOST forms are stored as .npz files in `<index>/.prep_cache_torch/`,
keyed by (format version, epoch, shard count, key), where the epoch is the
index's `content_stamp`: a digest of its meta.json and of the names, sizes
and modification times of its segment files. Every commit / delete /
merge rewrites some of them, so a stale entry is unreachable, also from
another process. (The in-memory `Index.epoch` the JAX package keys on
restarts at 0 on every `Index.open`, so it cannot tell two versions of an
index apart across processes.) The JAX package keeps its own
`<index>/.prep_cache/`; the two layouts differ (the port's cube operands
are transposed [K, Dprod] int8), so neither package reads the other's
files: the directories differ and the hashed tag names the port.

RAM indexes have no path, so nothing persists. TAT_PREP_CACHE=0 turns the
cache off (read at each call). Writes are atomic (a temporary file, then a
rename); a read error counts as a miss. `utils/stats.prep_cache` counts
hits and misses (lookups that reached the directory) and the seconds and
bytes read and written.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np

from .stats import count_prep, count_prep_write

#: bump when the stored form of ANY cached artifact changes
PREP_VERSION = 1
DIR_NAME = ".prep_cache_torch"


def enabled() -> bool:
    return os.environ.get("TAT_PREP_CACHE", "") != "0"


def _dir_of(path):
    if path is None or not enabled():
        return None
    return os.path.join(path, DIR_NAME)


def content_stamp(path: str) -> str:
    """A digest of an on-disk index's contents as its files stand: the
    meta.json bytes, then each segment directory's file names, sizes and
    modification times."""
    h = hashlib.sha1()
    with open(os.path.join(path, "meta.json"), "rb") as f:
        h.update(f.read())
    for d in sorted(os.listdir(path)):
        full = os.path.join(path, d)
        if not d.startswith("seg_") or not os.path.isdir(full):
            continue
        for name in sorted(os.listdir(full)):
            st = os.stat(os.path.join(full, name))
            h.update(f"{d}/{name}:{st.st_size}:{st.st_mtime_ns};".encode())
    return h.hexdigest()


def _file_for(dirpath: str, epoch, n_shards: int, key) -> str:
    tag = repr(("torch", PREP_VERSION, epoch, int(n_shards), key))
    h = hashlib.sha1(tag.encode()).hexdigest()
    return os.path.join(dirpath, f"{h}.npz")


def load(path, epoch, n_shards: int, key):
    """The dict of host arrays saved under `key`, or None (a miss)."""
    d = _dir_of(path)
    if d is None:
        return None
    f = _file_for(d, epoch, n_shards, key)
    t0 = time.perf_counter()
    try:
        with np.load(f, allow_pickle=False) as z:
            out = {k: z[k] for k in z.files}
    except Exception:
        out = None  # absent, corrupt or partial: rebuild
    count_prep(out is not None, time.perf_counter() - t0,
               sum(a.nbytes for a in out.values()) if out else 0)
    return out


def save(path, epoch, n_shards: int, key, arrays: dict) -> None:
    """Atomically persist a dict of host numpy arrays under `key`."""
    d = _dir_of(path)
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        f = _file_for(d, epoch, n_shards, key)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, f)
            count_prep_write(time.perf_counter() - t0,
                             sum(np.asarray(v).nbytes
                                 for v in arrays.values()))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except OSError:
        pass  # a read-only index directory: persistence is best-effort


def cached(anchor, key, build, to_host, from_host):
    """Build-or-load one artifact: `anchor` is (path, content stamp,
    n_shards) of the index (path None: no persistence). On a hit
    `from_host(arrays)`; on a miss `build()`, whose `to_host(value)` (a
    dict of arrays, or None to keep nothing) is saved."""
    path, epoch, n_shards = anchor
    h = load(path, epoch, n_shards, key)
    if h is not None:
        return from_host(h)
    v = build()
    hv = to_host(v) if path is not None and enabled() else None
    if hv is not None:
        save(path, epoch, n_shards, key, hv)
    return v
