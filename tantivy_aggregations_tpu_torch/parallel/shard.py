"""Sharded execution: the doc axis split over a mesh of devices.

The port of the JAX package's parallel/shard.py. A mesh is an ordered list
of `torch.device`s, one per doc shard (`make_mesh`); shard s owns the
contiguous doc rows [s * T/S, (s + 1) * T/S) of the padded doc axis, with
its value rows, layouts and operands on mesh device s
(index/loader.py `load_sharded_index`).

Single controller, as in the JAX package's `shard_map`: one process runs a
program's body once per shard, each shard in a thread of its own with its
device current (`MeshGroup.run`). The shard bodies meet at the
collectives the body calls, at the points the JAX program calls them:

- `psum`: counts, exact limb sums and the cube's int32 dot vectors
  (integer addition commutes, so the order of the merge cannot change a
  fruit);
- `pmin` / `pmax`: min / max fruits;
- `all_gather`: the per-shard top_hits candidates of a k-way merge;
- `axis_index`: the shard's index (top_hits globalize doc ids with it);
- `allgather_obj`: host objects at plan time (the cube's common piece
  layout, a cross-product expansion's common length, agreement on prep
  cache hits).

The shard bodies take turns (MeshGroup): one runs at a time, up to its
next collective; the last shard to arrive combines every shard's value on
mesh device 0 and hands each shard its copy. A shard that raises stops
the others at their next turn, so the call raises and never hangs; a
shard body that reaches a different collective than the others (a tag
check), or ends while others wait, raises as well.

The mesh may repeat a device: `["cpu"] * 8` runs eight shards on the CPU
(the tests), `["cuda:0"] * 4` four shards on one card. `run(fn, ctx)`
enters `ctx(s)` on shard s's thread around its body and its collectives:
the current CUDA stream and a torch function mode are per thread, so a
CUDA graph capture makes its stream current in every shard thread this
way (aggs/compile.py ShardedProgram: with the bodies in turns on one
stream, the capture records them and the combines in turn order), and a
test enters its guard in every shard body.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

_tls = threading.local()


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """An ordered list of devices, one per doc shard: `devices` (may repeat
    a device), else every CUDA device; the first `n_devices` of them. With
    no CUDA device and no `devices` it raises: a mesh never falls back to
    the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (pass devices=, e.g. "
                "['cpu'] * 8, to run shards on the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh's devices are of one type: {devices}")
    return devices


class MeshGroup:
    """The S shard threads of one mesh and the turns their collectives
    take. `run(fn)` calls fn(s) for every shard in lockstep and returns
    the S results.

    The bodies take turns: one shard's thread runs at a time, up to its
    next collective, where it leaves its value and hands the turn to the
    next shard; the last shard combines every value and hands the turn
    back to shard 0. Python runs serially under the GIL whatever the
    threads do, and a torch op releases and retakes the GIL around its
    launch, so free-running shard threads trade the GIL op by op (with
    one barrier per collective, c5's bisection took 2.2x as long as in
    turns on four shards of one H100: PERF.md); in turns, each
    collective costs S thread hand-overs. Device work still overlaps
    across cards: launches are asynchronous."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.S = len(self.devices)
        self._cv = threading.Condition()
        self._turn = 0
        self._broken = None
        self._slot = [None] * self.S
        self._out = None
        self._pool = None
        self._run_lock = threading.Lock()

    # -- running shard bodies ------------------------------------------------

    def run(self, fn, ctx=None):
        """[fn(0), ..., fn(S-1)], each on its shard's thread with its device
        current and inside `ctx(s)` where given (a context manager each
        shard's thread enters around its body and its collectives: a
        capture's stream, which is current per thread, or a per-thread
        guard). The first error any shard raised (not the abandoned
        collectives the others then see) is raised here."""
        with self._run_lock:
            self._turn, self._broken = 0, None
            if self.S == 1:
                return [self._work(fn, 0, ctx)]
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.S, thread_name_prefix="tat-shard")
            futs = [self._pool.submit(self._work, fn, s, ctx)
                    for s in range(self.S)]
            errs = [f.exception() for f in futs]
            first = next((e for e in errs if e is not None
                          and not isinstance(e, _Aborted)), None)
            if first is None:
                first = next((e for e in errs if e is not None), None)
            if first is not None:
                raise first
            return [f.result() for f in futs]

    def _work(self, fn, s, ctx=None):
        prev = getattr(_tls, "shard", None)
        _tls.shard = (self, s)
        dev = self.devices[s]
        prev_dev = None
        try:
            with self._cv:
                self._wait_turn(s)
            if dev.type == "cuda":
                prev_dev = torch.cuda.current_device()
                torch.cuda.set_device(dev)
            with (ctx(s) if ctx is not None else nullcontext()):
                out = fn(s)
                # every shard must end together: a shard still at another
                # collective makes this one's differ, and all of them raise
                self.exchange(s, "end", None)
            with self._cv:
                self._turn = s + 1
                self._cv.notify_all()
            return out
        except BaseException as e:
            with self._cv:
                if self._broken is None:
                    self._broken = e
                self._cv.notify_all()
            raise
        finally:
            _tls.shard = prev
            if prev_dev is not None:
                torch.cuda.set_device(prev_dev)

    def _wait_turn(self, s):
        while self._turn != s and self._broken is None:
            self._cv.wait()
        if self._broken is not None:
            raise _Aborted("another shard failed; this shard stops at its "
                           "collective")

    # -- collectives ----------------------------------------------------------

    def exchange(self, s, op, x, tag=None):
        """Leave x for collective `op` and hand over the turn; the last
        shard combines. Returns this shard's result when its turn comes."""
        with self._cv:
            self._slot[s] = (op, tag, x)
            if s == self.S - 1:
                self._combine()
                self._turn = 0
            else:
                self._turn = s + 1
            self._cv.notify_all()
            self._wait_turn(s)
            return self._out[s]

    def _combine(self):
        kinds = {(op, tag) for op, tag, _ in self._slot}
        if len(kinds) != 1:
            raise RuntimeError(
                "shards reached different collectives: "
                f"{sorted(map(str, kinds))}")
        op, _ = kinds.pop()
        xs = [x for _, _, x in self._slot]
        self._out = _COMBINE[op](self, xs)

    def _spread(self, r):
        """r (on mesh device 0) to every shard, each shard its own tensor."""
        out = []
        for s, d in enumerate(self.devices):
            if s == 0:
                out.append(r)
            elif d == self.devices[0]:
                out.append(r.clone())
            else:
                out.append(r.to(d))
        return out

    def _on0(self, x):
        """x on mesh device 0 (itself where it is there already)."""
        d0 = self.devices[0]
        return x if x.device == d0 else x.to(d0)

    def _fold(self, xs, f):
        r = self._on0(xs[0])
        for x in xs[1:]:
            r = f(r, self._on0(x))
        return self._spread(r)


class _Aborted(RuntimeError):
    """A shard's collective was abandoned because another shard failed."""


_COMBINE = {
    "sum": lambda g, xs: g._fold(xs, torch.add),
    "min": lambda g, xs: g._fold(xs, torch.minimum),
    "max": lambda g, xs: g._fold(xs, torch.maximum),
    "gather": lambda g, xs: g._spread(torch.stack([g._on0(x) for x in xs])),
    "obj": lambda g, xs: [list(xs)] * g.S,
    "end": lambda g, xs: [None] * g.S,
}


def _current():
    cur = getattr(_tls, "shard", None)
    if cur is None:
        raise RuntimeError("a collective outside a mesh run (MeshGroup.run)")
    return cur


def axis_index() -> int:
    """The index of the shard this thread runs."""
    return _current()[1]


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the shards (each shard gets the total)."""
    g, s = _current()
    return g.exchange(s, "sum", x)


def pmin(x: torch.Tensor) -> torch.Tensor:
    g, s = _current()
    return g.exchange(s, "min", x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    g, s = _current()
    return g.exchange(s, "max", x)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[S, *x.shape]: every shard's x, in shard order."""
    g, s = _current()
    return g.exchange(s, "gather", x)


def allgather_obj(obj, tag) -> list:
    """Every shard's host object, in shard order (plan time). `tag` names
    the exchange: shards that reach different ones raise."""
    g, s = _current()
    return g.exchange(s, "obj", obj, tag=tag)
