"""The one generator of traffic: a mix file under perfbench/traffic/ in,
a fixed pool of concrete requests out, drawn from the seed.

A mix file holds data only ("source", where its requests come from, is
read by no code):
  "driver"        "stream" (closed loop: agg_search_stream, as many
                  requests as the system takes) or "closed_loop" (one
                  client: the next agg_search when the last answer is in);
  "requests"      request templates, each {"name", "query", "aggs",
                  "params"}; query and aggs are JSON trees (lib/dsl.py);
                  "params" maps a name to {"choice": [...]} or
                  {"int": [lo, hi]} (hi excluded), drawn per request;
                  inside the trees {"param": p, "times": a, "plus": b}
                  stands for a * p + b (a = 1, b = 0 when left out);
  "block"         requests of one template in a row, templates in turn;
  "pool_cycles"   cycles of blocks (every template once) in the pool, which
                  the run replays from its start as often as its window
                  asks; each cycle has the same blocks, so every seed gives
                  the same work in another order of parameters;
  "check"         {"distinct_per_request": distinct requests of a
                  template that the reference answers, "slots": slot
                  indices of a group to cover (a request's slot is its
                  offset in its block modulo "slots"; 128 for a stream
                  of full msearch groups, 1 for one request at a time)};
  "engine_config" EngineConfig fields that the mix sets (the rest: the
                  configuration's, then the port's defaults);
  "warm_cycles"   pool cycles run through the window's entry point at the
                  end of set-up (default 1);
  "lookahead"     (stream) msearch groups in flight.

The check's sample is drawn from the seed before the window: for each
template, `distinct_per_request` of its distinct requests, its first
among them; then for each slot index the first pool position at that
slot whose request is one of them (where none is, the first at that
slot, its request added), and the first position of each drawn request
besides. The answers of those positions are kept on every pass of the
window over the pool, and each is compared with the reference's answer
to its request.
"""

import json

import numpy as np


def _draw(spec, rng):
    if "choice" in spec:
        vals = spec["choice"]
        return vals[int(rng.integers(0, len(vals)))]
    lo, hi = spec["int"]
    return int(rng.integers(lo, hi))


def substitute(tree, params):
    """`tree` with every {"param": ...} node replaced by its value."""
    if isinstance(tree, dict):
        if "param" in tree:
            v = params[tree["param"]]
            if "times" in tree or "plus" in tree:
                v = tree.get("times", 1) * v + tree.get("plus", 0)
            return v
        return {k: substitute(v, params) for k, v in tree.items()}
    if isinstance(tree, list):
        return [substitute(v, params) for v in tree]
    return tree


def request_key(req: dict) -> str:
    """Identity of a concrete request: its query and aggs trees."""
    return json.dumps([req["query"], req["aggs"]], sort_keys=True)


class Pool:
    """The pool of one run: `requests[i]` is the concrete request of pool
    position i ({"name", "query", "aggs"}), `keys[i]` its identity,
    `keep[i]` whether answers of position i are kept for the check,
    `check_keys` the keys of the requests the reference answers."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng([int(seed), 0x7261666669])
        block = int(mix["block"])
        self.requests = []
        for _ in range(int(mix["pool_cycles"])):
            for tmpl in mix["requests"]:
                for _ in range(block):
                    params = {k: _draw(v, rng)
                              for k, v in sorted(tmpl.get("params",
                                                          {}).items())}
                    self.requests.append({
                        "name": tmpl["name"],
                        "query": substitute(tmpl["query"], params),
                        "aggs": substitute(tmpl["aggs"], params)})
        self.keys = [request_key(r) for r in self.requests]
        self.block = block
        self.cycle = block * len(mix["requests"])
        self.keep, self.check_keys = self._sample(mix, seed)

    def _sample(self, mix, seed):
        """(keep, check_keys): whether each pool position's answers are
        kept, and the sorted keys of the requests the reference answers."""
        rng = np.random.default_rng([int(seed), 0x636865636b])
        per = int(mix["check"]["distinct_per_request"])
        slots = int(mix["check"]["slots"])
        keep = np.zeros(len(self.requests), bool)
        out = set()
        for tmpl in mix["requests"]:
            pos = [i for i, r in enumerate(self.requests)
                   if r["name"] == tmpl["name"]]
            # the template's first request, so that every window that
            # answers one cycle checks every template, and per - 1 more
            first = self.keys[pos[0]]
            keys = sorted({self.keys[i] for i in pos} - {first})
            if len(keys) > per - 1:
                keys = [keys[j] for j in sorted(
                    rng.choice(len(keys), per - 1, replace=False).tolist())]
            chosen = {first, *keys}
            for s in range(slots):
                at = [i for i in pos if i % self.block % slots == s]
                i = next((i for i in at if self.keys[i] in chosen), at[0])
                keep[i] = True
                chosen.add(self.keys[i])
            for k in chosen:
                with_k = [i for i in pos if self.keys[i] == k]
                if not keep[with_k].any():
                    keep[with_k[0]] = True
            out |= chosen
        return keep, sorted(out)

    def __len__(self):
        return len(self.requests)
