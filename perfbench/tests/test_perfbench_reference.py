"""The reference against the port (CPU) and the port's oracle: every
sampled request of every mix, on two seeds."""

import pytest

from perfbench.lib import dsl, harness, spec
from perfbench.lib.traffic_gen import Pool
from perfbench.reference.engine import Reference

from conftest import DOCS

BENCH = spec.load_benchmark()
#: (configuration, mix) of every cell
PAIRS = sorted({(w["config"], w["traffic"]) for w in BENCH["workloads"]})


@pytest.mark.parametrize("seed", [3, 2**31 + 12345])
@pytest.mark.parametrize("config,traffic", PAIRS)
def test_port_and_oracle_equal_reference(bench_root, config, traffic, seed):
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    cfg = spec.config(BENCH, config, bench_root)
    mix = spec.mix(traffic, bench_root)
    idx, cols = harness.build_index(tt, cfg, DOCS, seed, bench_root)
    searcher = idx.searcher(device="cpu", config=EngineConfig(
        **mix.get("engine_config", {})))
    oracle = idx.oracle_searcher()
    ref = Reference(cols, DOCS)
    pool = Pool(mix, seed)
    checked = pool.check_keys
    assert {pool.requests[pool.keys.index(k)]["name"]
            for k in checked} == {r["name"] for r in mix["requests"]}
    for k in checked:
        r = pool.requests[pool.keys.index(k)]
        q, a = dsl.query(tt, r["query"]), dsl.aggs(tt, r["aggs"])
        want = ref.answer(r)
        assert searcher.agg_search(q, a) == want, (r["name"], k)
        assert oracle.agg_search(q, a) == want, (r["name"], k)


def test_generators_are_frozen_copies():
    """The columns equal the originals' draws (models/flagship.py and
    chip_smoke.py at the commit the copies name)."""
    import numpy as np
    from tantivy_aggregations_tpu_torch.models import flagship
    cfg = spec.config(BENCH, "bench10m")
    cols = spec.generator(cfg["generator"])(5000, 11, cfg["params"])
    orig = flagship.generate_bench_columns(5000, 11, cfg["params"]["sku_card"])
    for k in ("amount", "qty", "price", "ts"):
        assert np.array_equal(cols[k]["values"], orig[k])
    for k in ("status", "sku"):
        assert list(np.asarray(cols[k]["terms"], object)[cols[k]["codes"]]) \
            == list(orig[k])
    assert np.array_equal(cols["weights"]["offsets"], orig["weights"][0])
    assert np.array_equal(cols["weights"]["values"], orig["weights"][1])


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in BENCH["workloads"]}))
def test_sample_covers_every_slot_and_drawn_request(traffic):
    """The kept positions cover every slot index of each template, each
    drawn request is kept somewhere, and nothing else is kept."""
    mix = spec.mix(traffic)
    pool = Pool(mix, 2**31 + 77)
    slots = mix["check"]["slots"]
    drawn = set(pool.check_keys)
    kept = [i for i in range(len(pool)) if pool.keep[i]]
    assert {pool.keys[i] for i in kept} == drawn
    for t in mix["requests"]:
        mine = [i for i in kept if pool.requests[i]["name"] == t["name"]]
        assert {i % pool.block % slots for i in mine} == set(range(slots))
        distinct = {pool.keys[i] for i in range(len(pool))
                    if pool.requests[i]["name"] == t["name"]}
        assert len(drawn & distinct) >= min(
            len(distinct), mix["check"]["distinct_per_request"])
    # the same seed draws the same sample
    again = Pool(mix, 2**31 + 77)
    assert again.check_keys == pool.check_keys
    assert (again.keep == pool.keep).all()
