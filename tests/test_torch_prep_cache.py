"""The port's cross-process prep cache (utils/prep_cache.py): cube
operands, block histograms, layouts and top_hits orders persist as .npz
files in `<index>/.prep_cache_torch/`, keyed by (format version, epoch,
shard count, key). The cases of the JAX package's
tests/test_prep_cache.py (round trip, epoch invalidation, a corrupt file
read as a miss), TAT_PREP_CACHE=0, a warm re-plan that reads every
artifact (no miss) with == fruits, unsharded and on a 4-shard mesh, and
the isolation of the two packages' files."""

import os

import numpy as np
import pytest

from tantivy_aggregations_tpu import (
    MatchAllQuery,
    RangeQuery,
    TermQuery,
    histogram_agg,
    percentiles_agg,
    sum_agg,
    terms_agg,
    top_hits_agg,
)
from tantivy_aggregations_tpu.utils import prep_cache as JPC

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.utils import prep_cache as PC
from tantivy_aggregations_tpu_torch.utils import stats

from test_prep_cache import REQS as JAX_REQS, disk_index
from test_torch_multi_query import to_port

#: the JAX package's requests (cube, prefix layout, member operand, rank
#: and slot percentiles), then a dense product (its operand built at each
#: plan, not cached), a top_hits order, the pcube and a histogram layout
REQS = [(to_port(q), to_port(a)) for q, a in JAX_REQS + [
    (MatchAllQuery(), {"t": terms_agg("status", size=3,
                                      sub_aggs={"s": sum_agg("amount")})}),
    (RangeQuery("amount", lower=50), {"h": top_hits_agg(3, "price")}),
    (TermQuery("status", "c"), {"p": percentiles_agg("amount")}),
    (RangeQuery("price", lower=1.0),
     {"h": histogram_agg("amount", interval=3,
                         sub_aggs={"s": sum_agg("amount")})}),
]]


def _answers(searcher):
    return [searcher.agg_search(q, a) for q, a in REQS]


def _cache_dir(path):
    return os.path.join(str(path), PC.DIR_NAME)


def test_prep_cache_roundtrip(tmp_path):
    disk_index(tmp_path / "ix")
    idx = tt.Index.open(str(tmp_path / "ix"))
    want = _answers(idx.oracle_searcher())
    assert _answers(idx.searcher(device="cpu")) == want
    d = _cache_dir(tmp_path / "ix")
    assert len([f for f in os.listdir(d) if f.endswith(".npz")]) >= 6
    # a warm restart: a fresh Index.open + searcher (a new DeviceIndex)
    idx2 = tt.Index.open(str(tmp_path / "ix"))
    assert _answers(idx2.searcher(device="cpu")) == want


def test_prep_cache_epoch_invalidation(tmp_path):
    disk_index(tmp_path / "ix", n=800)
    idx = tt.Index.open(str(tmp_path / "ix"))
    q, a = REQS[0]
    idx.searcher(device="cpu").agg_search(q, a)
    w = idx.writer()
    w.add_document({"amount": 5, "price": 1.0, "status": "a",
                    "sku": "s99999", "weights": [42]})
    w.commit()
    idx2 = tt.Index.open(str(tmp_path / "ix"))
    assert _answers(idx2.searcher(device="cpu")) == \
        _answers(idx2.oracle_searcher())


def test_prep_cache_corrupt_file_is_miss(tmp_path):
    disk_index(tmp_path / "ix", n=600)
    idx = tt.Index.open(str(tmp_path / "ix"))
    want = _answers(idx.oracle_searcher())
    assert _answers(idx.searcher(device="cpu")) == want
    d = _cache_dir(tmp_path / "ix")
    for f in os.listdir(d):
        with open(os.path.join(d, f), "wb") as fh:
            fh.write(b"garbage")
    stats.reset_prep()
    idx2 = tt.Index.open(str(tmp_path / "ix"))
    assert _answers(idx2.searcher(device="cpu")) == want
    assert stats.prep_cache["misses"] > 0
    assert stats.prep_cache["hits"] == 0


def test_prep_cache_off(tmp_path, monkeypatch):
    monkeypatch.setenv("TAT_PREP_CACHE", "0")
    disk_index(tmp_path / "ix", n=600)
    idx = tt.Index.open(str(tmp_path / "ix"))
    stats.reset_prep()
    assert _answers(idx.searcher(device="cpu")) == \
        _answers(idx.oracle_searcher())
    assert not os.path.exists(_cache_dir(tmp_path / "ix"))
    assert (stats.prep_cache["hits"], stats.prep_cache["misses"],
            stats.prep_cache["write_bytes"]) == (0, 0, 0)


@pytest.mark.parametrize("mesh", [None, 4])
def test_warm_replan_builds_nothing(tmp_path, mesh):
    """A fresh searcher over a warm cache plans and runs every request
    reading its artifacts (no miss), with == fruits; a 4-shard mesh keys
    its files by n_shards = 4 and the shard."""
    disk_index(tmp_path / "ix", n=1500)

    def searcher():
        idx = tt.Index.open(str(tmp_path / "ix"))
        if mesh is None:
            return idx.searcher(device="cpu")
        return idx.searcher(mesh=tt.make_mesh(devices=["cpu"] * mesh))

    stats.reset_prep()
    cold = _answers(searcher())
    assert stats.prep_cache["misses"] > 0
    stats.reset_prep()
    warm = _answers(searcher())
    assert stats.prep_cache["misses"] == 0
    assert stats.prep_cache["hits"] > 0
    assert warm == cold == _answers(
        tt.Index.open(str(tmp_path / "ix")).oracle_searcher())


def test_packages_never_read_each_other(tmp_path):
    """Files written by the JAX package's prep cache under the same index
    and key are never read by the port, and the reverse."""
    path = str(tmp_path / "ix")
    os.makedirs(path)
    key = ("layout", "amount", "value")
    arrays = {"perm": np.arange(8, dtype=np.int32)}
    JPC.save(path, 3, 1, key, arrays)
    assert JPC.load(path, 3, 1, key) is not None
    assert PC.load(path, 3, 1, key) is None
    PC.save(path, 5, 1, key, arrays)
    assert PC.load(path, 5, 1, key) is not None
    assert JPC.load(path, 5, 1, key) is None
    assert sorted(os.listdir(path)) == sorted([".prep_cache", PC.DIR_NAME])
