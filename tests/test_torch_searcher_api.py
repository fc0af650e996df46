"""The JAX package's entry-point surface in the PyTorch port, on the CPU:
`Searcher(index, mesh=None, config=None)` takes JAX's positional order
(the device keyword-only), `Program.scan_bytes()` sums the plan's
row-extent tensors as JAX's does, and `utils.stats.trace(log_dir)` wraps
torch.profiler as JAX's wraps jax.profiler."""

import json
import os

import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag
from tantivy_aggregations_tpu.parallel.shard import make_mesh as jax_mesh

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.searcher import Searcher
from tantivy_aggregations_tpu_torch.utils import stats

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("api") / "idx")
    jflag.build_bench_index(path, 4000, seed=11, n_segments=2)
    return path


# ---------------------------------------------------------------------------
# Searcher(index, mesh=None, config=None, *, device=None)
# ---------------------------------------------------------------------------

def test_searcher_positional_forms_match_keywords_and_jax(bench_path):
    """Searcher(idx), Searcher(idx, mesh) and Searcher(idx, mesh, cfg) as
    the JAX package spells them: the mesh and the config bind where JAX
    binds them, the fruits == the keyword forms' == JAX's."""
    idx, jidx = tt.Index.open(bench_path), tat.Index.open(bench_path)
    s = Searcher(idx)
    assert (s.device, s.mesh) == ("cuda", None)
    mesh = tt.make_mesh(devices=["cpu"] * 2)
    cfg = EngineConfig(max_batch=16, use_cube=False)
    jcfg = JaxConfig(max_batch=16, use_cube=False)
    pos, pos_cfg = Searcher(idx, mesh), Searcher(idx, mesh, cfg)
    kw = Searcher(idx, mesh=mesh)
    kw_cfg = Searcher(idx, mesh=mesh, config=cfg)
    assert pos.mesh == mesh and pos.device is None
    assert pos_cfg.config == cfg and pos.config == EngineConfig()
    jpos = tat.Searcher(jidx, jax_mesh(2))
    jpos_cfg = tat.Searcher(jidx, jax_mesh(2), jcfg)
    for (_, jq, ja), (_, pq, pa) in zip(jflag.judged_configs()[:4],
                                        pflag.judged_configs()[:4]):
        want = jpos.agg_search(jq, ja)
        assert jpos_cfg.agg_search(jq, ja) == want
        for sr in (pos, pos_cfg, kw, kw_cfg):
            assert sr.agg_search(pq, pa) == want, pq


def test_searcher_device_is_keyword_only(bench_path):
    """The order before the repair, Searcher(idx, device, ...), raises: a
    device string no longer binds positionally (it would bind as the
    mesh), and a device beside a mesh still raises ValueError."""
    idx = tt.Index.open(bench_path)
    with pytest.raises(TypeError):
        Searcher(idx, None, None, "cpu")
    with pytest.raises(TypeError):
        Searcher(idx, "cpu")  # a str is no mesh
    with pytest.raises(ValueError):
        Searcher(idx, tt.make_mesh(devices=["cpu"] * 2), device="cpu")
    s = Searcher(idx, device="cpu")
    _, q, aggs = pflag.judged_configs()[0]
    assert s.agg_search(q, aggs) == idx.oracle_searcher().agg_search(q, aggs)
    assert idx.searcher(device="cpu").device == "cpu"


# ---------------------------------------------------------------------------
# Program.scan_bytes()
# ---------------------------------------------------------------------------

_SKIPPED = ("CUBE#", "PCUBE#", "SCUBE#", "MOP#", "DMM#")


@pytest.mark.parametrize("n", range(1, 11))
def test_scan_bytes_sums_the_row_extent_tensors(bench_path, n):
    """scan_bytes == the summed bytes of the plan's tensors, leaving out
    the cube's sites and block histograms, the member operand and the
    dense products' operands; the row modes' plan scans at least as much
    (no operand answers for the row pass there)."""
    idx = tt.Index.open(bench_path)
    q, aggs = next((q, a) for i, _, q, a in
                   [(i, nm, q, a) for i, (nm, q, a) in
                    enumerate(pflag.judged_configs(), 1)]
                   + pflag.extra_configs() if i == n)
    prog = idx.searcher(device="cpu")._program_for(q, aggs)
    arrays = prog._arrays
    scanned = {k for k in arrays if not k.startswith(_SKIPPED)}
    assert "alive" in scanned
    assert prog.scan_bytes() == sum(
        arrays[k].numel() * arrays[k].element_size() for k in scanned)
    skipped = {k[:k.index("#") + 1] for k in set(arrays) - scanned}
    want = {1: set(), 2: {"CUBE#"}, 3: {"DMM#"}, 4: set(),
            5: {"CUBE#", "PCUBE#"}, 6: set(), 7: {"MOP#"}, 8: {"CUBE#"},
            9: {"CUBE#", "SCUBE#"}, 10: {"CUBE#"}}[n]
    assert skipped == want, (n, sorted(arrays))
    row = idx.searcher(device="cpu", config=EngineConfig(
        use_cube=False, dense_mxu=False, use_member_ops=False))
    rprog = row._program_for(q, aggs)
    assert not any(k.startswith(_SKIPPED) for k in rprog._arrays)
    assert rprog.scan_bytes() >= prog.scan_bytes() > 0


# ---------------------------------------------------------------------------
# utils.stats.trace(log_dir)
# ---------------------------------------------------------------------------

def test_trace_without_a_dir_writes_nothing(bench_path, tmp_path,
                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    idx = tt.Index.open(bench_path)
    _, q, aggs = pflag.judged_configs()[0]
    with stats.trace(None):
        got = idx.searcher(device="cpu").agg_search(q, aggs)
    assert got == idx.oracle_searcher().agg_search(q, aggs)
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(bench_path, tmp_path):
    idx = tt.Index.open(bench_path)
    s = idx.searcher(device="cpu")
    _, q, aggs = pflag.judged_configs()[3]
    s.agg_search(q, aggs)  # planned outside the trace
    d = tmp_path / "trace"
    with stats.trace(str(d)):
        got = s.agg_search(q, aggs)
    assert got == idx.oracle_searcher().agg_search(q, aggs)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(d / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
