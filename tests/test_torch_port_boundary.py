"""The boundary between the PyTorch port and the JAX package:

- the port imports and answers without jax (the card's machine has none);
- both packages' writers produce indexes that answer identically;
- the host modules the port copies stay copies of the JAX originals (only
  the edits the port needs), so the two cannot drift apart unnoticed."""

import inspect
import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import pytest

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.aggs import compile as jcompile
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag
from tantivy_aggregations_tpu.query import compile as jqc

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.aggs import compile as pcompile
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.query import compile as pqc

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "tantivy_aggregations_tpu"
PORT_PKG = ROOT / "tantivy_aggregations_tpu_torch"

#: host modules the port carries as verbatim copies
VERBATIM = [
    "schema.py", "native.py",
    "utils/mono.py", "utils/exact.py", "utils/calendar.py",
    "utils/termmatch.py", "utils/tokenize.py",
    "index/segment.py", "index/index.py", "index/writer.py",
    "index/merge_policy.py",
    "query/ir.py", "aggs/ir.py", "oracle/engine.py", "models/flagship.py",
]

#: copied functions inside rewritten modules
COPIED_QUERY_FNS = ["extract_params", "_term_w_params", "match_runs",
                    "_extract", "_prefix_successor", "_zero_bound",
                    "query_fields"]
COPIED_HARVEST = ["_flat", "_harvest", "_mono_from_mm", "_user_scalar",
                  "_reconstruct_sum", "_sum_at", "_harvest_metric",
                  "_harvest_percentiles", "_harvest_histogram",
                  "_term_key_user", "_harvest_terms_hostsel",
                  "_harvest_facet", "_harvest_terms", "_harvest_top_hits",
                  # phase 2's host rank resolution and the facet child set
                  "_node_at", "_slot_ranks", "attach_percentiles",
                  "_facet_children"]
#: copied module-level helpers of aggs/compile.py
COPIED_COMPILE_FNS = ["_limb_totals_vec", "_has_nonint_pct_sub"]
#: copied Searcher methods: the msearch group cap and the stream driver
COPIED_SEARCHER = ["_group_cap", "agg_search_stream"]


def _code_lines(path: Path):
    """Source lines minus import lines (the only lines a copy may change)."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_matches_jax_original(rel):
    assert _code_lines(PORT_PKG / rel) == _code_lines(JAX_PKG / rel), rel


def test_copied_functions_match_jax_originals():
    for name in COPIED_QUERY_FNS:
        assert inspect.getsource(getattr(pqc, name)) == \
            inspect.getsource(getattr(jqc, name)), name
    for name in COPIED_HARVEST:
        assert inspect.getsource(getattr(pcompile.Program, name)) == \
            inspect.getsource(getattr(jcompile.Program, name)), name
    for name in COPIED_COMPILE_FNS:
        assert inspect.getsource(getattr(pcompile, name)) == \
            inspect.getsource(getattr(jcompile, name)), name
    from tantivy_aggregations_tpu import searcher as jsearcher
    from tantivy_aggregations_tpu_torch import searcher as psearcher
    for name in COPIED_SEARCHER:
        assert inspect.getsource(getattr(psearcher.Searcher, name)) == \
            inspect.getsource(getattr(jsearcher.Searcher, name)), name


def test_copied_host_path_matches_jax_originals():
    """The exact host path and the set-query acceptance gate are copies:
    `_HostFallback`, `_iter_set_queries`, `Program.accepts` and
    `Program.accepts_on`."""
    from tantivy_aggregations_tpu import searcher as jsearcher
    from tantivy_aggregations_tpu_torch import searcher as psearcher
    assert inspect.getsource(psearcher._HostFallback) == \
        inspect.getsource(jsearcher._HostFallback)
    assert inspect.getsource(pcompile._iter_set_queries) == \
        inspect.getsource(jcompile._iter_set_queries)
    for name in ("accepts", "accepts_on"):
        assert inspect.getsource(getattr(pcompile.Program, name)) == \
            inspect.getsource(getattr(jcompile.Program, name)), name


def test_engine_config_keeps_the_serving_knobs():
    """The port keeps the JAX EngineConfig's serving knobs and its cube and
    dense-product switches with the same defaults (both on), and drops the
    member-op and Pallas knobs."""
    port = {f.name: f.default for f in fields(EngineConfig)}
    jax_cfg = {f.name: f.default for f in fields(JaxConfig)}
    assert set(port) == {"dense_nb", "collect_stats", "max_batch",
                         "msearch_dedup", "dense_mxu", "use_cube"}
    assert port["dense_mxu"] and port["use_cube"]
    assert all(jax_cfg[k] == v for k, v in port.items())
    assert inspect.getsource(EngineConfig.validate) == \
        inspect.getsource(JaxConfig.validate)


def test_port_has_no_jax_import():
    for path in PORT_PKG.rglob("*.py"):
        for ln in path.read_text().splitlines():
            s = ln.strip()
            assert not (s.startswith("import jax")
                        or s.startswith("from jax")), (path, ln)


_NO_JAX = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.models import flagship as F
idx = tt.Index.create_in_ram(F.bench_schema())
w = idx.writer()
w.add_documents_columnar(F.generate_bench_columns(3000, 42), 3000)
w.commit()
_, q, aggs = F.judged_configs()[0]
got = idx.searcher(device="cpu").agg_search(q, aggs)
assert got == idx.oracle_searcher().agg_search(q, aggs), got
assert not [m for m, v in sys.modules.items()
            if v is not None and (m == "jax" or m.startswith("jax."))]
print("ANSWERED", got["n"]["value"])
"""


def test_port_answers_c1_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ANSWERED 3000" in res.stdout


def test_port_and_jax_writers_agree(tmp_path):
    a, b = str(tmp_path / "jax_written"), str(tmp_path / "port_written")
    jflag.build_bench_index(a, 6000, seed=7, n_segments=3)
    pflag.build_bench_index(b, 6000, seed=7, n_segments=3)
    ja, jb = tat.Index.open(a), tat.Index.open(b)
    for _, q, aggs in jflag.judged_configs():
        assert ja.oracle_searcher().agg_search(q, aggs) == \
            jb.oracle_searcher().agg_search(q, aggs)
    pi = tt.Index.open(a)
    assert type(pi.searcher(device="cpu")).__module__ == \
        "tantivy_aggregations_tpu_torch.searcher"
    assert type(pi.oracle_searcher()).__module__ == \
        "tantivy_aggregations_tpu_torch.oracle.engine"


#: the port's modules of sharded meshes, replica groups and the prep cache
SCALE_OUT = ["parallel/shard.py", "parallel/replica.py",
             "utils/prep_cache.py"]
#: ReplicatedSearcher's serving methods are copies of the JAX package's
COPIED_REPLICA = ["replicas", "agg_search", "_chunks", "agg_search_batch",
                  "agg_search_stream"]


@pytest.mark.parametrize("rel", SCALE_OUT)
def test_scale_out_modules_import_neither_jax_nor_the_jax_package(rel):
    import ast
    tree = ast.parse((PORT_PKG / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert not (n == "jax" or n.startswith("jax.")
                        or n == "tantivy_aggregations_tpu"
                        or n.startswith("tantivy_aggregations_tpu.")), \
                (rel, n)


def test_replica_serving_matches_jax_original():
    from tantivy_aggregations_tpu.parallel import replica as jrep
    from tantivy_aggregations_tpu_torch.parallel import replica as prep
    for name in COPIED_REPLICA:
        j = getattr(jrep.ReplicatedSearcher, name)
        p = getattr(prep.ReplicatedSearcher, name)
        if isinstance(j, property):
            j, p = j.fget, p.fget
        assert inspect.getsource(p) == inspect.getsource(j), name


_NO_JAX_MESH = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["tantivy_aggregations_tpu"] = None
import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.models import flagship as F
from tantivy_aggregations_tpu_torch.utils import stats
path = tempfile.mkdtemp() + "/ix"
F.build_bench_index(path, 3000, seed=42, n_segments=2)
idx = tt.Index.open(path)
o = idx.oracle_searcher()
s = idx.searcher(mesh=tt.make_mesh(devices=["cpu"] * 2))
for _, q, aggs in F.judged_configs():
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)
reqs = [(q, a) for _, q, a in F.judged_configs()]
rs = tt.ReplicatedSearcher(tt.Index.open(path), replicas=2,
                           devices=["cpu"] * 2)
assert rs.agg_search_batch(reqs) == [o.agg_search(q, a) for q, a in reqs]
stats.reset_prep()
s2 = tt.Index.open(path).searcher(mesh=tt.make_mesh(devices=["cpu"] * 2))
assert [s2.agg_search(q, a) for q, a in reqs] == \\
    [o.agg_search(q, a) for q, a in reqs]
assert stats.prep_cache["misses"] == 0 and stats.prep_cache["hits"] > 0
assert not [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "tantivy_aggregations_tpu"))]
print("MESH OK")
"""


def test_mesh_replicas_and_prep_cache_without_jax():
    """A 2-shard mesh, two replica groups and a warm prep cache answer c1-c5
    with neither jax nor the JAX package importable."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _NO_JAX_MESH], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "MESH OK" in res.stdout
