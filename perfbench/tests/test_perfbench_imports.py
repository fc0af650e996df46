"""No module under perfbench/ imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the port, and
nothing the runs load reads bench.py, bench_torch.py, chip_smoke.py or
.bench_cache/."""

import ast

from conftest import ROOT

PB = ROOT / "perfbench"
JAX = {"jax", "jaxlib", "flax", "tantivy_aggregations_tpu"}


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for p in PB.rglob("*.py"):
        assert not (_top_imports(p) & JAX), p


def test_the_port_passes_the_check():
    assert "tantivy_aggregations_tpu_torch" in _top_imports(
        PB / "lib" / "harness.py")


def test_reference_imports_nothing_of_the_port():
    for p in (PB / "reference").rglob("*.py"):
        assert not (_top_imports(p) & (JAX | {
            "tantivy_aggregations_tpu_torch"})), p


def test_runs_read_no_old_bench():
    for p in PB.rglob("*.py"):
        if "tests" in p.relative_to(PB).parts:
            continue
        src = p.read_text()
        imports = _top_imports(p)
        assert not imports & {"bench", "bench_torch", "chip_smoke"}, p
        assert ".bench_cache" not in src, p
