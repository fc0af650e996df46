"""The port's bench on the CPU: bench_torch.py, the port's counterpart of
bench.py.

- bench_torch.finalize_cpp == bench.finalize_cpp on the C++ baseline's raw
  output for c1-c10, and that fruit == the oracle == the port on the CPU
  at its default config, on a 20k-doc flagship index with deletes (the
  identity gate bench_torch.py applies at 10M docs, as
  tests/test_baseline_cpp.py checks bench.py's);
- bench_torch.py run end to end at a small size with `--device cpu`
  prints bench.py's four keys as its last stdout line, and without a card
  `--device cuda` exits non-zero with no result.

quickstart_torch.py --device cpu runs in test_torch_port_boundary.py,
with jax and the JAX package made unimportable."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import bench as jbench
import bench_torch
import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.models import flagship

ROOT = Path(__file__).resolve().parents[1]


def _configs():
    return ([(i, q, a) for i, (_, q, a) in
             enumerate(flagship.judged_configs(), start=1)]
            + [(i, q, a) for i, _, q, a in flagship.extra_configs()])


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The C++ baseline's raw fruits of c1-c10 over a 20k-doc index with
    deletes, the engine built in a directory of its own (the Makefile and
    source copied), and the port's index."""
    if shutil.which("make") is None:
        pytest.skip("no make")
    root = tmp_path_factory.mktemp("baseline")
    src = root / "cpp"
    src.mkdir()
    for f in ("Makefile", "engine.cpp"):
        shutil.copy(ROOT / "baseline_cpp" / f, src / f)
    subprocess.run(["make", "-s", "-C", str(src)], check=True)
    path = str(root / "idx")
    idx = flagship.build_bench_index(path, 20_000, seed=7, card=500,
                                     n_segments=3)
    w = idx.writer()
    w.delete_term("status", "deleted")
    w.commit()
    idx = tt.Index.open(path)
    manifest = bench_torch.write_manifest(idx, path)
    raw = {}
    for cfg, _, _ in _configs():
        out = subprocess.run([str(src / "engine"), manifest, str(cfg), "1"],
                             capture_output=True, text=True, check=True)
        raw[cfg] = json.loads(out.stdout)["result"]
    return idx, raw


@pytest.mark.parametrize("cfg", range(1, 11))
def test_cpp_baseline_identity(baseline, cfg):
    idx, raw = baseline
    got = bench_torch.finalize_cpp(cfg, raw[cfg])
    assert got == jbench.finalize_cpp(cfg, raw[cfg])
    _, q, aggs = next(c for c in _configs() if c[0] == cfg)
    assert got == idx.oracle_searcher().agg_search(q, aggs), cfg
    assert idx.searcher(device="cpu").agg_search(q, aggs) == got, cfg


def _run(args, timeout):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_torch_runs_on_the_cpu_when_asked(tmp_path):
    """bench_torch.main at 3000 docs on the CPU (no baseline): the index
    built under the cache directory, every config's stream and anchors
    checked, and bench.py's four keys on the last stdout line."""
    res = _run(["-c", "import sys, bench_torch; bench_torch.CACHE = "
                f"{str(tmp_path)!r}; bench_torch.main(sys.argv[1:])",
                "--docs", "3000", "--reps", "2", "--segments", "2",
                "--skip-baseline", "--device", "cpu"], timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "qps" and last["value"] > 0
    assert "cpu" in last["metric"]
    assert "[bench] device: cpu" in res.stderr
    assert "c10 roofline: scan bound" in res.stderr
    assert os.path.exists(tmp_path / "idx_3000_2_42" / "meta.json")


def test_bench_torch_needs_a_card_unless_told(tmp_path):
    res = _run(["-c", "import torch; torch.cuda.is_available = lambda: "
                "False; import sys, bench_torch; bench_torch.CACHE = "
                f"{str(tmp_path)!r}; bench_torch.main(sys.argv[1:])",
                "--docs", "3000"], timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
    assert os.listdir(tmp_path) == []
