"""CPU tests of the benchmark (python -m pytest perfbench/tests); none
needs a CUDA device."""

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the doc count of the CPU runs
DOCS = 20_000


@pytest.fixture
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ (no caches, no tests), so
    the files a test adds stay out of the checkout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    return tmp_path
