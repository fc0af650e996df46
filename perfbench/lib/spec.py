"""BENCHMARK.json and the files its names lead to.

Everything that belongs to one configuration, one traffic mix or one
metric sits in files of its own, found by the name BENCHMARK.json gives:
  configuration c   `configs[].file` (perfbench/configs/<c>.json), whose
                    "generator" names perfbench/data/<generator>.py;
  traffic mix t     perfbench/traffic/<t>.json (lib/traffic_gen.py reads
                    every mix);
  metric m          perfbench/metrics/<m>.py, whose read(run) takes the
                    metric from the run's record (None: nothing to read).
"""

import importlib.util
import json
import re
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(Path(root) / entry["file"]) as f:
        return json.load(f)


def mix(name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, tag: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    return _load(Path(root) / "perfbench" / "metrics" / f"{name}.py",
                 "perfbench_metric_" + re.sub(r"\W", "_", name)).read


def generator(name: str, root: Path = ROOT):
    return _load(Path(root) / "perfbench" / "data" / f"{name}.py",
                 "perfbench_data_" + re.sub(r"\W", "_", name)).columns
