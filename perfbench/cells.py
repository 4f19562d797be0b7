"""Finds a cell's parts by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<traffic>.json``), and a
reader for each metric it reports (``metrics/<metric>.py``, whose
``read(run)`` returns the number or None). Adding a configuration, a mix
or a metric is adding a file and an entry; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# seconds of the window the traced run hands to the profiler
TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    trace_seconds: float = TRACE_SECONDS

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT, bench: dict | None = None
            ) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    with open(root / conf_entry["file"]) as fh:
        config = json.load(fh)
    with open(root / "perfbench" / "traffic" / f"{entry['traffic']}.json") \
            as fh:
        traffic = json.load(fh)
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def from_files(config: str, traffic: str, root: Path = ROOT) -> Cell:
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``
    that ``BENCHMARK.json`` does not list (yet), with no metrics: for the
    tests and ``calibrate.py``."""
    base = root / "perfbench"
    with open(base / "configs" / f"{config}.json") as fh:
        conf = json.load(fh)
    with open(base / "traffic" / f"{traffic}.json") as fh:
        mix = json.load(fh)
    return Cell(name=f"{config}.{traffic}",
                entry={"config": config, "traffic": traffic, "chips": 1},
                config=conf, traffic=mix, end_to_end=[], per_layer=[])


def load_reader(metric: str, root: Path = ROOT):
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: list, run: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for metric in metrics:
        value = load_reader(metric["name"], root)(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out
