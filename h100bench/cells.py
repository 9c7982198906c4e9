"""Finds everything a cell names by file: its configuration, its traffic
mix, the mix's plans and references, and the metric readers.

``BENCHMARK.json`` at the root of the checkout names cells and metrics;
each configuration is ``configs/<name>.json``, each mix
``mixes/<name>.json``, each query ``queries/<q>.mplan`` with its
reference ``reference/<q>.py``, and each metric ``metrics/<name>.py``.
Adding one is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def load_module(path: str, name: str):
    """A Python file of the benchmark as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]  # the metrics of BENCHMARK.json this cell reports
    per_layer: List[dict]

    @property
    def queries(self) -> List[str]:
        """The mix's queries, each once, in the order they first come."""
        return list(dict.fromkeys(self.mix["order"]))

    def plan(self, q: str) -> str:
        with open(os.path.join(HERE, "queries", f"{q}.mplan")) as f:
            return f.read()

    def reference(self, q: str):
        return load_module(os.path.join(HERE, "reference", f"{q}.py"),
                           f"h100bench_reference_{q}")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict = None) -> Cell:
    bench = bench if bench is not None else manifest()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name=name,
                config=_json(HERE, "configs", f"{w['config']}.json"),
                mix=_json(HERE, "mixes", f"{w['traffic']}.json"),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       "h100bench_metric_" + metric.replace(".", "_")).read


def peaks() -> Dict[str, dict]:
    return _json(HERE, "peaks.json")
