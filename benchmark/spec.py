"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration in its ``file``, a traffic mix in ``traffic/<name>.json``,
a per-layer metric's reader in ``metrics/<name>.py``."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class UnknownName(KeyError):
    pass


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise UnknownName(f"no {what} named {name!r} in BENCHMARK.json")


class Spec:
    def __init__(self):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        return _by_name(self.data["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _by_name(self.data["configs"], name, "configuration")
        with open(os.path.join(ROOT, entry["file"])) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]


def traffic(name: str) -> dict:
    path = os.path.join(HERE, "traffic", f"{name}.json")
    if not os.path.exists(path):
        raise UnknownName(f"no traffic mix {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    """The module ``metrics/<name>.py``; its ``read(run)`` returns the
    metric's value, or None where the run has nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise UnknownName(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
