"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic, the generator and entry they name, each metric's reader and
the probes a reader names, all found by name under perfbench/."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH_FILE = os.path.join(ROOT, "BENCHMARK.json")


def load_module(path: str):
    """Import a file of perfbench/ by its path (its name need not be an
    identifier)."""
    rel = os.path.relpath(path, HERE).removesuffix(".py")
    name = "_perfbench_" + "".join(c if c.isalnum() else "_" for c in rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of BENCHMARK.json with what it names."""

    def __init__(self, workload: str):
        self.bench = read_json(BENCH_FILE)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = read_json(os.path.join(ROOT,
                                             self.config_entry["file"]))
        self.traffic = read_json(os.path.join(
            HERE, "traffic", self.cell["traffic"] + ".json"))

    def generator(self):
        return load_module(os.path.join(HERE, "generators",
                                        self.traffic["generator"] + ".py"))

    def entry(self):
        return load_module(os.path.join(HERE, "entries",
                                        self.config["entry"] + ".py"))

    def metrics(self, kind: str) -> list[dict]:
        """The cell's `end_to_end` or `per_layer` metrics."""
        return [m for m in self.bench[kind]
                if self.cell["name"] in m.get("workloads",
                                              [self.cell["name"]])]

    @staticmethod
    def reader(name: str):
        return load_module(os.path.join(HERE, "metrics", name + ".py"))

    @staticmethod
    def probe(name: str):
        return load_module(os.path.join(HERE, "probes", name + ".py"))
