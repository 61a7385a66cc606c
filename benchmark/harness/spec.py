"""Where a run finds what it runs.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations and the metrics.  Each of those has files of its own under
`benchmark/`, found by name:

* a configuration: the `file` its `BENCHMARK.json` entry gives;
* a cell's traffic: `benchmark/workloads/<cell>.json`, which names its
  driver (`benchmark/drivers/<driver>.py`) and holds the traffic's
  parameters and the output check's limit;
* a per-layer metric: `benchmark/metrics/<metric>.py`, whose `read(ctx)`
  returns the number or None.

So a new configuration, mix or metric is new files and new entries, never
an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: str):
    """A Python file loaded as a module of its own (names may hold dots)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    """`BENCHMARK.json` and the files it names, under `root` (the checkout)
    and `bench_dir` (the benchmark's own folder)."""

    def __init__(self, root: str = ROOT, bench_dir: Optional[str] = None):
        self.root = root
        self.dir = bench_dir or os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _entry(self, kind: str, name: str) -> Dict:
        for e in self.bench[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {kind[:-1]} {name!r}")

    def config(self, name: str) -> Dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict:
        """The cell: its BENCHMARK.json entry, its traffic file and its
        configuration, in one dict."""
        entry = self._entry("workloads", name)
        with open(os.path.join(self.dir, "workloads", name + ".json")) as f:
            traffic = json.load(f)
        return {**entry, **traffic, "model": self.config(entry["config"])}

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if _reports(m, cell)]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if _reports(m, cell)]

    def driver(self, name: str):
        return load_module(os.path.join(self.dir, "drivers", name + ".py"),
                           f"bench_driver_{name}")

    def reader(self, metric: str):
        """The per-layer metric's `read(ctx) -> float | None`."""
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           f"bench_metric_{metric}").read
