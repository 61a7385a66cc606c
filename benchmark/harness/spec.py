"""Where a run finds what it runs.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations and the metrics.  Each of those has files of its own under
`benchmark/`, found by name:

* a configuration: the `file` its `BENCHMARK.json` entry gives;
* a cell's traffic: `benchmark/workloads/<cell>.json`, which names its
  driver (`benchmark/drivers/<driver>.py`) and holds the traffic's
  parameters and the output check's limit;
* a per-layer metric: `benchmark/metrics/<metric>.py`, whose `read(ctx)`
  returns the number or None;
* a model family: `benchmark/families/<family>.py`, named by the
  configuration file's `"family"` key (`llama` where it has none).

A family file holds everything the harness, the drivers and the output
check know of a model's architecture:

* `dims(config)`: a NamedTuple of the sizes, with at least `nl` (layers),
  `vs` (vocabulary), `max_seq` and `dtype` (a torch dtype's name), which
  the runner, the drivers and the traffic read; it raises where the
  configuration asks for what the family does not compute;
* `engine(h)`: the program's model object on its normal path, the one
  `BatchEngine(...)` and `generate_tokens` take, with weights made on
  `h.device` from `h.seed` (`harness.weights.draw`);
* `reference(torch, dm, seed, device)`: an object whose
  `.logits(seqs, spans, precisions)` gives the plain reference's logits
  ("float32", and the "fp8" control), built from
  `benchmark/reference/<family>.py`, which imports torch alone;
* work counts: `decode_flops(dm, ctxs)` (one decode token for each
  context), `prefill_flops(dm, L)`, and for the kernels whose rooflines
  the metrics read, `paged_attention_bytes(dm, ctxs)` with
  `paged_attention_flops(dm, ctxs)`, and `decode_layers_bytes(dm, pos)`.
  A family without a kernel's count leaves its counter out, so its
  metric reads nothing.

So a new configuration, mix, metric or architecture is new files and new
entries, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
DEFAULT_FAMILY = "llama"


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
        self._families: Dict[str, object] = {}

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
        """The cell: its BENCHMARK.json entry, its traffic file, its
        configuration and the name of its model family, in one dict."""
        entry = self._entry("workloads", name)
        with open(os.path.join(self.dir, "workloads", name + ".json")) as f:
            traffic = json.load(f)
        model = self.config(entry["config"])
        return {**entry, **traffic, "model": model,
                "family": model.get("family", DEFAULT_FAMILY)}

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if _reports(m, cell)]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if _reports(m, cell)]

    def driver(self, name: str):
        return load_module(os.path.join(self.dir, "drivers", name + ".py"),
                           f"bench_driver_{name}")

    def family(self, name: str):
        """The model family's module (loaded once a Spec)."""
        if name not in self._families:
            self._families[name] = load_module(
                os.path.join(self.dir, "families", name + ".py"), f"bench_family_{name}")
        return self._families[name]

    def reader(self, metric: str):
        """The per-layer metric's `read(ctx) -> float | None`."""
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           f"bench_metric_{metric}").read
