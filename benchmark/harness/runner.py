"""One run of one cell: set-up, the measured window, the output check and
the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's driver (`benchmark/drivers/<driver>.py`, named by the cell's
workload file) builds the program's engine (the configuration's model
family, `benchmark/families/<family>.py`) from weights made on the card
from the seed, warms the shapes its traffic uses (set-up, `setup_s`: from
the start of the process to the first measured instant), then drives the
window.  With `--trace 0` the window runs bare and the line carries the
cell's end-to-end metrics; with `--trace 1` the driver records spans around
its calls into the program (no sync of their own) and one
torch.profiler window inside the measured one, and the line carries the
cell's per-layer metrics, read by `benchmark/metrics/<metric>.py`, and
`profile_clock`: the profiler window's length on its own clock and on the
host's, and what was cut from operations stamped outside it
(`trace.Profile.clock`).

After the window: the peak of device memory is read, the program's state
is freed, and a sample of what it served goes to the reference
(`harness.check`).  The last lines of standard error, and the `checks` key
that ends the result line, give each compared number beside its limit.

A run exits non-zero, and prints no result, without a CUDA card (or with
fewer than the cell asks for), or when a module whose top-level name is
jax, jaxlib, flax or llama3np_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import check
from .spec import ROOT, Spec
from .trace import Spans, profile_window

FORBIDDEN = ("jax", "jaxlib", "flax", "llama3np_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden (the port's
    `llama3np_tpu_torch` begins with `llama3np_tpu` and is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Harness:
    """What a driver is handed: the cell, the seed, the device, and in a
    traced run the spans, and the model family (`family`, with `dm` its
    dims of the configuration); the driver fills `window` (its results),
    `counters` and, in a traced run, `profile` (`trace.profile_window`'s
    reader, called after the window).  The metric readers read it too."""

    def __init__(self, torch, spec: Spec, cell: Dict, seed: int, seconds: float,
                 traced: bool, device: str):
        self.torch, self.spec, self.cell = torch, spec, cell
        self.seed, self.seconds, self.traced = seed, float(seconds), traced
        self.device = device
        self.family = spec.family(cell["family"])
        self.dm = self.family.dims(cell["model"])
        self.dtype = getattr(torch, self.dm.dtype)
        self.rng = np.random.default_rng([seed, 0])  # traffic
        self.cuda = device.startswith("cuda")
        self.window: Dict = {}
        self.extra: Dict = {}  # keys of the driver's own for the result line
        self.setup_s = None
        self.counters: Dict[str, float] = {}
        self.profile = None
        self.spans = None
        if traced:
            from torch.profiler import record_function
            self.spans = Spans(time.perf_counter, record_function)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def add(self, key: str, value: float):
        self.counters[key] = self.counters.get(key, 0.0) + value


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def chip_count(torch) -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def run(argv=None, t_start: Optional[float] = None, root: str = ROOT,
        device: str = "cuda", out=None) -> int:
    """One run; prints the result line on `out` (stdout) and returns the
    exit code.  `device` other than "cuda" skips the look for a card (the
    tests drive a whole run so on the CPU)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    a = parse(argv)
    spec = Spec(root)
    cell = spec.workload(a.workload)
    if device == "cuda" and chip_count(torch) < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), "
              f"torch sees {chip_count(torch)}", file=sys.stderr)
        return 2
    h = Harness(torch, spec, cell, a.seed, a.seconds, bool(a.trace), device)
    if a.trace:  # the profiler's first start (CUPTI) takes seconds: not in the window
        profile_window(torch, lambda: None)
    drv = spec.driver(cell["driver"]).Driver(h)
    drv.setup()
    h.sync()
    h.setup_s = time.perf_counter() - t_start
    drv.run_window()
    peak = int(torch.cuda.max_memory_allocated()) if h.cuda else 0
    if h.profile is not None:  # the events are read once the window has closed
        h.profile = h.profile()
    done, length_errors = drv.finished()
    drv.release()
    del drv
    gc.collect()
    if h.cuda:
        torch.cuda.empty_cache()
    ck = cell["check"]
    reqs = check.sample(done, np.random.default_rng([a.seed, 1]), ck["served_tokens"],
                        ck["max_requests"])
    gap = (check.readings(torch, h.family, h.dm, a.seed, device, reqs)["logit_gap"]
           if reqs else None)
    checks = check.judge(ck, gap, length_errors)
    metrics = {}
    for m in (spec.per_layer(a.workload) if a.trace else spec.end_to_end(a.workload)):
        v = spec.reader(m["name"])(h)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"no result: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if h.cuda else device,
           "kind": torch.cuda.get_device_name(0) if h.cuda else device,
           "count": cell["chips"], "memory_peak_bytes": peak}
    line = {"correct": check.passed(checks), "attempted": h.window["attempted"],
            "failed": h.window["failed"], "metrics": metrics, "device": dev}
    if a.trace and h.profile is not None:
        dev["busy_s"], dev["window_s"] = h.profile.busy_s, h.profile.window_s
        line["breakdown"] = {"device_ops": h.profile.top_ops(10),
                             "idle_gaps": h.profile.idle_gaps(10)}
        line["profile_clock"] = h.profile.clock()
    line.update(h.extra)
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
