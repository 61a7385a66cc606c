"""Every configuration, cell and metric of BENCHMARK.json loads by name,
and the file keeps to the shape the benchmark's checks hold it to."""

import json
import os
import re

import pytest

from benchmark.harness import spec as spec_mod

from .conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec()


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_every_config_loads(spec, name):
    entry = next(c for c in bench()["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/") and NAME.match(name)
    cfg = spec.config(name)
    dm = spec.family(cfg.get("family", spec_mod.DEFAULT_FAMILY)).dims(cfg)
    assert dm.dtype == "bfloat16" and min(dm.nl, dm.vs, dm.max_seq) > 0
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for key in entry["reduced"]:  # never a width
        assert not key.endswith(("_dim", "_rank", "_size")) and "head" not in key


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads(spec, name):
    cell = spec.workload(name)
    assert set(next(w for w in bench()["workloads"] if w["name"] == name)) == {
        "name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and NAME.match(name) and 1 <= len(cell["why"]) <= 200
    assert hasattr(spec.driver(cell["driver"]), "Driver")
    assert {"served_tokens", "max_requests", "logit_gap_limit"} <= set(cell["check"])
    e2e = {m["name"] for m in spec.end_to_end(name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(name)
    assert layers and all(m["moves"] in e2e for m in layers)


def test_metrics_have_readers_and_shapes(spec):
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
    assert {m["layer"] for m in b["per_layer"]} == {
        "serving engine", "generation loop", "model forward", "kernels", "device"}


def test_roofline_metrics_are_named_so():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_readers_find_nothing_in_an_empty_run(spec):
    class Empty:
        window = {"window_s": 1.0, "output_tokens": 0, "t0": 0.0, "t1": 1.0}
        counters, spans, profile, setup_s = {}, None, None, 1.0

    for m in bench()["per_layer"]:
        assert spec.reader(m["name"])(Empty()) is None, m["name"]


def test_ttft_tail_leaves_out_the_profiled_waits(spec):
    class Run:  # the second request waits across the profiler, the third is due inside it
        window = {"due": [0.0, 1.0, 2.0, 5.0], "first": [0.1, 4.5, 2.2, 5.3], "give_up": 70.0,
                  "profiled": (2.0, 4.0)}

    assert spec.reader("ttft_p95_ms.chat")(Run()) == pytest.approx(300.0)


def test_check_budget_fits():
    """A full check of 24 cells at this run length fits its 43,200 s."""
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_benchmark_files_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
