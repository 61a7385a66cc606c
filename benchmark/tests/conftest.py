"""Fixtures of the benchmark's own tests: a checkout-like root whose
BENCHMARK.json holds the real cells over a tiny configuration, so a whole
run fits on the CPU.  The card's own readings come from
`benchmark/readings.py` and `benchmark/run.py` on the chip."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.harness.spec import load_module

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
LLAMA = load_module(os.path.join(BENCH, "families", "llama.py"), "bench_family_llama")

TINY = {"hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
        "max_position_embeddings": 256, "num_attention_heads": 4, "num_hidden_layers": 2,
        "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "float32",
        "vocab_size": 512}


def tiny_mix(w: dict) -> dict:
    """A cell's workload at the tiny configuration's sizes."""
    w = json.loads(json.dumps(w))
    if "clients" in w["mix"]:
        w["mix"]["clients"] = w["engine"]["capacity"] = 4
        w["mix"]["prompt"] = {"dist": "uniform", "min": 20, "max": 60}
        w["mix"]["output"] = {"dist": "uniform", "min": 10, "max": 30}
    elif "rate" in w["mix"]:  # enough load that every slot serves
        w["engine"]["capacity"], w["mix"]["rate"] = 4, 40
        w["mix"]["prompt"].update(median=20, min=4, max=100)
        w["mix"]["output"].update(median=16, min=8, max=40)
    else:
        w["mix"]["prompt"] = {"dist": "uniform", "min": 8, "max": 40}
        w["mix"]["output"]["value"] = 16
    w["profile_s"] = 0.3
    w["check"]["max_requests"] = 64
    return w


def make_root(path, config: dict, limit: float = 1e-3) -> str:
    """A checkout-like root at `path`: the real BENCHMARK.json's cells over
    `config`, with the real drivers, metric readers, model families and
    references (the last two in folders of their own, each file a link, so
    a test can add a family)."""
    b = path / "benchmark"
    (b / "workloads").mkdir(parents=True)
    (b / "configs").mkdir()
    os.symlink(os.path.join(BENCH, "drivers"), b / "drivers")
    os.symlink(os.path.join(BENCH, "metrics"), b / "metrics")
    for sub in ("families", "reference"):
        (b / sub).mkdir()
        for f in os.listdir(os.path.join(BENCH, sub)):
            if f.endswith(".py"):
                os.symlink(os.path.join(BENCH, sub, f), b / sub / f)
    (b / "configs" / "tiny.json").write_text(json.dumps(config))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    for w in bench["workloads"]:
        w["config"] = "tiny"
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            mix = tiny_mix(json.load(f))
        mix["check"]["logit_gap_limit"] = limit
        (b / "workloads" / (w["name"] + ".json")).write_text(json.dumps(mix))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, TINY)
