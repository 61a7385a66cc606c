"""The traffic generators: the same seed gives the same traffic; the grid's
seeds share one multiset of sizes; the open loop is a Poisson process, one
fixed realisation under `schedule_seed`; the stated distributions."""

import json
import os
from statistics import NormalDist

import numpy as np
import pytest

from benchmark.harness import traffic

from .conftest import BENCH

CHAT = {"rate": 4.0,
        "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8, "min": 32, "max": 2048},
        "output": {"dist": "lognormal", "median": 64, "sigma": 0.8, "min": 16, "max": 512}}


def rng(seed):
    return np.random.default_rng([seed, 0])


def test_same_seed_same_traffic():
    a_reqs, a_due = traffic.open_loop(CHAT, 30.0, 32768, rng(2**31 + 5))
    b_reqs, b_due = traffic.open_loop(CHAT, 30.0, 32768, rng(2**31 + 5))
    assert a_reqs == b_reqs and np.array_equal(a_due, b_due)
    assert traffic.requests(CHAT, 40, 32768, rng(2**31 + 5)) == \
        traffic.requests(CHAT, 40, 32768, rng(2**31 + 5))


def test_seeds_share_the_grid_of_sizes():
    a = traffic.requests({**CHAT, "round": 8}, 32, 32768, rng(1))
    b = traffic.requests({**CHAT, "round": 8}, 32, 32768, rng(2))
    assert a != b
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(o for _, o in a) == sorted(o for _, o in b)


def test_open_loop_is_a_poisson_process():
    """Exponential gaps at the rate, and arrival counts whose variance is
    their mean (a smoothed schedule's would be far less)."""
    reqs, due = traffic.open_loop(CHAT, 2000.0, 32768, rng(3))
    assert len(reqs) == len(due) and np.all(np.diff(due) > 0)
    assert 0 < due[0] and due[-1] <= 2000.0
    assert len(due) == pytest.approx(8000, abs=4 * np.sqrt(8000))
    gaps = np.diff(due, prepend=0)
    assert gaps.mean() == pytest.approx(0.25, rel=0.05)
    assert np.median(gaps) == pytest.approx(0.25 * np.log(2), rel=0.05)
    counts = np.histogram(due, bins=400, range=(0, 2000))[0]  # 20 expected a bin
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.25)
    prompts = np.array([len(p) for p, _ in reqs])
    assert prompts.min() >= 32 and prompts.max() <= 2048
    assert np.median(prompts) == pytest.approx(256, rel=0.05)


def test_open_loop_shorter_window_is_a_prefix():
    mix = {**CHAT, "schedule_seed": 0}
    a_reqs, a_due = traffic.open_loop(mix, 20.0, 32768, rng(4))
    b_reqs, b_due = traffic.open_loop(mix, 40.0, 32768, rng(4))
    assert np.array_equal(a_due, b_due[:len(a_due)]) and len(b_due) > len(a_due)
    assert a_reqs == b_reqs[:len(a_reqs)]


def test_lognormal_grid():
    g = traffic.grid(CHAT["prompt"], 1001)
    assert g.min() >= 32 and g.max() <= 2048
    assert np.median(g) == 256
    q90 = 256 * np.exp(0.8 * NormalDist().inv_cdf(0.9))
    assert np.quantile(g, 0.9) == pytest.approx(q90, rel=0.01)


def test_uniform_and_fixed_grids():
    g = traffic.grid({"dist": "uniform", "min": 2048, "max": 3072}, 16)
    assert g.min() >= 2048 and g.max() <= 3072 and g.mean() == pytest.approx(2560, abs=1)
    assert set(traffic.grid({"dist": "fixed", "value": 256}, 5)) == {256}
    with pytest.raises(ValueError):
        traffic.grid({"dist": "zipf"}, 3)


def test_token_ids_in_range():
    reqs = traffic.requests(CHAT, 50, 1000, rng(4))
    ids = np.concatenate([p for p, _ in reqs])
    assert ids.min() >= traffic.LOW_ID and ids.max() < 1000


@pytest.mark.parametrize("name", sorted(n[:-5] for n in os.listdir(os.path.join(BENCH, "workloads"))))
def test_cell_mixes_fit_their_context(name):
    with open(os.path.join(BENCH, "workloads", name + ".json")) as f:
        mix = json.load(f)["mix"]
    n = 4096
    prompts, outputs = traffic.grid(mix["prompt"], n), traffic.grid(mix["output"], n)
    assert prompts.max() + outputs.max() <= 4096  # both configurations' context


def test_blocks_carry_the_same_share_of_short_and_long():
    v = traffic.dealt(np.arange(32), 8, rng(8))  # 4 blocks, strata of 4 values
    for b in range(4):
        assert sorted(v[8 * b: 8 * b + 8] // 4) == list(range(8))
    assert sorted(traffic.dealt(np.arange(10), 3, rng(9))) == list(range(10))
    assert not np.array_equal(traffic.dealt(np.arange(32), 8, rng(1)),
                              traffic.dealt(np.arange(32), 8, rng(2)))


def test_schedule_seed_fixes_the_order_and_leaves_the_ids_to_the_run_seed():
    mix = {**CHAT, "schedule_seed": 0}
    a_reqs, a_due = traffic.open_loop(mix, 30.0, 32768, rng(1))
    b_reqs, b_due = traffic.open_loop(mix, 30.0, 32768, rng(2))
    assert np.array_equal(a_due, b_due)
    assert [(len(p), o) for p, o in a_reqs] == [(len(p), o) for p, o in b_reqs]
    assert a_reqs != b_reqs
