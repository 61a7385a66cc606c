"""Traffic made from a seed and a mix's parameters (a cell's workload file).

Closed loops (`clients`) and single streams (`round`) take their lengths
from the distribution's quantile grid: n values at the quantiles
(i + 0.5) / n, dealt by the seed into blocks of `round` requests that each
hold one value of every stratum (`dealt`).  So every seed does the same
work, in another order; the seed draws the order and the token ids.

An open loop (`rate`) is a Poisson process: each request's gap since the
last is drawn i.i.d. from the exponential at `rate`, and its prompt and
output lengths i.i.d. from their distributions, until the window closes.
With `schedule_seed` the gaps and lengths are that seed's in every run
(one realisation: every run offers the same work at the same instants)
and the run's seed draws the token ids only; without it the run's seed
draws them too.  Token ids are uniform over [3, vocab) (0-2 are the usual
special ids).

Length distributions ({"dist": ...}):
  lognormal  median, sigma, min, max (clipped)
  uniform    min, max
  fixed      value
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

LOW_ID = 3


def _clip(dist: Dict, v) -> np.ndarray:
    lo, hi = dist.get("min", 1), dist.get("max", math.inf)
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def grid(dist: Dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, as ints."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        v = np.full(n, float(dist["value"]))
    elif kind == "uniform":
        v = dist["min"] + u * (dist["max"] - dist["min"])
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return _clip(dist, v)


def draw(dist: Dict, rng) -> int:
    """One length drawn from a length distribution."""
    kind = dist["dist"]
    if kind == "fixed":
        v = float(dist["value"])
    elif kind == "uniform":
        v = rng.uniform(dist["min"], dist["max"])
    elif kind == "lognormal":
        v = dist["median"] * math.exp(dist["sigma"] * rng.standard_normal())
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return int(_clip(dist, v))


def mean_length(dist: Dict, n: int = 4096) -> float:
    return float(grid(dist, n).mean())


def dealt(values: np.ndarray, size: int, rng) -> np.ndarray:
    """`values` in blocks of about `size` that each hold one value of every
    stratum: the sorted values are cut into strata of one value a block,
    each stratum's values go to the blocks in the seed's order, and each
    block is shuffled.  Every block then carries the same share of short
    and long, while the seed decides which block and which place."""
    v, n = np.sort(values), len(values)
    blocks = -(-n // size)
    out = [[] for _ in range(blocks)]
    for s in range(0, n, blocks):
        stratum = v[s:s + blocks]
        for x, b in zip(stratum, rng.permutation(blocks)[:len(stratum)]):
            out[b].append(x)
    return np.concatenate([rng.permutation(np.asarray(o)) for o in out])


def requests(traffic: Dict, n: int, vocab: int, rng) -> List[Tuple[List[int], int]]:
    """n requests (prompt ids, output tokens): lengths from the grids of n,
    dealt in blocks of `round` (default: one block of n); all from `rng`."""
    size = traffic.get("round", n)
    prompt = dealt(grid(traffic["prompt"], n), size, rng)
    output = dealt(grid(traffic["output"], n), size, rng)
    return [(rng.integers(LOW_ID, vocab, size=int(p)).tolist(), int(o))
            for p, o in zip(prompt, output)]


def open_loop(traffic: Dict, seconds: float, vocab: int, rng):
    """The requests of a Poisson process at `rate` over a window of
    `seconds`, and their due times (s from the window's start, ascending).
    A shorter window's schedule is the start of a longer one's."""
    order = (np.random.default_rng(traffic["schedule_seed"])
             if "schedule_seed" in traffic else rng)
    mean_gap = 1.0 / float(traffic["rate"])
    sizes, due = [], []
    t = order.exponential(mean_gap)
    while t <= seconds:
        due.append(t)
        sizes.append((draw(traffic["prompt"], order), draw(traffic["output"], order)))
        t += order.exponential(mean_gap)
    reqs = [(rng.integers(LOW_ID, vocab, size=p).tolist(), o) for p, o in sizes]
    return reqs, np.asarray(due, dtype=np.float64)
