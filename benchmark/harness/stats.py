"""Percentiles and the latencies of served requests.

A request is due at `due` (s, the window's clock).  Its output tokens are
each stamped with the host time they became available.  TTFT is the first
token's stamp less `due`; the gaps between consecutive stamps are its
inter-token latencies.  A request that failed, or got no token before the
wait ended, counts as missing: its TTFT is the longest wait the run
allowed (close + grace - due), above any limit a user could hold it to.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 100]): the smallest value
    with at least q % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return v[rank - 1]


def ttfts(due: Sequence[float], first: Sequence[Optional[float]],
          give_up: float) -> List[float]:
    """Each request's TTFT in s; a request with no first token (None) waited
    until `give_up`."""
    return [(give_up if f is None else f) - d for d, f in zip(due, first)]


def gaps(stamps: Sequence[Sequence[float]], until: float = math.inf) -> List[float]:
    """Every gap between consecutive tokens of every request whose later
    token came by `until`."""
    out = []
    for s in stamps:
        out += [b - a for a, b in zip(s, s[1:]) if b <= until]
    return out

