"""Spans the benchmark records around its calls into the program, and the
device side of a torch.profiler window.

A span is (name, start, end, parent), host seconds on the window's clock.
A span adds no sync of its own: the calls it wraps end in reading their
tokens back to the host (an engine step, an admission, a generation), so
a span holds its call's device work and not only the enqueue.  Spans nest: a step that admits a request holds that admission's
span, and `self_s` takes the children out.  With the profiler on, each span
is also a `record_function` range, so idle gaps can be put down to what the
host was doing.

The profiler window keeps each device operation (kernel, copy, set) as
(name, start, end) in seconds; `busy_s` is the length of their union, so
kernels that overlap (the decode kernel's programmatic launches) count
once.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int  # index of the enclosing span, -1 for none


class Spans:
    """In-memory spans; `wrap` times a callable inside a `label` range (the
    profiler's `record_function`)."""

    def __init__(self, clock: Callable[[], float], label: Callable):
        self.clock, self.label = clock, label
        self.spans: List[Span] = []
        self._open: List[int] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*a, **kw):
            idx = len(self.spans)
            self.spans.append(Span(name, self.clock(), float("nan"),
                                   self._open[-1] if self._open else -1))
            self._open.append(idx)
            try:
                with self.label(name):
                    out = fn(*a, **kw)
            finally:
                self._open.pop()
                s = self.spans[idx]
                self.spans[idx] = s._replace(end=self.clock())
            return out
        return timed

    def of(self, name: str, start: float = float("-inf"), end: float = float("inf")):
        """Indices of the spans called `name` that lie in [start, end]."""
        return [i for i, s in enumerate(self.spans)
                if s.name == name and s.start >= start and s.end <= end]

    def self_s(self, i: int) -> float:
        s = self.spans[i]
        kids = sum(c.end - c.start for c in self.spans if c.parent == i)
        return (s.end - s.start) - kids


def kind(name: str) -> str:
    """The class of a device operation: the program's kernels by name, the
    products (cuBLAS / CUTLASS GEMMs and GEMVs) and the copies and casts
    that feed them (a bf16 weight widened to float32 before its product is
    one), copies between host and device, and the other torch ops."""
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "paged_attn" in n:
        return "paged_attention"
    if "argmax_head" in n:
        return "argmax_head"
    if "flash_prefill" in n:
        return "flash_prefill"
    if "decode_gemv_kernel" in n or "decode_attn_kernel" in n:
        return "decode_layers"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_")):
        return "matmul"
    if "copy" in n:
        return "copy_cast"
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and template or
    argument lists, at most 80 characters."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    cut = min((i for i in (n.find("<"), n.find("(")) if i > 0), default=len(n))
    return n[:cut].strip()[:80] or name[:80]


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Profile:
    """The device operations of one profiler window, and the host ranges
    (`record_function` spans and torch ops) that were open meanwhile."""

    def __init__(self, ops: List[tuple], host: List[tuple], window_s: float):
        self.ops = ops          # (name, start_s, end_s), device
        self.host = host        # (name, start_s, end_s, depth), host
        self.window_s = window_s
        self.busy_s = union_s((s, e) for _, s, e in ops)

    def time_s(self, kinds) -> float:
        """Device time of operations of these kinds, overlaps counted once."""
        return union_s((s, e) for n, s, e in self.ops if kind(n) in kinds)

    def count(self, kinds) -> int:
        return sum(kind(n) in kinds for n, _, _ in self.ops)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.ops:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time on the device between operations, summed by what the
        host was doing at each gap's middle: the innermost benchmark span
        and torch op open then."""
        ops = sorted((s, e) for _, s, e in self.ops)
        gaps, end = [], None
        for s, e in ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        by: Dict[str, float] = {}
        nxt, open_ = 0, []
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                open_.append(host[nxt])
                nxt += 1
            open_ = [h for h in open_ if h[2] >= mid]
            spans = [h for h in open_ if h[0].startswith("bench.")]
            ops_ = [h for h in open_ if not h[0].startswith("bench.")]
            label = "/".join(x for x in (
                max(spans, key=lambda h: h[3])[0] if spans else "",
                max(ops_, key=lambda h: h[3])[0] if ops_ else "host") if x)
            by[label] = by.get(label, 0.0) + (b - a)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def profile_window(torch, fn: Callable):
    """Run `fn` under torch.profiler (host and device) and return (fn's
    value, a callable that reads the Profile).  Reading the events takes
    seconds, so the caller reads them once its measured window has closed.
    Nothing is written to disk."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return out, lambda: read_profile(prof, window_s)


def read_profile(prof, window_s: float) -> Profile:
    from torch.autograd import DeviceType

    ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        note = getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")
        if e.device_type == DeviceType.CUDA and not note:  # not a span's device copy
            ops.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
        elif e.device_type == DeviceType.CPU:
            depth, p = 0, e.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            host.append((e.name, tr.start * 1e-6, tr.end * 1e-6, depth))
    return Profile(ops, host, window_s)
