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

The window is measured on the device operations' own timeline, between
two marker kernels (`MARKER`, a spin of no cycles) that it enqueues before
the profiled work and after it, ahead of the sync that ends it: the
markers are stamped as every other device operation is, so the window
and the operations' busy time are read on one clock, and on one stream
nothing runs outside them.  The profiler's host timeline is another
clock: the host range `WINDOW` around the same work, and `host_s` from
`time.perf_counter`, are reported beside it (`Profile.clock`), not mixed
in: on an H100 the two timelines agree at a window's start (its first
operation 2-4 ms into the host range) and drift apart by up to a few
per cent of its length by its end.  Where a marker's record was lost (the
start marker's, as a rule, on that card), or no card ran one, that end of
the window is the `WINDOW` range's.  An operation stamped outside the
window is cut to it, and counted.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

WINDOW = "bench.window"  # the profiler window's host range
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the window's ends on the device


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
    products (cuBLAS / CUTLASS GEMMs and GEMVs, cuBLAS's Hopper `nvjet_*`
    GEMMs and the `splitKreduce` kernel that sums a split-K GEMM's partial
    products) and the copies and casts that feed them (a bf16 weight
    widened to float32 before its product is one), copies between host and
    device, and the other torch ops."""
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
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_", "nvjet",
                            "splitkreduce")):
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
    (`record_function` spans and torch ops) that were open meanwhile.

    `window` is (start, end) of the window on the operations' timeline
    (`device_window`), `host_range` that of the `WINDOW` range and `marks`
    the markers recorded; without a window the operations are kept whole
    and `window_s` is `host_s`."""

    def __init__(self, ops: List[tuple], host: List[tuple], host_s: float,
                 window: Optional[tuple] = None, host_range: Optional[tuple] = None,
                 marks: int = 0):
        self.host = host        # (name, start_s, end_s, depth), host
        self.host_s, self.window, self.host_range = host_s, window, host_range
        self.marks = marks
        self.raw = (min((s for _, s, _ in ops), default=None),
                    max((e for _, _, e in ops), default=None))
        self.cut_n, self.cut_s = 0, 0.0
        if window is not None:
            w0, w1 = window
            kept = []
            for n, s, e in ops:
                cs, ce = max(s, w0), min(e, w1)
                if (cs, ce) != (s, e):
                    self.cut_n += 1
                    self.cut_s += (e - s) - max(0.0, ce - cs)
                if ce > cs:
                    kept.append((n, cs, ce))
            ops = kept
        self.ops = ops          # (name, start_s, end_s), device
        self.window_s = window[1] - window[0] if window is not None else host_s
        self.busy_s = union_s((s, e) for _, s, e in ops)

    def clock(self) -> Dict[str, float]:
        """The window's length on the device's timeline and on the host's
        two clocks; where the operations begin and end against it (before
        any cut); where the device window lies in the host range; and what
        was cut."""
        out = {"window_s": self.window_s, "host_s": self.host_s, "markers": self.marks,
               "cut_ops": self.cut_n, "cut_s": self.cut_s}
        r, w = self.host_range, self.window
        if r is not None:
            out["host_range_s"] = r[1] - r[0]
        if w is not None and self.raw[0] is not None:
            out["ops_start_after_s"] = self.raw[0] - w[0]
            out["ops_end_before_s"] = w[1] - self.raw[1]
        if w is not None and r is not None and w != r:
            out["device_start_after_host_s"] = w[0] - r[0]
            out["device_end_before_host_s"] = r[1] - w[1]
        return out

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
    """Run `fn` under torch.profiler (host and device), inside the host
    range `WINDOW` and, on a card, between two marker kernels, a device
    sync closing it; return (fn's value, a callable that reads the
    Profile).  Reading the events takes seconds, so the caller reads them
    once its measured window has closed.  Nothing is written to disk."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            if cuda:
                torch.cuda._sleep(0)
            out = fn()
            if cuda:
                torch.cuda._sleep(0)
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    return out, lambda: read_profile(prof, host_s)


def read_profile(prof, host_s: float) -> Profile:
    from torch.autograd import DeviceType

    ops, host, marks, host_range = [], [], [], None
    for e in prof.events():
        tr = e.time_range
        span = (tr.start * 1e-6, tr.end * 1e-6)
        note = getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")
        if e.device_type == DeviceType.CUDA and MARKER in e.name:
            marks.append(span)
        elif e.device_type == DeviceType.CUDA and not note:  # not a span's device copy
            ops.append((e.name, *span))
        elif e.device_type == DeviceType.CPU and e.name == WINDOW:
            host_range = span
        elif e.device_type == DeviceType.CPU:
            depth, p = 0, e.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            host.append((e.name, *span, depth))
    return Profile(ops, host, host_s, device_window(ops, marks, host_range), host_range,
                   marks=len(marks))


def device_window(ops: List[tuple], marks: List[tuple], host_range: Optional[tuple]):
    """The window on the device's timeline: from the start marker (one
    stamped before every operation) to the end marker (one stamped after
    every operation began).  The profiler may lose a marker's record (the
    start one, in the first milliseconds of a window); that end is then
    the host range's, where the device is idle at the start and the host's
    and device's timelines still agree."""
    first = min((s for _, s, _ in ops), default=float("inf"))
    last = max((s for _, s, _ in ops), default=float("-inf"))
    starts = [s for s, _ in marks if s <= first]
    ends = [e for s, e in marks if s >= last and s > min(starts, default=float("-inf"))]
    lo, hi = host_range if host_range is not None else (None, None)
    lo, hi = (min(starts) if starts else lo), (max(ends) if ends else hi)
    return (lo, hi) if lo is not None and hi is not None else None
