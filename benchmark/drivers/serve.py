"""Serving through the program's continuous-batching engine
(`llama3np_tpu_torch.serving.BatchEngine`, paged), one thread: this loop
submits requests and steps the engine, as a server's engine loop does.

The workload file gives `engine` (BatchEngine's arguments, and `quantum`,
the tokens a step) and `mix` (`harness.traffic`):

* open loop (`rate`): every request of the window is due at a time fixed
  before the window starts; the loop submits each once it is due (late
  when a step or an admission held the loop), steps while any request is
  active, and waits for the next due time otherwise.  After the close it
  keeps stepping, with nothing new due, until every request has its first
  token (or GRACE_S has passed).
* closed loop (`clients`): that many requests are admitted in set-up;
  each one that finishes is replaced at once by the next.

Every request is greedy with no stop ids, so it serves exactly the tokens
it asks for.  A token is stamped with the host time the loop has it back
from the engine.  The pages the pool's allocator hands out are read at
every stamp; their peak goes into the result beside the pool's size
(`pool`), since the pool reserves capacity x context whatever the traffic
fills.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import traffic
from benchmark.harness.trace import profile_window

GRACE_S = 60.0
PROFILE_AT = 0.4  # the profiler window opens this far into the window


class Entry:
    __slots__ = ("req", "due", "stamps")

    def __init__(self, req, due):
        self.req, self.due, self.stamps = req, due, []


class Driver:
    def __init__(self, h):
        self.h, self.mix = h, h.cell["mix"]
        self.opts = dict(h.cell["engine"])
        self.quantum = self.opts.pop("quantum", 1)
        self.closed = "clients" in self.mix
        self.entries, self.pending, self.failed_due = [], [], []
        self.in_profile, self.delivered, self.pages_peak = False, 0, 0
        self.end = float("-inf")  # set-up's tokens fall before the window

    # -- set-up ----------------------------------------------------------

    def _next_request(self):
        if not self.queue:
            self.queue = traffic.requests(self.mix, self.mix["clients"], self.h.dm.vs,
                                          self.h.rng)
        return self.queue.pop(0)

    def setup(self):
        from llama3np_tpu_torch.serving import BatchEngine

        h = self.h
        self.eng = h.family.engine(h)
        self.be = BatchEngine(self.eng, paged=True, **self.opts)
        if self.closed:
            self.queue = []
            lengths = traffic.grid(self.mix["prompt"], self.mix["clients"])
        else:
            self.sched, self.due = traffic.open_loop(self.mix, h.seconds, h.dm.vs, h.rng)
            lengths = [len(p) for p, _ in self.sched]
        self._warm(lengths)
        if self.closed:
            for _ in range(self.mix["clients"]):
                self._submit(*self._next_request(), due=None)
                self._stamp()

    def _warm(self, lengths):
        """One admission in each prefill bucket the traffic uses (at the
        longest prompt that falls in it), then steps until idle."""
        buckets = sorted(b for b in self.eng.args.prefill_buckets
                         if b <= self.eng.args.max_seq_len)
        longest = {}
        for n in lengths:
            b = next((b for b in buckets if b >= n), n)
            longest[b] = max(longest.get(b, 0), int(n))
        rng = np.random.default_rng([self.h.seed, 2])
        for n in sorted(longest.values()):
            self.be.submit(rng.integers(traffic.LOW_ID, self.h.dm.vs, size=n).tolist(),
                           self.quantum + 1, stop_ids=())
            while self.be.num_active:
                self.be.step(self.quantum)

    # -- the window ------------------------------------------------------

    def _submit(self, prompt, max_new, due):
        try:
            e = Entry(self.be.submit(prompt, max_new, stop_ids=()), due)
        except (MemoryError, ValueError, RuntimeError) as exc:
            print(f"request failed: {exc!r}", flush=True)
            self.failed_due.append(due)
            return None
        self.entries.append(e)
        self.pending.append(e)
        return e

    def _stamp(self):
        now = time.perf_counter()
        alloc = self.be.allocator
        self.pages_peak = max(self.pages_peak, alloc.num_pages - 1 - alloc.available)
        keep = []
        for e in self.pending:
            new = len(e.req.generated) - len(e.stamps)
            if new > 0:
                e.stamps += [now] * new
                if now <= self.end:
                    self.delivered += new
            if not e.req.done:
                keep.append(e)
        self.pending = keep

    def _count(self):
        """Traced runs: count the work of each step and admission (model
        FLOPs of what completes in the window; the paged kernel's bytes and
        FLOPs inside the profiler window, where the family counts them)
        around the spans, by the model family's counts."""
        h, be, dm, fam = self.h, self.be, self.h.dm, self.h.family
        step, prefill = be.step, be._prefill_into
        q = self.quantum
        paged = all(hasattr(fam, f) for f in ("paged_attention_bytes", "paged_attention_flops"))

        def counted_step(quantum=q):
            ctxs = [int(be.pos[s]) + 1 + j for s, r in enumerate(be.slots)
                    if r is not None and not r.admitting for j in range(quantum)]
            rows = (be.pos.astype(np.int64) + 1).tolist()
            out = step(quantum)
            if time.perf_counter() <= self.end:
                h.add("model_flops", fam.decode_flops(dm, ctxs))
            if self.in_profile and paged:
                for j in range(quantum):
                    r = [c + j for c in rows]
                    h.add("profile_paged_bytes", fam.paged_attention_bytes(dm, r))
                    h.add("profile_paged_flops", fam.paged_attention_flops(dm, r))
            return out

        def counted_prefill(slot, req):
            out = prefill(slot, req)
            if time.perf_counter() <= self.end:
                h.add("model_flops", fam.prefill_flops(dm, len(req.prompt_ids)))
            return out

        be.step = h.spans.wrap("bench.step", counted_step)
        be._prefill_into = h.spans.wrap("bench.admit", counted_prefill)

    def _tick(self):
        """Submit what is due, then one step (or wait for the next due
        time)."""
        if not self.closed:
            now = time.perf_counter()
            while self.i < len(self.sched) and self.t0 + self.due[self.i] <= now:
                self._submit(*self.sched[self.i], due=self.t0 + self.due[self.i])
                self.i += 1
                self._stamp()
        if self.be.num_active:
            finished = self.be.step(self.quantum)
            self._stamp()
            if self.closed:
                for _ in finished:
                    self._submit(*self._next_request(), due=None)
                self._stamp()
        elif not self.closed and self.i < len(self.sched):
            time.sleep(max(0.0, min(self.t0 + self.due[self.i], self.end)
                           - time.perf_counter()))
        else:
            time.sleep(max(0.0, min(self.end - time.perf_counter(), 0.01)))

    def _loop(self, until):
        while time.perf_counter() < until:
            self._tick()

    def _profiled(self, until):
        self.in_profile = True
        try:
            self._loop(until)
        finally:
            self.in_profile = False

    def run_window(self):
        h = self.h
        if h.traced:
            self._count()
        self.i = 0
        self.t0 = time.perf_counter()
        self.end = self.t0 + h.seconds
        if h.traced:
            at = self.t0 + PROFILE_AT * h.seconds
            self._loop(at)
            p0 = time.perf_counter()
            _, h.profile = profile_window(h.torch, lambda: self._profiled(
                min(time.perf_counter() + h.cell["profile_s"], self.end)))
            h.window["profiled"] = (p0, time.perf_counter())  # the profiler's start to its stop
        self._loop(self.end)
        if not self.closed:  # every due request's first token, however late
            give_up = self.end + GRACE_S
            while ((self.i < len(self.sched) or any(not e.stamps for e in self.entries))
                   and time.perf_counter() < give_up):
                self._tick()
        failed = len(self.failed_due)
        alloc = self.be.allocator
        page_bytes = sum(t.nbytes for t in self.be.cache.values()) // alloc.num_pages
        h.extra["pool"] = {"pages_peak": self.pages_peak, "pages": alloc.num_pages - 1,
                           "peak_bytes": self.pages_peak * page_bytes,
                           "reserved_bytes": (alloc.num_pages - 1) * page_bytes}
        h.window.update(t0=self.t0, t1=self.end, window_s=h.seconds,
                        output_tokens=self.delivered, failed=failed,
                        attempted=len(self.entries) + failed)
        if not self.closed:
            h.window.update(
                due=[e.due for e in self.entries],
                first=[e.stamps[0] if e.stamps else None for e in self.entries],
                give_up=self.end + GRACE_S, stamps=[e.stamps for e in self.entries])
            h.window["due"] += self.failed_due  # failed: missing, no token ever
            h.window["first"] += [None] * failed

    # -- after the window ------------------------------------------------

    def finished(self):
        """Every request served, finished or not (its tokens so far), and
        the finished ones that served another count than they asked for."""
        served = [e.req for e in self.entries if e.req.generated]
        errors = sum(len(r.generated) != r.max_new_tokens for r in served if r.done)
        return [(list(r.prompt_ids), list(r.generated)) for r in served], errors

    def release(self):
        self.be = self.eng = None
