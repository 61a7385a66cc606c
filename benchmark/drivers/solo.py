"""Single-stream generation through the program's `Llama.generate_tokens`
(batch 1, greedy): one client sends its next request once the last one's
tokens are back, as a local user of the reference's `llama3.py` does.

The mix gives `prompt` and `output` lengths and `round`, the requests of
one round of the quantile grid (`harness.traffic`).  The port hands a
request's tokens back all at once, so the window closes at a request's
end: requests start until `--seconds` have passed and the round under way
is done, and the window runs to the end of its last request.  So every
seed's window holds the same whole rounds (the same prompt lengths, in
another order), and its rate is all its tokens over all its time.

A traced run calls `observability.timed_generate` instead (prefill and
decode each ended by a device sync) and profiles whole requests.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import traffic
from benchmark.harness.trace import profile_window

PROFILE_AT = 0.4


class Driver:
    def __init__(self, h):
        self.h, self.mix = h, h.cell["mix"]
        self.queue, self.done, self.failed, self.errors = [], [], 0, 0

    def _next_request(self):
        if not self.queue:
            self.queue = traffic.requests(self.mix, self.mix["round"], self.h.dm.vs,
                                          self.h.rng)
        return self.queue.pop(0)

    def setup(self):
        h = self.h
        self.eng = h.family.engine(h)
        buckets = sorted(b for b in self.eng.args.prefill_buckets
                         if b <= self.eng.args.max_seq_len)
        longest = {}
        for n in traffic.grid(self.mix["prompt"], self.mix["round"]):
            b = next((b for b in buckets if b >= n), n)
            longest[b] = max(longest.get(b, 0), int(n))
        rng = np.random.default_rng([h.seed, 2])
        for n in sorted(longest.values()):  # each prefill bucket, and decode
            ids = rng.integers(traffic.LOW_ID, h.dm.vs, size=(1, n))
            self.eng.generate_tokens(ids, 3).cpu()

    def _one(self, profiled=False):
        from llama3np_tpu_torch.observability import timed_generate

        h, dm = self.h, self.h.dm
        prompt, n = self._next_request()
        ids = np.asarray([prompt])
        try:
            if h.traced:
                toks, st = h.spans.wrap("bench.generate", timed_generate)(self.eng, ids, n)
                h.add("decode_s", st.decode_s)
                h.add("decode_tokens", n - 1)
            else:
                toks = self.eng.generate_tokens(ids, n)
            toks = toks.cpu()[0].tolist()
        except (ValueError, RuntimeError) as exc:
            print(f"request failed: {exc!r}", flush=True)
            self.failed += 1
            return
        self.done.append((prompt, toks))
        self.errors += len(toks) != n
        L, fam = len(prompt), h.family
        if h.traced:
            h.add("model_flops", fam.prefill_flops(dm, L)
                  + fam.decode_flops(dm, range(L + 1, L + n)))
        if profiled and hasattr(fam, "decode_layers_bytes"):
            # decode token i (i = 0..n-2) runs at position L + i
            h.add("profile_decode_bytes", sum(fam.decode_layers_bytes(dm, L + i)
                                              for i in range(n - 1)))

    def run_window(self):
        h = self.h
        t0 = time.perf_counter()
        end = t0 + h.seconds
        profile_from = t0 + PROFILE_AT * h.seconds if h.traced else float("inf")
        while time.perf_counter() < end or self.queue:  # whole rounds only
            if time.perf_counter() >= profile_from:
                profile_from = float("inf")
                _, h.profile = profile_window(
                    h.torch, lambda: [self._one(profiled=True)
                                      for _ in range(h.cell["profile_requests"])])
            else:
                self._one()
        t1 = time.perf_counter()
        h.window.update(t0=t0, t1=t1, window_s=t1 - t0, failed=self.failed,
                        attempted=len(self.done) + self.failed,
                        output_tokens=sum(len(t) for _, t in self.done))

    def finished(self):
        return self.done, self.errors

    def release(self):
        self.eng = None
