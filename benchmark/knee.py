#!/usr/bin/env python3
"""The sweep that found an open-loop cell's knee: the highest arrival rate
the engine sustains without a growing backlog.  One process, one set-up;
the cell's mix at each rate for `--seconds`, the engine emptied between
rates (requests still live are cancelled).

    python3 benchmark/knee.py --workload mistral7b.chat --rates 2,3,4 --seconds 45 --seeds 7,8

One JSON line a rate and seed: the offered rate, output tokens/s against
the offered tokens/s (rate x the mix's mean output), TTFT p50 / p95, ITL
p95, and at the end of each third of the window the requests queued (due,
no first token yet) and in flight (due, not finished), with the mean TTFT
of the requests due in each third.  A rate the engine sustains ends its
thirds with neither count growing and no rising TTFT.  Several seeds at
one rate give the spread of the metrics there.  A cell's rate is then
written into its workload file as a number; the sweep is not run by the
benchmark's checks.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None, root: str = ROOT, device: str = "cuda") -> int:
    import argparse
    import json
    import statistics

    import torch

    from benchmark.harness import readers, stats, traffic
    from benchmark.harness.runner import Harness, chip_count
    from benchmark.harness.spec import Spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="7")
    a = p.parse_args(argv)
    spec = Spec(root)
    cell = spec.workload(a.workload)
    if device == "cuda" and chip_count(torch) < cell["chips"]:
        print("no CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    seeds = [int(x) for x in a.seeds.split(",")]
    h = Harness(torch, spec, cell, seeds[0], a.seconds, False, device)
    mod = spec.driver(cell["driver"])
    base = mod.Driver(h)
    base.setup()
    for rate, seed in ((float(r), sd) for r in a.rates.split(",") for sd in seeds):
        drv = mod.Driver(h)
        drv.mix = {**drv.mix, "rate": rate}
        drv.eng, drv.be = base.eng, base.be
        drv.sched, drv.due = traffic.open_loop(drv.mix, a.seconds, h.dm.vs,
                                               np.random.default_rng([seed, 0]))
        h.window = {}
        drv.run_window()
        w = h.window
        tt = stats.ttfts(w["due"], w["first"], w["give_up"])
        done_at = [e.stamps[-1] if e.req.done else None for e in drv.entries]
        thirds = []
        for k in range(3):
            lo, hi = w["t0"] + k * a.seconds / 3, w["t0"] + (k + 1) * a.seconds / 3
            due = [i for i, d in enumerate(w["due"]) if d < hi]
            idx = [i for i in due if lo <= w["due"][i]]
            thirds.append({
                "queued": sum(1 for i in due if w["first"][i] is None or w["first"][i] > hi),
                "in_flight": sum(1 for i in due if done_at[i] is None or done_at[i] > hi),
                "ttft_mean_ms": (1e3 * statistics.mean(tt[i] for i in idx) if idx else None)})
        print(json.dumps({"rate": rate, "seed": seed, "requests": len(w["due"]),
                          "output_tok_s": readers.output_tok_s(h),
                          "offered_tok_s": rate * traffic.mean_length(drv.mix["output"]),
                          "ttft_p50_ms": 1e3 * stats.percentile(tt, 50),
                          "ttft_p95_ms": readers.ttft_ms(h, 95),
                          "itl_p95_ms": readers.itl_ms(h, 95), "thirds": thirds,
                          "card": (torch.cuda.get_device_name(0) if device == "cuda"
                                   else device)}), flush=True)
        for e in drv.entries:
            if not e.req.done:
                base.be.cancel(e.req)
    return 0


if __name__ == "__main__":
    sys.exit(main())
