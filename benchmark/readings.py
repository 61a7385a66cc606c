#!/usr/bin/env python3
"""The readings a cell's output-check limit is set from, over many seeds in
one process (the kernels load once):

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --seconds 45 \
        [--control 11,12,13]

For each seed it runs the cell as `run.py --trace 0` does (weights, set-up,
the window), then reads the widest logit gap of the served sample under the
model family's float32 reference (the program's reading, `logit_gap`) and,
for the seeds given to `--control`, the widest gap of the tokens the fp8
reference puts first at the same positions (`control_gap`).  Each is judged against the
cell's limit as a run judges the program (`correct`, `control_correct`;
the control has to come out false).  One JSON line a seed.  The
benchmark's own runs never run the control.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None, root: str = ROOT, device: str = "cuda") -> int:
    import argparse
    import gc
    import json

    import numpy as np
    import torch

    from benchmark.harness import check, readers
    from benchmark.harness.runner import Harness, chip_count
    from benchmark.harness.spec import Spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    spec = Spec(root)
    cell = spec.workload(a.workload)
    if device == "cuda" and chip_count(torch) < cell["chips"]:
        print("no CUDA card", file=sys.stderr)
        return 2
    control = {int(s) for s in a.control.split(",") if s}
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        h = Harness(torch, spec, cell, seed, a.seconds, False, device)
        drv = spec.driver(cell["driver"]).Driver(h)
        drv.setup()
        h.sync()
        setup_s = time.perf_counter() - t0
        drv.run_window()
        done, errors = drv.finished()
        drv.release()
        del drv
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ck = cell["check"]
        reqs = check.sample(done, np.random.default_rng([seed, 1]), ck["served_tokens"],
                            ck["max_requests"])
        t1 = time.perf_counter()
        r = check.readings(torch, h.family, h.dm, seed, device, reqs,
                           control=seed in control)
        row = {"seed": seed, "setup_s": setup_s, "check_s": time.perf_counter() - t1,
               "requests": len(reqs), "length_errors": errors, **r,
               "correct": check.passed(check.judge(ck, r["logit_gap"], errors)),
               "output_tok_s": readers.output_tok_s(h),
               "ttft_p95_ms": readers.ttft_ms(h, 95), "itl_p95_ms": readers.itl_ms(h, 95),
               "card": torch.cuda.get_device_name(0) if device == "cuda" else device}
        if "control_gap" in r:  # the control in the program's place, judged alike
            row["control_correct"] = check.passed(check.judge(ck, r["control_gap"], 0))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
