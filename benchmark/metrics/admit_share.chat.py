"""Share (%) of the window's wall time spent in admissions (BatchEngine._prefill_into, which ends in reading its first token back)."""

from benchmark.harness import readers


def read(ctx):
    return readers.span_share(ctx, "bench.admit")
