"""Mean host time (ms) of a BatchEngine.step (it ends in reading its tokens back), admissions inside it taken out."""

from benchmark.harness import readers


def read(ctx):
    return readers.span_self_ms(ctx, "bench.step")
