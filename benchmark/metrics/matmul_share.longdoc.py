"""Device time (%) of the products and the copies and casts that feed them over device busy time, profiler window."""

from benchmark.harness import readers


def read(ctx):
    return readers.matmul_share(ctx)
