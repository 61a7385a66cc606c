"""Share (%) of the profiler window with no operation on the device."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
