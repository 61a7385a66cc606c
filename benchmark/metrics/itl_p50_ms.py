"""Median of every gap between consecutive output tokens of every request, in the window, ms."""

from benchmark.harness import readers


def read(ctx):
    return readers.itl_ms(ctx, 50)
