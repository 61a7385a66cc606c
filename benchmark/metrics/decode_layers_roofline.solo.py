"""The fused decode kernel's bound (weights and visible K/V a token) over its device time (%)."""

from benchmark.harness import readers


def read(ctx):
    return readers.decode_layers_roofline(ctx)
