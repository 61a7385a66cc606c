"""Model FLOPs of the window's work (a token's routed and shared experts only) over the window's time at the H100's bf16 peak (%)."""

from benchmark.harness import readers


def read(ctx):
    return readers.step_mfu(ctx)
