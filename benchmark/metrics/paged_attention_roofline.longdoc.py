"""The paged-attention kernel's bound over its device time, merge included (%)."""

from benchmark.harness import readers


def read(ctx):
    return readers.paged_attention_roofline(ctx)
