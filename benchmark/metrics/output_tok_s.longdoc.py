"""Output tokens delivered in the window over the window's seconds, in the long-document cells."""

from benchmark.harness import readers


def read(ctx):
    return readers.output_tok_s(ctx)
