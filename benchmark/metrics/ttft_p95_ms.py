"""95th percentile over the requests due in the window of (first token back - due time), ms; a request with no token counts as missing."""

from benchmark.harness import readers


def read(ctx):
    return readers.ttft_ms(ctx, 95)
