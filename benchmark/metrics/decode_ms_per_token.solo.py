"""observability.timed_generate's decode seconds over its decode tokens (n - 1 a request), ms."""

from benchmark.harness import readers


def read(ctx):
    return readers.decode_ms_per_token(ctx)
