"""Set-up: from the start of the process to the first measured instant (s), the kernels' build and the warm-up included."""


def read(ctx):
    return ctx.setup_s
