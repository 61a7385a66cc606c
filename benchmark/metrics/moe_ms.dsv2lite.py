"""Device ms of a decode step's FFN blocks (layer 0's dense SwiGLU, the others' experts: `deepseek_v2.moe`), over the window's steps."""

from benchmark.harness import blocks


def read(ctx):
    return blocks.decode_block_ms(ctx, "deepseek_v2.moe")
