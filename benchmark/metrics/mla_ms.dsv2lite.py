"""Device ms of a decode step's latent-attention blocks (every layer's `deepseek_v2.mla`), over the window's steps."""

from benchmark.harness import blocks


def read(ctx):
    return blocks.decode_block_ms(ctx, "deepseek_v2.mla")
