"""What the readers of a model's block timer compute: device time of its
attention and expert blocks in decode steps, from the event pairs the
program records around each block call when the engine has a timer
(`llama3np_tpu_torch.models.deepseek_v2.BlockTimer`, turned on in traced
runs by the model family, which keeps it on the harness as
`block_timer`).  A program without the timer leaves nothing to read."""

from __future__ import annotations

from typing import Optional


def decode_block_ms(ctx, name: str) -> Optional[float]:
    """Device ms of the blocks called `name`, summed over a decode step:
    their decode-phase calls issued inside the window over the decode
    steps begun inside it."""
    timer = getattr(ctx, "block_timer", None)
    w = ctx.window
    if timer is None or "t0" not in w:
        return None
    t0, t1 = w["t0"], w["t1"]
    steps = sum(t0 <= t <= t1 for t in timer.steps)
    if not steps:
        return None
    total = sum(timer.ms(start, end) for t, block, phase, start, end in timer.records
                if block == name and phase == "decode" and t0 <= t <= t1)
    return total / steps
