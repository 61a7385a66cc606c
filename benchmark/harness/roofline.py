"""Published peaks of one NVIDIA H100 SXM, and the least time a piece of
work can take on it.  A model's operations and bytes are its family's
counts (`benchmark/families/<family>.py`).

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): 3.35 TB/s of HBM,
989 TFLOP/s in bf16 and fp16 on the tensor cores, 67 TFLOP/s in float32
outside them.  A bound counts each input byte read once and each output
byte written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S) -> float:
    """The least time the work can take on the card."""
    return max(nbytes / HBM_BYTES_S, flops / flop_s)
