"""Published peaks of one NVIDIA H100 SXM, and the operations and bytes of
the work the cells run, counted from shapes and positions.

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): 3.35 TB/s of HBM,
989 TFLOP/s in bf16 and fp16 on the tensor cores, 67 TFLOP/s in float32
outside them.  A bound counts each input byte read once and each output
byte written once.

Model FLOPs of one token at context `ctx` (the positions it attends,
itself included): 2 x every weight a token multiplies in a product (all
but the embedding and the norms) + 4 x ctx x (heads x head_dim) in each
layer's attention (QK^T and PV).  A prompt of L tokens counts token i at
ctx i + 1, and the head once (for the last); padding counts nothing.
"""

from __future__ import annotations

from typing import Iterable

from .weights import Dims

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_product_params(dm: Dims) -> int:
    return dm.d * (dm.qd + 2 * dm.kvd) + dm.qd * dm.d + 3 * dm.d * dm.fd


def product_params(dm: Dims) -> int:
    """Weights a token multiplies: every layer's products and the head."""
    return dm.nl * layer_product_params(dm) + dm.d * dm.vs


def token_flops(dm: Dims, ctx: int) -> float:
    return 2.0 * product_params(dm) + 4.0 * dm.nl * ctx * dm.qd


def decode_flops(dm: Dims, ctxs: Iterable[int]) -> float:
    ctxs = list(ctxs)
    return 2.0 * product_params(dm) * len(ctxs) + 4.0 * dm.nl * dm.qd * sum(ctxs)


def prefill_flops(dm: Dims, L: int) -> float:
    """Tokens at ctx 1..L; only the last goes through the head."""
    layers = dm.nl * layer_product_params(dm)
    return 2.0 * (layers * L + dm.d * dm.vs) + 4.0 * dm.nl * dm.qd * L * (L + 1) / 2


def decode_layers_bytes(dm: Dims, pos: int) -> float:
    """The fused decode kernel, one token at position `pos`: every layer's
    weights and norms, the cache rows 0..pos (K and V) read, the new row
    written."""
    e = ELEM[dm.dtype]
    weights = dm.nl * (layer_product_params(dm) + 2 * dm.d) * e
    row = dm.nl * 2 * dm.kvd * e
    return weights + (pos + 1) * row + row


def paged_attention_bytes(dm: Dims, ctxs: Iterable[int]) -> float:
    """One paged-attention call per layer over a batch whose row b attends
    ctxs[b] positions (its pooled rows and the current one): K and V of
    those, q read and the output written once."""
    e = ELEM[dm.dtype]
    ctxs = list(ctxs)
    per_layer = sum(ctxs) * 2 * dm.kvd * e + len(ctxs) * 2 * dm.qd * e
    return dm.nl * per_layer


def bound_s(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S) -> float:
    """The least time the work can take on the card."""
    return max(nbytes / HBM_BYTES_S, flops / flop_s)
