"""Operation and byte counts against shapes worked by hand."""

import json
import os

import pytest

from benchmark.harness import roofline

from .conftest import BENCH, LLAMA


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return LLAMA.dims(json.load(f))


def test_mistral_product_weights():
    dm = config("mistral-7b-v0.3")
    # q 4096x4096, k and v 4096x1024 each, o 4096x4096, gate/up/down 4096x14336
    layer = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096 + 3 * 4096 * 14336
    assert LLAMA.layer_product_params(dm) == layer == 218_103_808
    assert LLAMA.product_params(dm) == 32 * layer + 4096 * 32768 == 7_113_539_584


def test_deepseek_product_weights():
    dm = config("deepseek-llm-7b")
    layer = 4 * 4096 * 4096 + 3 * 4096 * 11008  # MHA: k and v are 4096 wide
    assert LLAMA.layer_product_params(dm) == layer
    assert LLAMA.product_params(dm) == 30 * layer + 4096 * 102400 == 6_490_685_440


def test_token_and_prefill_flops():
    dm = config("mistral-7b-v0.3")
    P, head = LLAMA.product_params(dm), 4096 * 32768
    assert LLAMA.token_flops(dm, 1) == 2 * P + 4 * 32 * 4096
    assert LLAMA.decode_flops(dm, [10, 20]) == 4 * P + 4 * 32 * 4096 * 30
    # a prompt of 3: tokens at ctx 1, 2, 3, the head once
    want = sum(LLAMA.token_flops(dm, c) for c in (1, 2, 3)) - 2 * 2 * head
    assert LLAMA.prefill_flops(dm, 3) == pytest.approx(want)


def test_decode_layers_bytes():
    dm = config("mistral-7b-v0.3")
    weights = 32 * (218_103_808 + 2 * 4096) * 2  # bf16, with both norms
    row = 32 * 2 * 1024 * 2  # K and V of one position, every layer
    assert LLAMA.decode_layers_bytes(dm, 0) == weights + 2 * row
    assert LLAMA.decode_layers_bytes(dm, 511) == weights + 513 * row
    assert LLAMA.decode_layers_bytes(dm, 511) / roofline.HBM_BYTES_S == pytest.approx(
        4.187e-3, rel=0.01)  # llama3-8b's layers, the kernel table's bound at pos 511


def test_paged_attention_bytes():
    dm = config("deepseek-llm-7b")
    kv = 32 * 128 * 2  # one position's K (or V) in bf16, MHA
    want = 30 * ((100 + 3000) * 2 * kv + 2 * 2 * 4096 * 2)
    assert LLAMA.paged_attention_bytes(dm, [100, 3000]) == want
    assert kv * 2 * 30 / 1024 == 480  # KiB of KV a token
    assert LLAMA.paged_attention_flops(dm, [100, 3000]) == 4 * 30 * 4096 * 3100


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 67e12, roofline.FP32_FLOP_S) == pytest.approx(1.0)
