"""Plain PyTorch ops of the port against `llama3np_tpu.ops.core` (CPU).

The same inputs, made with numpy from a seed, go through the JAX op and its
port; fp32 agreement at rtol 2e-4 / atol 1e-5 (sums are taken in another
order by the two frameworks).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from llama3np_tpu.ops import core as jops
from llama3np_tpu_torch.ops import core as tops

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def close(got, want):
    assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm(rng):
    x, w = normal(rng, 2, 5, 48), 1 + normal(rng, 48, scale=0.1)
    close(tops.rms_norm(t(x), t(w), 1e-5), jops.rms_norm(j(x), j(w), 1e-5))


def test_swiglu(rng):
    x = normal(rng, 2, 3, 32)
    wg, wu, wd = normal(rng, 32, 64, scale=0.1), normal(rng, 32, 64, scale=0.1), \
        normal(rng, 64, 32, scale=0.1)
    close(tops.swiglu(t(x), t(wg), t(wu), t(wd)),
          jops.swiglu(j(x), j(wg), j(wu), j(wd)))


@pytest.mark.parametrize("nh,kvh,hd", [(4, 2, 16), (3, 3, 16), (6, 1, 8)])
def test_fused_qkv(rng, nh, kvh, hd):
    d = nh * hd
    x = normal(rng, 2, 5, d)
    w = normal(rng, d, (nh + 2 * kvh) * hd, scale=0.1)
    for got, want in zip(tops.fused_qkv(t(x), t(w), nh, kvh, hd),
                         jops.fused_qkv(j(x), j(w), nh, kvh, hd)):
        close(got, want)


def test_fused_o_proj(rng):
    attn, wo = normal(rng, 2, 5, 4, 16), normal(rng, 64, 64, scale=0.1)
    close(tops.fused_o_proj(t(attn), t(wo)), jops.fused_o_proj(j(attn), j(wo)))


def test_fused_ffn(rng):
    z, wgu, wd = normal(rng, 1, 7, 48), normal(rng, 48, 192, scale=0.1), \
        normal(rng, 96, 48, scale=0.1)
    close(tops.fused_ffn(t(z), t(wgu), t(wd)), jops.fused_ffn(j(z), j(wgu), j(wd)))



# `dot_path`: the tensor-core product takes only a bf16 x bf16 or fp16 x fp16
# product with a 2-D weight on the card, outside autograd.
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("device,a,b,dim,grad,want", [
    ("cuda", BF16, BF16, 2, False, "tensor_core"),
    ("cuda", F16, F16, 2, False, "tensor_core"),
    ("cuda", F32, F32, 2, False, "widened"),           # an f32 model
    ("cuda", F32, BF16, 2, False, "widened"),          # rounding a would lose bits
    ("cuda", F32, F16, 2, False, "widened"),
    ("cuda", BF16, F32, 2, False, "widened"),
    ("cuda", BF16, F16, 2, False, "widened"),          # mixed 16-bit types
    ("cuda", BF16, torch.int8, 2, False, "widened"),   # int8 weights
    ("cuda", F32, torch.int8, 2, False, "widened"),
    ("cuda", BF16, torch.uint8, 2, False, "widened"),  # packed int4 weights
    ("cuda", BF16, BF16, 3, False, "widened"),         # per-row LoRA factors
    ("cuda", BF16, BF16, 2, True, "widened"),          # autograd records
    ("cuda", F16, F16, 2, True, "widened"),
    ("cpu", BF16, BF16, 2, False, "widened"),          # the CPU's parity path
    ("cpu", F16, F16, 2, False, "widened"),
    ("meta", BF16, BF16, 2, False, "widened"),
])
def test_dot_path(device, a, b, dim, grad, want):
    assert tops.dot_path(device, a, b, dim, grad) == want


@pytest.mark.parametrize("a_dtype,b_dtype,b_shape", [
    (F32, F32, (32, 24)), (BF16, BF16, (32, 24)), (F16, F16, (32, 24)),
    (F32, BF16, (32, 24)), (BF16, torch.int8, (32, 24)), (BF16, torch.uint8, (32, 12)),
    (BF16, BF16, (3, 32, 24)),
])
def test_dot_on_cpu_widens_and_counts(a_dtype, b_dtype, b_shape):
    """On the CPU every product is the widened f32 product, bit for bit,
    and counts as `widened`."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(3, 5, 32, generator=g).to(a_dtype)
    if b_dtype.is_floating_point:
        b = (torch.randn(*b_shape, generator=g) * 0.1).to(b_dtype)
    else:
        b = torch.randint(0, 127 if b_dtype == torch.int8 else 256, b_shape,
                          generator=g, dtype=b_dtype)
    wide = (tops.unpack_int4(b, 24, F32) if b_dtype == torch.uint8 else b.float())
    want = torch.matmul(a.float(), wide)
    before = dict(tops.dot_calls)
    got = tops._dot(a, b, 24)
    assert got.dtype == F32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tops.dot_calls == {"tensor_core": before["tensor_core"],
                              "widened": before["widened"] + 1}


def test_dot_tensor_core_branch_keeps_leading_dims(monkeypatch):
    """The tensor-core branch flattens `a` to 2-D for the GEMM and gives back
    [..., N] in f32 (on meta tensors: the CPU has no such GEMM)."""
    monkeypatch.setattr(tops, "dot_path", lambda *args: "tensor_core")
    a = torch.empty(2, 3, 4, 32, dtype=BF16, device="meta")
    b = torch.empty(32, 24, dtype=BF16, device="meta")
    before = tops.dot_calls["tensor_core"]
    out = tops._dot(a, b)
    assert out.shape == (2, 3, 4, 24) and out.dtype == F32
    assert tops.dot_calls["tensor_core"] == before + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_engine_products_would_take_tensor_cores(monkeypatch, dtype):
    """Every plain product of a 16-bit engine's greedy generation, and of
    an admission prefill and serving step, has operands that the card's
    tensor-core path takes (a 16-bit activation under a 16-bit 2-D weight,
    no autograd): none would stay widened there.  The CPU itself widens
    them all."""
    from llama3np_tpu_torch import Llama, preset, synthetic_weights
    from llama3np_tpu_torch.serving import BatchEngine

    real, on_card = tops.dot_path, []

    def spy(device_type, a_dtype, b_dtype, b_dim, grad):
        on_card.append(real("cuda", a_dtype, b_dtype, b_dim, grad))
        return real(device_type, a_dtype, b_dtype, b_dim, grad)

    args = preset("test-tiny", dtype=dtype)
    eng = Llama(synthetic_weights(args, seed=5), args, device="cpu")
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
    monkeypatch.setattr(tops, "dot_path", spy)
    before = dict(tops.dot_calls)
    eng.generate_tokens([[1, 7, 30, 41, 5]], 3)
    be.submit([1, 7, 30, 41, 5], 4, stop_ids=())
    be.submit([3, 9, 11], 4, stop_ids=())
    be.step()
    assert on_card and set(on_card) == {"tensor_core"}
    assert tops.dot_calls == {"tensor_core": before["tensor_core"],
                              "widened": before["widened"] + len(on_card)}

@pytest.mark.parametrize("scaling", [None, dict(factor=32.0, low_freq_factor=1.0,
                                                high_freq_factor=4.0,
                                                original_max_position_embeddings=64)])
def test_rope_tables(scaling):
    cos_t, sin_t = tops.rope_tables(48, 40, 10000.0, scaling=scaling, device="cpu")
    cos_j, sin_j = jops.rope_tables(48, 40, 10000.0, scaling=scaling)
    close(cos_t, cos_j)
    close(sin_t, sin_j)


def test_scale_rope_inv_freq():
    inv = 1.0 / (500000.0 ** (np.arange(0, 64, 2) / 64))
    cfg = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
               original_max_position_embeddings=8192)
    np.testing.assert_array_equal(tops.scale_rope_inv_freq(inv, cfg),
                                  jops.scale_rope_inv_freq(inv, cfg))


@pytest.mark.parametrize("split", [False, True])
def test_apply_rope(rng, split):
    x = normal(rng, 2, 6, 3, 16)
    cos, sin = jops.rope_tables(16, 6)
    fn_t = tops.apply_rope_split if split else tops.apply_rope
    fn_j = jops.apply_rope_split if split else jops.apply_rope
    close(fn_t(t(x), t(cos), t(sin)), fn_j(j(x), cos, sin))


def test_rope_split_permutation():
    for nh, hd in [(4, 16), (6, 48), (1, 2)]:
        np.testing.assert_array_equal(tops.rope_split_permutation(nh, hd),
                                      jops.rope_split_permutation(nh, hd))


@pytest.mark.parametrize("L,nh,kvh,hd", [(7, 4, 2, 16), (16, 3, 3, 16), (5, 6, 1, 8)])
def test_causal_attention(rng, L, nh, kvh, hd):
    q, k, v = normal(rng, 2, L, nh, hd), normal(rng, 2, L, kvh, hd), normal(rng, 2, L, kvh, hd)
    close(tops.causal_attention(t(q), t(k), t(v)),
          jops.causal_attention(j(q), j(k), j(v)))


@pytest.mark.parametrize("L,pos", [(1, 0), (1, 9), (4, 6), (3, 29)])
def test_cache_attention(rng, L, pos):
    q = normal(rng, 1, L, 4, 16)
    kc, vc = normal(rng, 1, 2, 32, 16), normal(rng, 1, 2, 32, 16)
    close(tops.cache_attention(t(q), t(kc), t(vc), pos),
          jops.cache_attention(j(q), j(kc), j(vc), jnp.int32(pos)))


@pytest.mark.parametrize("L,T,pos,blk", [(16, 16, 0, 8), (8, 32, 10, 8), (4, 24, 20, 12)])
def test_blockwise_causal_attention(rng, L, T, pos, blk):
    q = normal(rng, 2, L, 4, 16)
    k, v = normal(rng, 2, T, 2, 16), normal(rng, 2, T, 2, 16)
    close(tops.blockwise_causal_attention(t(q), t(k), t(v), pos, blk),
          jops.blockwise_causal_attention(j(q), j(k), j(v), jnp.int32(pos), blk))


def test_update_kv_cache(rng):
    kc, vc = normal(rng, 2, 2, 16, 8), normal(rng, 2, 2, 16, 8)
    k, v = normal(rng, 2, 3, 2, 8), normal(rng, 2, 3, 2, 8)
    want_k, want_v = jops.update_kv_cache(j(kc), j(vc), j(k), j(v), jnp.int32(5))
    tk, tv = t(kc.copy()), t(vc.copy())
    got_k, got_v = tops.update_kv_cache(tk, tv, t(k), t(v), 5)
    assert got_k is tk and got_v is tv  # updated in place
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
