"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device is present
(the check runs inside the fixture, never at import).  The file imports
only torch and the port, so it needs no JAX and runs on the card as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from llama3np_tpu_torch import Llama, preset, synthetic_weights
from llama3np_tpu_torch.ops.core import (_dot, _widened_dot, dot_calls,
                                         quantize_kv_rows)
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)
from llama3np_tpu_torch.ops.kernels.flash_prefill import (flash_prefill,
                                                          flash_prefill_plain)
from llama3np_tpu_torch.ops.kernels.greedy_head import (argmax_head,
                                                        argmax_head_plain, head_plan)
from llama3np_tpu_torch.ops.kernels.paged_attention import (
    chunk_pages, paged_attention, paged_attention_plain)
from llama3np_tpu_torch.serving import BatchEngine

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,NH,KVH,HD", [
    (2, 32, 4, 2, 16), (1, 100, 6, 6, 48), (1, 37, 3, 1, 8), (1, 70, 2, 2, 128),
    (1, 1, 4, 4, 64),
    (2, 300, 4, 2, 10),   # 64-row tiles on CUDA cores: HD % 4 != 0, 4-byte copies
    (2, 300, 4, 2, 36),   # the 3-piece split with HD padded to 48
])
def test_flash_prefill_kernel_matches_plain(cuda, B, L, NH, KVH, HD):
    g = torch.Generator().manual_seed(L)
    q = torch.randn(B, L, NH, HD, generator=g).to(cuda)
    k = torch.randn(B, L, KVH, HD, generator=g).to(cuda)
    v = torch.randn(B, L, KVH, HD, generator=g).to(cuda)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    torch.testing.assert_close(got, flash_prefill_plain(q, k, v), rtol=1e-4, atol=1e-5)


# bf16 kernels against their plain twins (f32 math on the same bf16
# inputs): the outputs are rounded to bf16 once, so they agree to about two
# bf16 ulps (2^-8 relative each); the decode step rounds at many points
# over its layers.
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("B,L,NH,KVH,HD", [
    (2, 32, 4, 2, 16), (1, 100, 6, 6, 48), (1, 70, 8, 2, 128), (1, 1, 4, 4, 64),
    # llama3-8b heads: one row, a ragged tile, a ragged and a full prompt
    (1, 1, 32, 8, 128), (1, 65, 32, 8, 128), (1, 500, 32, 8, 128), (1, 512, 32, 8, 128),
    # head dims padded in shared memory: 8 -> 16 (16-byte copies), 20 -> 32 (4-byte)
    (2, 33, 4, 2, 8), (1, 77, 4, 1, 20),
])
def test_flash_prefill_bf16_kernel_matches_plain(cuda, B, L, NH, KVH, HD):
    g = torch.Generator().manual_seed(L + 1)
    q, k, v = (torch.randn(B, L, h, HD, generator=g).to(cuda, torch.bfloat16)
               for h in (NH, KVH, KVH))
    before = flash_prefill.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), flash_prefill_plain(q, k, v).float(),
                               **BF16_TOL)


# float16 kernels against their twins: one rounding of an f32 result, two
# float16 ulps (2^-11 relative each).
F16_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,L,NH,KVH,HD", [
    (2, 32, 4, 2, 16), (1, 100, 6, 6, 48), (1, 70, 8, 2, 128), (1, 1, 4, 4, 64),
    (1, 65, 32, 8, 128), (1, 512, 32, 8, 128), (1, 500, 32, 4, 64),
    (2, 33, 4, 2, 8), (1, 77, 4, 1, 20),
])
def test_flash_prefill_f16_kernel_matches_plain(cuda, B, L, NH, KVH, HD):
    """float16 q, k, v on the tensor cores (float16 operands, P as a hi + lo
    float16 pair) against the twin's f32 math rounded once."""
    g = torch.Generator().manual_seed(L + 2)
    q, k, v = (torch.randn(B, L, h, HD, generator=g).to(cuda, torch.float16)
               for h in (NH, KVH, KVH))
    before = flash_prefill.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1 and got.dtype == torch.float16
    torch.testing.assert_close(got.float(), flash_prefill_plain(q, k, v).float(),
                               **F16_TOL)


def test_flash_prefill_kernel_refuses_unported_dtypes(cuda):
    """Mixed dtypes: no kernel mode takes them."""
    q = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="all float32, all bf16"):
        flash_prefill(q, q.to(torch.bfloat16), q)
    b = q.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="all float32, all bf16"):
        flash_prefill(b, b.float(), b.float())


def _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8, dtype=torch.float32):
    """A fused whole-layer tree of random weights: float32 (or `dtype`,
    norms too), or int8 with positive per-column scales."""
    hd = d // nh

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(cuda)

    shapes = {"wqkv": (d, (nh + 2 * kvh) * hd), "wo": (nh * hd, d),
              "wgu": (d, 2 * fd), "w_down": (fd, d)}
    layers = {"attn_norm": 1 + rnd(nl, 1, d, scale=0.05),
              "ffn_norm": 1 + rnd(nl, 1, d, scale=0.05)}
    for name, (k, n) in shapes.items():
        if int8:
            w = torch.randint(-127, 128, (nl, k, n), generator=g, dtype=torch.int8)
            layers[name] = w.to(cuda)
            layers[name + "_scale"] = (0.05 / 127) * (0.5 + torch.rand(
                nl, 1, n, generator=g)).to(cuda)
        else:
            layers[name] = rnd(nl, k, n, scale=0.05)
    if dtype != torch.float32:  # int8 payloads and their f32 scales stay
        layers = {k: v if v.dtype == torch.int8 or k.endswith("_scale") else v.to(dtype)
                  for k, v in layers.items()}
    return layers


@pytest.mark.parametrize("pos", [0, 5, 63])
@pytest.mark.parametrize("d,nh,kvh,fd", [(64, 4, 2, 128), (256, 2, 1, 512), (48, 3, 3, 96)])
def test_decode_layers_bf16_kernel_matches_plain(cuda, pos, d, nh, kvh, fd):
    """bf16 weights, norms, x and caches; HD = 32, 128 and 16."""
    nl, M = 2, 64
    hd = d // nh
    g = torch.Generator().manual_seed(pos + d)
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, False, torch.bfloat16)
    kc, vc = (torch.randn(nl, kvh, M, hd, generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    x = torch.randn(1, d, generator=g).to(cuda, torch.bfloat16)
    ang = torch.rand(1, hd // 2, generator=g).to(cuda) * pos
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_layers.launches
    got, _, _ = decode_layers(layers, x, pos, k1, v1, ang.cos(), ang.sin(), **kw)
    torch.cuda.synchronize()
    assert decode_layers.launches == before + 1 and got.dtype == torch.bfloat16
    want, _, _ = decode_layers_plain(layers, x, pos, k2, v2, ang.cos(), ang.sin(), **kw)
    tol = dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(k1.float(), k2.float(), **tol)
    torch.testing.assert_close(v1.float(), v2.float(), **tol)
    others = torch.arange(M, device=cuda) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])


def test_decode_layers_kernel_refuses_unported_modes(cuda):
    """int8 weights under bf16 activations run (the int8/bf16 mode, against
    its twin); widths that are not whole 8-weight bf16 vectors are refused."""
    g = torch.Generator().manual_seed(3)
    nl, d, nh, kvh, fd, M = 1, 64, 4, 2, 128, 8
    hd = d // nh
    row = torch.zeros(1, hd // 2, device=cuda)
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    q8 = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, True, torch.bfloat16)
    kc = torch.randn(nl, kvh, M, hd, generator=g).to(cuda, torch.bfloat16)
    x = torch.randn(1, d, generator=g).to(cuda, torch.bfloat16)
    before = decode_layers.launches
    got = decode_layers(q8, x, 1, kc.clone(), kc.clone(), row, row, **kw)[0]
    torch.cuda.synchronize()
    assert decode_layers.launches == before + 1 and got.dtype == torch.bfloat16
    want = decode_layers_plain(q8, x, 1, kc.clone(), kc.clone(), row, row, **kw)[0]
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    d, nh, kvh, fd = 36, 3, 3, 84  # HD=12: QKV width 108, not a multiple of 8
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, False, torch.bfloat16)
    kc = torch.zeros(nl, kvh, M, d // nh, device=cuda, dtype=torch.bfloat16)
    row = torch.zeros(1, d // nh // 2, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        decode_layers(layers, torch.zeros(1, d, device=cuda, dtype=torch.bfloat16), 1,
                      kc, kc.clone(), row, row, n_heads=nh, kv_heads=kvh,
                      head_dim=d // nh, norm_eps=1e-5)


# The decode modes: (weights int8?, activation dtype).
DECODE_MODES = {"fp32": (False, torch.float32), "int8": (True, torch.float32),
                "bf16": (False, torch.bfloat16), "int8-bf16": (True, torch.bfloat16),
                "fp16": (False, torch.float16), "int8-fp16": (True, torch.float16)}


def _decode_call(cuda, mode, nl, d, nh, kvh, fd, M, pos, seed):
    """A decode_layers call of `mode` on seeded inputs: (layers, x, caches,
    cos, sin, kw)."""
    int8, dt = DECODE_MODES[mode]
    g = torch.Generator().manual_seed(seed)
    hd = d // nh
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8, dt)
    kc, vc = (torch.randn(nl, kvh, M, hd, generator=g).to(cuda, dt) for _ in range(2))
    x = torch.randn(1, d, generator=g).to(cuda, dt)
    ang = torch.rand(1, hd // 2, generator=g).to(cuda) * pos
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    return layers, x, kc, vc, ang.cos(), ang.sin(), kw


@pytest.mark.parametrize("pos", [0, 40, 127])
@pytest.mark.parametrize("d,nh,kvh,fd", [(256, 8, 2, 512), (768, 6, 2, 2048), (96, 3, 3, 160)])
def test_decode_layers_int8_bf16_kernel_matches_plain(cuda, pos, d, nh, kvh, fd):
    """int8 weights under bf16 activations (tensor cores) against the twin
    at pos 0 / mid / M-1: output and new rows within the bf16 tolerance
    (3e-2), other cache rows untouched; widths that leave a partial
    512-column tile and many row splits."""
    nl, M = 2, 128
    layers, x, kc, vc, cos, sin, kw = _decode_call(cuda, "int8-bf16", nl, d, nh, kvh, fd,
                                                   M, pos, seed=pos + d)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)[0]
    torch.cuda.synchronize()
    want = decode_layers_plain(layers, x, pos, k2, v2, cos, sin, **kw)[0]
    assert got.dtype == torch.bfloat16
    tol = dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(k1[:, :, pos].float(), k2[:, :, pos].float(), **tol)
    torch.testing.assert_close(v1[:, :, pos].float(), v2[:, :, pos].float(), **tol)
    others = torch.arange(M, device=cuda) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])
    assert torch.equal(v1[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("mode", ["fp16", "int8-fp16"])
@pytest.mark.parametrize("pos", [0, 40, 127])
@pytest.mark.parametrize("d,nh,kvh,fd", [(256, 8, 2, 512), (768, 6, 2, 2048), (64, 4, 2, 128)])
def test_decode_layers_f16_kernel_matches_plain(cuda, mode, pos, d, nh, kvh, fd):
    """float16 weights, and int8 weights under float16 activations (the
    activation rounded to bf16 for the int8 products, float16 norms, caches
    and residual), against the twin at pos 0 / mid / M-1; HD = 32, 128 and
    16: output and new rows within 3e-2, other cache rows untouched."""
    nl, M = 2, 128
    layers, x, kc, vc, cos, sin, kw = _decode_call(cuda, mode, nl, d, nh, kvh, fd, M, pos,
                                                   seed=pos + d + 1)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_layers.launches
    got = decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)[0]
    torch.cuda.synchronize()
    assert decode_layers.launches == before + 1 and got.dtype == torch.float16
    want = decode_layers_plain(layers, x, pos, k2, v2, cos, sin, **kw)[0]
    tol = dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(k1[:, :, pos].float(), k2[:, :, pos].float(), **tol)
    torch.testing.assert_close(v1[:, :, pos].float(), v2[:, :, pos].float(), **tol)
    others = torch.arange(M, device=cuda) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])
    assert torch.equal(v1[:, :, others], vc[:, :, others])


@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_decode_layers_kernel_is_deterministic(cuda, mode):
    """Two runs on the same inputs give the same bits in every mode: the
    split-K tiles and attention's splits are summed in split order by the
    last block to arrive, whichever block that is (pos 700: 44 position
    splits)."""
    layers, x, kc, vc, cos, sin, kw = _decode_call(cuda, mode, 2, 512, 8, 2, 1024, 1024,
                                                   700, seed=11)
    outs = []
    for _ in range(2):
        k1, v1 = kc.clone(), vc.clone()
        outs.append((decode_layers(layers, x, 700, k1, v1, cos, sin, **kw)[0], k1, v1))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_decode_layers_kernel_after_other_shapes(cuda, mode):
    """A call after calls at another pos and other widths (other tiles,
    splits and position splits) matches its twin: no arrival counter or
    scratch of an earlier call survives into the next."""
    tol = (dict(rtol=1e-4, atol=1e-4) if DECODE_MODES[mode][1] == torch.float32
           else dict(rtol=3e-2, atol=3e-2))
    for d, nh, kvh, fd, M, pos in ((512, 8, 2, 1024, 512, 300), (256, 4, 4, 768, 64, 63),
                                   (512, 8, 2, 1024, 512, 17)):
        layers, x, kc, vc, cos, sin, kw = _decode_call(cuda, mode, 2, d, nh, kvh, fd, M,
                                                       pos, seed=pos)
        got = decode_layers(layers, x, pos, kc.clone(), vc.clone(), cos, sin, **kw)[0]
        torch.cuda.synchronize()
        want = decode_layers_plain(layers, x, pos, kc.clone(), vc.clone(), cos, sin, **kw)[0]
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,VS", [(288, 32000), (2048, 32000), (4096, 128256), (64, 1000)])
def test_argmax_head_kernel_matches_plain(cuda, dtype, D, VS):
    """Exact tokens on random rows, a tie planted across a block boundary
    (256 bf16 / float16 or 128 f32 columns a block: the lower column wins),
    and a vocab that leaves a partial last block."""
    g = torch.Generator(cuda).manual_seed(D)  # made on the card: 0.5 G weights
    w = (torch.randn(D, VS, generator=g, device=cuda) * 0.02).to(dtype)
    before = argmax_head.launches
    for _ in range(4):
        x = torch.randn(1, D, generator=g, device=cuda).to(dtype)
        got = argmax_head(x, w)
        assert got.dtype == torch.int64 and int(got[0]) == int(argmax_head_plain(x, w)[0])
    assert argmax_head.launches == before + 4
    cols = 32 * 16 // w.element_size()
    tied = w.clone()
    for c in (cols - 1, cols):  # the last column of block 0, the first of block 1
        tied[:, c] = 0
        tied[0, c] = 8.0
    x[0, 0] = 4.0  # both tied columns sum to exactly 32
    assert int(argmax_head(x, tied)[0]) == cols - 1 == int(argmax_head_plain(x, tied)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,VS", [(2048, 32000), (4096, 128256), (1000, 32000),
                                  (288, 128), (2100, 256)])
def test_argmax_head_kernel_splits_and_strips(cuda, dtype, D, VS):
    """The one-launch head on its grid of (strips x D splits): D not a
    multiple of a split (1000, 2100), one strip (VS = 128 or 256 stands for
    the strip of the dtype), 32,000 and 128,256; ties planted in one strip,
    across the split boundary (the lower column's sum from split 1, the
    higher's from split 0) and across a strip boundary: the lower column
    wins; two calls in a row on one stream (the tickets reset) give the
    same token."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cols = head_plan(D, VS, dtype.itemsize, sms)[0]
    VS = cols if VS in (128, 256) else VS
    cols, strips, rows, splits = head_plan(D, VS, dtype.itemsize, sms)
    g = torch.Generator(cuda).manual_seed(D + VS)
    w = (torch.randn(D, VS, generator=g, device=cuda) * 0.02).to(dtype)
    for _ in range(3):
        x = torch.randn(1, D, generator=g, device=cuda).to(dtype)
        first, second = argmax_head(x, w)[0].item(), argmax_head(x, w)[0].item()
        assert first == second == int(argmax_head_plain(x, w)[0])
    ties = [(7, 7, 3, 40)]  # (row of the lower column's 8, of the higher's, columns)
    if splits > 1:
        ties.append((rows + 5, 7, 3, 40))
    if strips > 1:
        ties.append((7, 7, cols - 1, cols))
    for r_lo, r_hi, lo, hi in ties:
        tied, xt = w.clone(), x.clone()
        tied[:, [lo, hi]] = 0
        tied[r_lo, lo] = 8.0
        tied[r_hi, hi] = 8.0
        xt[0, r_lo] = 4.0  # both columns sum to exactly 32
        xt[0, r_hi] = 4.0
        assert int(argmax_head_plain(xt, tied)[0]) == lo
        assert int(argmax_head(xt, tied)[0]) == lo == int(argmax_head(xt, tied)[0])


def test_flash_prefill_f32_unaligned_rows(cuda):
    """q, k, v and o rows off 16-byte alignment (views one float into their
    buffers): the kernel takes 4-byte copies and CUDA cores, and still
    matches the twin."""
    g = torch.Generator().manual_seed(4)
    bufs = [torch.randn(1 + 512 * h * 64, generator=g).to(cuda) for h in (8, 2, 2)]
    q, k, v = (b[1:].view(1, 512, h, 64) for b, h in zip(bufs, (8, 2, 2)))
    assert q.data_ptr() % 16 and q.is_contiguous()
    torch.testing.assert_close(flash_prefill(q, k, v), flash_prefill_plain(q, k, v),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("HD", [48, 64, 128])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 63, 64, 65, 100, 200, 256, 512])
def test_flash_prefill_f32_tiles_and_pieces(cuda, L, HD):
    """The float32 kernel at its tile-height boundaries (16-row tiles to
    L = 128, 64-row ones beyond: on tensor cores, the 3-piece split, where
    HD <= 64) and with key pieces merged (L = 256, 512), GQA, against the
    twin; twice, bit-equal (the merge runs in piece order, the tickets
    reset)."""
    g = torch.Generator().manual_seed(L * HD)
    q = torch.randn(1, L, 8, HD, generator=g).to(cuda)
    k = torch.randn(1, L, 2, HD, generator=g).to(cuda)
    v = torch.randn(1, L, 2, HD, generator=g).to(cuda)
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_prefill_plain(q, k, v), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, flash_prefill(q, k, v))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 63])
def test_decode_layers_kernel_matches_plain(cuda, pos, int8):
    nl, d, nh, kvh, fd, M = 2, 64, 4, 2, 128, 64
    hd = d // nh
    g = torch.Generator().manual_seed(pos)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(cuda)

    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8)
    kc, vc, x = rnd(nl, kvh, M, hd), rnd(nl, kvh, M, hd), rnd(1, d)
    ang = rnd(1, hd // 2)
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_layers.launches
    got, _, _ = decode_layers(layers, x, pos, k1, v1, ang.cos(), ang.sin(), **kw)
    torch.cuda.synchronize()
    assert decode_layers.launches == before + 1
    want, _, _ = decode_layers_plain(layers, x, pos, k2, v2, ang.cos(), ang.sin(), **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k1, k2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(v1, v2, rtol=1e-4, atol=1e-4)
    others = torch.arange(M, device=cuda) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])


@pytest.mark.parametrize("d,nh,kvh,fd", [(48, 3, 3, 96), (288, 6, 6, 768),
                                         (640, 10, 2, 1280)])
def test_decode_layers_int8_kernel_widths(cuda, d, nh, kvh, fd):
    """Output widths that leave a partial 512-column block (144, 48, 864,
    288, 1536, 960 columns) and many row splits."""
    g = torch.Generator().manual_seed(d)
    nl, M, pos = 2, 96, 77
    hd = d // nh
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8=True)
    kc = torch.randn(nl, kvh, M, hd, generator=g).to(cuda)
    vc = torch.randn(nl, kvh, M, hd, generator=g).to(cuda)
    x = torch.randn(1, d, generator=g).to(cuda)
    ang = torch.rand(1, hd // 2, generator=g).to(cuda) * pos
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    got, _, _ = decode_layers(layers, x, pos, kc.clone(), vc.clone(), ang.cos(),
                              ang.sin(), **kw)
    want, _, _ = decode_layers_plain(layers, x, pos, kc.clone(), vc.clone(),
                                     ang.cos(), ang.sin(), **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_decode_layers_int8_kernel_refuses_widths(cuda):
    """One lane reads 16 int8 weights: widths must be multiples of 16."""
    g = torch.Generator().manual_seed(0)
    nl, d, nh, kvh, fd, M = 1, 40, 2, 2, 84, 8
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8=True)
    kc = torch.zeros(nl, kvh, M, d // nh, device=cuda)
    row = torch.zeros(1, d // nh // 2, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        decode_layers(layers, torch.zeros(1, d, device=cuda), 1, kc, kc.clone(),
                      row, row, n_heads=nh, kv_heads=kvh, head_dim=d // nh,
                      norm_eps=1e-5)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_card_engine_matches_cpu_engine(cuda, name, quant):
    args = preset(name, quant=quant)
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    on_card = Llama(w, args, device=cuda)
    before = flash_prefill.launches, decode_layers.launches
    got = on_card.generate_tokens(ids, 12).cpu()
    assert flash_prefill.launches == before[0] + args.n_layers
    assert decode_layers.launches == before[1] + 11
    want = Llama(w, args, device="cpu").generate_tokens(ids, 12)
    assert got.tolist() == want.tolist()


def _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed):
    """Pools with shuffled block tables and null-page padding; row 0 overran
    its table (pos past maxp*page), the others are ragged."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=g).to(cuda)

    P = 1 + B * maxp
    perm = torch.randperm(P - 1, generator=g)[: B * maxp] + 1
    bt = perm.reshape(B, maxp).to(torch.int32)
    pos = torch.randint(0, maxp * page, (B,), generator=g, dtype=torch.int32)
    pos[0] = maxp * page + 5
    pos[1] = 0
    for b in range(1, B):  # unused entries -> null page 0
        bt[b, int(pos[b]) // page + 1 :] = 0
    return dict(q=rnd(B, 1, NH, HD), kp=rnd(NL, P, KVH, page, HD),
                vp=rnd(NL, P, KVH, page, HD), bt=bt.to(cuda), pos=pos.to(cuda),
                ck=rnd(B, KVH, HD), cv=rnd(B, KVH, HD),
                wk=rnd(B, KVH, Q, HD), wv=rnd(B, KVH, Q, HD))


@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("NH,KVH,HD", [(6, 6, 48), (8, 2, 64), (4, 1, 128)])
def test_paged_attention_kernel_matches_plain(cuda, mode, NH, KVH, HD):
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD)
    if mode == "plain":
        args = (a["q"], a["kp"][1].contiguous(), a["vp"][1].contiguous(), a["bt"], a["pos"])
        kw = {}
    else:
        args = (a["q"], a["kp"], a["vp"], a["bt"], a["pos"])
        kw = dict(layer=1, cur_k=a["ck"], cur_v=a["cv"])
        if mode.startswith("window"):
            kw.update(win_k=a["wk"], win_v=a["wv"], win_count=int(mode[-1]))
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert torch.isfinite(got).all()
    want = paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got[1:], want[1:], rtol=1e-4, atol=1e-5)
    # The overrun row attends its whole table, as the gather oracle does.
    torch.testing.assert_close(got[:1], want[:1], rtol=1e-4, atol=1e-5)


def test_paged_attention_kernel_ignores_masked_garbage(cuda):
    """Non-finite values behind the mask (the tail of a row's last page,
    the null page, unwritten window columns) must not reach the output."""
    B, NH, KVH, HD, page, maxp = 3, 8, 2, 64, 16, 4
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, 2, 4, seed=1)
    pos = torch.tensor([5, 17, 40], dtype=torch.int32, device=cuda)
    bt = torch.arange(1, 1 + B * maxp, dtype=torch.int32, device=cuda).reshape(B, maxp)
    bt[:, 3:] = 0
    clean = paged_attention(a["q"], a["kp"], a["vp"], bt, pos, layer=0,
                            cur_k=a["ck"], cur_v=a["cv"], win_k=a["wk"],
                            win_v=a["wv"], win_count=2)
    kp, vp, wk, wv = a["kp"].clone(), a["vp"].clone(), a["wk"].clone(), a["wv"].clone()
    kp[:, 0] = float("nan")
    vp[:, 0] = float("inf")
    for b, p in enumerate(pos.tolist()):  # slots >= pos of the row's pages
        for t in range(p, 3 * page):
            pid = int(bt[b, t // page])
            kp[0, pid, :, t % page] = float("nan")
            vp[0, pid, :, t % page] = float("nan")
    wk[:, :, 2:] = float("nan")
    wv[:, :, 2:] = float("inf")
    got = paged_attention(a["q"], kp, vp, bt, pos, layer=0, cur_k=a["ck"],
                          cur_v=a["cv"], win_k=wk, win_v=wv, win_count=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


def test_paged_attention_bf16_kernel_ignores_masked_garbage(cuda):
    """bf16 pools: non-finite values behind the mask (the tails of the rows'
    last pages, the null page, unwritten window columns) must not reach the
    output; the tensor-core form multiplies whole 16-token steps, so the
    slots past a tile's visible prefix must count as zeros."""
    B, NH, KVH, HD, page, maxp = 3, 8, 2, 64, 16, 4
    a = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in
         _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, 2, 4, seed=3).items()}
    pos = torch.tensor([5, 17, 40], dtype=torch.int32, device=cuda)
    bt = torch.arange(1, 1 + B * maxp, dtype=torch.int32, device=cuda).reshape(B, maxp)
    bt[:, 3:] = 0
    kw = dict(layer=0, cur_k=a["ck"], cur_v=a["cv"], win_count=2)
    clean = paged_attention(a["q"], a["kp"], a["vp"], bt, pos, win_k=a["wk"],
                            win_v=a["wv"], **kw)
    kp, vp, wk, wv = a["kp"].clone(), a["vp"].clone(), a["wk"].clone(), a["wv"].clone()
    kp[:, 0], vp[:, 0] = float("nan"), float("inf")
    for b, p in enumerate(pos.tolist()):  # slots >= pos of the row's pages
        for t in range(p, 3 * page):
            pid = int(bt[b, t // page])
            kp[0, pid, :, t % page] = float("nan")
            vp[0, pid, :, t % page] = float("nan")
    wk[:, :, 2:], wv[:, :, 2:] = float("nan"), float("inf")
    got = paged_attention(a["q"], kp, vp, bt, pos, win_k=wk, win_v=wv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


def _int8_pools(a, layer=None):
    """The fp32 inputs of `_paged_inputs` quantized per (token, KV head):
    (args, kwargs) of a stacked (or, with layer None, plain) int8 call."""
    k8, ks = quantize_kv_rows(a["kp"])
    v8, vs = quantize_kv_rows(a["vp"])
    ck8, cks = quantize_kv_rows(a["ck"])
    cv8, cvs = quantize_kv_rows(a["cv"])
    wk8, wks = quantize_kv_rows(a["wk"])
    wv8, wvs = quantize_kv_rows(a["wv"])
    if layer is None:
        return ((a["q"], k8[1].contiguous(), v8[1].contiguous(), a["bt"], a["pos"]),
                dict(k_scale=ks[1].contiguous(), v_scale=vs[1].contiguous()))
    return ((a["q"], k8, v8, a["bt"], a["pos"]),
            dict(k_scale=ks, v_scale=vs, layer=layer, cur_k=ck8, cur_v=cv8,
                 cur_ks=cks, cur_vs=cvs, win_k=wk8, win_v=wv8, win_ks=wks,
                 win_vs=wvs))


@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("NH,KVH,HD", [(6, 6, 48), (8, 2, 64), (4, 1, 128), (4, 2, 20)])
def test_paged_attention_int8_kernel_matches_plain(cuda, mode, NH, KVH, HD):
    """int8 pools with scales in the three modes; HD=20 takes the 4-byte
    loads, the others 16-byte loads."""
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD + 1)
    args, kw = _int8_pools(a, None if mode == "plain" else 1)
    if mode == "stacked":
        for name in ("win_k", "win_v", "win_ks", "win_vs"):
            kw.pop(name)
    elif mode != "plain":
        kw["win_count"] = int(mode[-1])
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, paged_attention_plain(*args, **kw),
                               rtol=1e-4, atol=1e-5)


def test_paged_attention_int8_kernel_ignores_masked_scales(cuda):
    """NaN/inf in the scale slots of masked positions (the null page, the
    tails of the rows' last pages, unwritten window columns) and garbage
    int8 values there must not reach the output."""
    B, NH, KVH, HD, page, maxp = 3, 8, 2, 64, 16, 4
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, 2, 4, seed=2)
    pos = torch.tensor([5, 17, 40], dtype=torch.int32, device=cuda)
    bt = torch.arange(1, 1 + B * maxp, dtype=torch.int32, device=cuda).reshape(B, maxp)
    bt[:, 3:] = 0
    args, kw = _int8_pools(a, layer=0)
    args = (args[0], args[1], args[2], bt, pos)
    kw["win_count"] = 2
    clean = paged_attention(*args, **kw)
    k8, v8 = args[1].clone(), args[2].clone()
    ks, vs = kw["k_scale"].clone(), kw["v_scale"].clone()
    ks[:, 0], vs[:, 0], k8[:, 0], v8[:, 0] = float("nan"), float("inf"), 127, -128
    for b, p in enumerate(pos.tolist()):  # slots >= pos of the row's pages
        for t in range(p, 3 * page):
            pid = int(bt[b, t // page])
            ks[0, pid, :, t % page] = float("nan")
            vs[0, pid, :, t % page] = float("inf")
            v8[0, pid, :, t % page] = 99
    wks, wvs = kw["win_ks"].clone(), kw["win_vs"].clone()
    wks[:, :, 2:], wvs[:, :, 2:] = float("nan"), float("inf")
    kw.update(k_scale=ks, v_scale=vs, win_ks=wks, win_vs=wvs)
    got = paged_attention(args[0], k8, v8, bt, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("NH,KVH,HD", [(6, 6, 48), (8, 2, 64), (32, 8, 128), (4, 2, 20)])
def test_paged_attention_bf16_kernel_matches_plain(cuda, mode, NH, KVH, HD):
    """bf16 q, pools and rows in the three modes, with an overrun row;
    HD=20 takes the 4-byte loads, the others 16-byte loads."""
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in
         _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD + 2).items()}
    if mode == "plain":
        args = (a["q"], a["kp"][1].contiguous(), a["vp"][1].contiguous(), a["bt"], a["pos"])
        kw = {}
    else:
        args = (a["q"], a["kp"], a["vp"], a["bt"], a["pos"])
        kw = dict(layer=1, cur_k=a["ck"], cur_v=a["cv"])
        if mode.startswith("window"):
            kw.update(win_k=a["wk"], win_v=a["wv"], win_count=int(mode[-1]))
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1 and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), paged_attention_plain(*args, **kw).float(),
                               **BF16_TOL)


def _boundary_call(cuda, dtype, mode, seed):
    """A paged call whose rows hold the chunk schedule's boundary lengths:
    0, 1, page-1, page, C*page, C*page+1 and maxp*page tokens, and one row
    past its table; (args, kwargs) in `dtype` (int8: quantized pools, rows
    and scales)."""
    B, NH, KVH, HD, page, NL, Q = 8, 8, 2, 64, 16, 2, 3
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    C = chunk_pages(B, KVH, page, 64, sms)
    maxp = 2 * C + 3  # three chunks, the last one partial
    assert chunk_pages(B, KVH, page, maxp, sms) == C
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=seed)
    held = [0, 1, page - 1, page, C * page, C * page + 1, maxp * page, maxp * page + 40]
    stacked = mode != "plain"
    pos = [max(h - (0 if stacked else 1), 0) for h in held]
    bt = a["bt"].clone()
    for b, h in enumerate(held[:-1]):  # unused entries -> null page 0
        bt[b, -(-h // page):] = 0
    a["bt"], a["pos"] = bt, torch.tensor(pos, dtype=torch.int32, device=cuda)
    if dtype == torch.int8:
        args, kw = _int8_pools(a, 1 if stacked else None)
        if mode == "stacked":
            for name in ("win_k", "win_v", "win_ks", "win_vs"):
                kw.pop(name)
        elif stacked:
            kw["win_count"] = 2
        return args, kw
    a = {k: v.to(dtype) if v.is_floating_point() else v for k, v in a.items()}
    if not stacked:
        return (a["q"], a["kp"][1].contiguous(), a["vp"][1].contiguous(), a["bt"],
                a["pos"]), {}
    kw = dict(layer=1, cur_k=a["ck"], cur_v=a["cv"])
    if mode == "window2":
        kw.update(win_k=a["wk"], win_v=a["wv"], win_count=2)
    return (a["q"], a["kp"], a["vp"], a["bt"], a["pos"]), kw


@pytest.mark.parametrize("mode", ["plain", "stacked", "window2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.bfloat16,
                                   torch.float16])
def test_paged_attention_kernel_chunk_boundaries(cuda, dtype, mode):
    """Rows at the chunk schedule's boundary lengths (one chunk, one token
    into the next, the full table, past it) in every pool dtype and mode."""
    args, kw = _boundary_call(cuda, dtype, mode, seed=5)
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    tol = {torch.bfloat16: BF16_TOL, torch.float16: F16_TOL}.get(
        dtype, dict(rtol=1e-4, atol=1e-5))
    torch.testing.assert_close(got.float(), paged_attention_plain(*args, **kw).float(), **tol)


HALF_TOL = {torch.bfloat16: BF16_TOL, torch.float16: F16_TOL}


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["plain", "stacked", "window2"])
def test_paged_attention_int8_16bit_q_chunk_boundaries(cuda, qdt, mode):
    """int8 pools under a bf16 or float16 q at the chunk boundary lengths:
    q widened to f32, one rounding at the output (the merge's too)."""
    args, kw = _boundary_call(cuda, torch.int8, mode, seed=7)
    args = (args[0].to(qdt),) + args[1:]
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == qdt and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), paged_attention_plain(*args, **kw).float(),
                               **HALF_TOL[qdt])


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("NH,KVH,HD", [(6, 6, 48), (8, 2, 64), (32, 8, 128), (4, 2, 20)])
def test_paged_attention_int8_16bit_q_kernel_matches_plain(cuda, qdt, mode, NH, KVH, HD):
    """int8 pools with scales under a bf16 or float16 q (a 16-bit model's
    int8 KV) in the three modes, with an overrun row; G 1, 4 and 2; HD=20
    takes the 4-byte loads."""
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD + 3)
    args, kw = _int8_pools(a, None if mode == "plain" else 1)
    args = (args[0].to(qdt),) + args[1:]
    if mode == "stacked":
        for name in ("win_k", "win_v", "win_ks", "win_vs"):
            kw.pop(name)
    elif mode != "plain":
        kw["win_count"] = int(mode[-1])
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1 and got.dtype == qdt
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), paged_attention_plain(*args, **kw).float(),
                               **HALF_TOL[qdt])


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_paged_attention_int8_16bit_q_ignores_masked_scales(cuda, qdt):
    """Under a 16-bit q as under f32: NaN/inf scales and garbage values in
    masked slots never reach the output."""
    B, NH, KVH, HD, page, maxp = 3, 8, 2, 64, 16, 4
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, 2, 4, seed=4)
    pos = torch.tensor([5, 17, 40], dtype=torch.int32, device=cuda)
    bt = torch.arange(1, 1 + B * maxp, dtype=torch.int32, device=cuda).reshape(B, maxp)
    bt[:, 3:] = 0
    args, kw = _int8_pools(a, layer=0)
    args = (args[0].to(qdt), args[1], args[2], bt, pos)
    kw["win_count"] = 2
    clean = paged_attention(*args, **kw)
    k8, v8 = args[1].clone(), args[2].clone()
    ks, vs = kw["k_scale"].clone(), kw["v_scale"].clone()
    ks[:, 0], vs[:, 0], k8[:, 0], v8[:, 0] = float("nan"), float("inf"), 127, -128
    for b, p in enumerate(pos.tolist()):  # slots >= pos of the row's pages
        for t in range(p, 3 * page):
            pid = int(bt[b, t // page])
            ks[0, pid, :, t % page] = float("nan")
            vs[0, pid, :, t % page] = float("inf")
            v8[0, pid, :, t % page] = 99
    wks, wvs = kw["win_ks"].clone(), kw["win_vs"].clone()
    wks[:, :, 2:], wvs[:, :, 2:] = float("nan"), float("inf")
    kw.update(k_scale=ks, v_scale=vs, win_ks=wks, win_vs=wvs)
    got = paged_attention(args[0], k8, v8, bt, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("NH,KVH,HD", [(6, 6, 48), (8, 2, 64), (32, 8, 128), (4, 2, 20),
                                       (64, 4, 64)])
def test_paged_attention_f16_kernel_matches_plain(cuda, mode, NH, KVH, HD):
    """float16 q, pools and rows in the three modes, with an overrun row;
    G <= 16 with HD % 16 == 0 takes the tensor-core form, G = 16 at HD=64
    too, HD=48 with G=1 as well; HD=20 the CUDA-core walk."""
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = {k: v.to(torch.float16) if v.is_floating_point() else v for k, v in
         _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD + 4).items()}
    if mode == "plain":
        args = (a["q"], a["kp"][1].contiguous(), a["vp"][1].contiguous(), a["bt"], a["pos"])
        kw = {}
    else:
        args = (a["q"], a["kp"], a["vp"], a["bt"], a["pos"])
        kw = dict(layer=1, cur_k=a["ck"], cur_v=a["cv"])
        if mode.startswith("window"):
            kw.update(win_k=a["wk"], win_v=a["wv"], win_count=int(mode[-1]))
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1 and got.dtype == torch.float16
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), paged_attention_plain(*args, **kw).float(),
                               **F16_TOL)


def test_kernels_are_deterministic(cuda):
    """Two calls on the same inputs give the same bits: bf16 flash prefill at
    the llama3-8b head shape, and bf16 paged attention with rows spanning
    several chunks (the merge)."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 500, h, 128, generator=g).to(cuda, torch.bfloat16)
               for h in (32, 8, 8))
    assert torch.equal(flash_prefill(q, k, v), flash_prefill(q, k, v))
    args, kw = _boundary_call(cuda, torch.bfloat16, "window2", seed=6)
    assert torch.equal(paged_attention(*args, **kw), paged_attention(*args, **kw))
    q, k, v = (t.half() for t in (q, k, v))
    assert torch.equal(flash_prefill(q, k, v), flash_prefill(q, k, v))
    args, kw = _boundary_call(cuda, torch.float16, "window2", seed=6)
    assert torch.equal(paged_attention(*args, **kw), paged_attention(*args, **kw))
    args, kw = _boundary_call(cuda, torch.int8, "window2", seed=6)
    args = (args[0].to(torch.bfloat16),) + args[1:]
    assert torch.equal(paged_attention(*args, **kw), paged_attention(*args, **kw))


def test_paged_attention_kernel_refuses_unported_pools(cuda):
    """int8 scales other than float32: no kernel mode takes them (int8
    pools under a bf16 or float16 q, float16 pools, and float pools under a
    q of another float dtype, the kv_dtype override, run)."""
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 1, 4, 16, device=cuda, dtype=torch.bfloat16)
    half = torch.zeros(3, 2, 8, 16, device=cuda, dtype=torch.float16)
    for qq in (q, q.float()):  # float16 pools under a bf16 or float32 q
        got = paged_attention(qq, half, half, bt, pos)
        torch.cuda.synchronize()
        assert got.dtype == qq.dtype and not got.float().abs().any()
    pool = torch.zeros(3, 2, 8, 16, device=cuda, dtype=torch.int8)
    scale = torch.ones(3, 2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32 scales"):
        paged_attention(q, pool, pool, bt, pos, k_scale=scale, v_scale=scale)
    got = paged_attention(q, pool, pool, bt, pos, k_scale=scale.float(),
                          v_scale=scale.float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and not got.float().abs().any()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("quantum", [1, 3])
def test_card_batch_engine_matches_cpu_engine(cuda, quantum, kv_quant):
    args = preset("test-tiny", quant=kv_quant, kv_quant=kv_quant)
    w = synthetic_weights(args, seed=23)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, args.vocab_size, size=n).tolist() for n in (4, 9, 6)]

    def serve(device):
        be = BatchEngine(Llama(w, args, device=device), capacity=2, paged=True,
                         page_size=8)
        reqs, steps = [be.submit(prompts[0], 10)], 0
        for p in prompts[1:]:
            be.step(quantum)
            steps += quantum
            reqs.append(be.submit(p, 10))
        while be.num_active or be._queue:
            be.step(quantum)
            steps += quantum
        assert be.allocator.available == be.allocator.num_pages - 1
        return [r.generated for r in reqs], steps

    before = paged_attention.launches
    got, steps = serve(cuda)
    assert paged_attention.launches == before + args.n_layers * steps
    assert got == serve("cpu")[0]


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_card_bf16_engine_runs_the_kernels(cuda, name):
    """A bf16 model on the card: greedy generation through the bf16 flash,
    decode and greedy-head kernels, its last-prompt logits within the bf16
    envelope of the plain path's on the card (2e-2 x max(1, max |logits|),
    top-1 equal); paged serving through the bf16 paged kernel, every page
    back."""
    args = preset(name, dtype="bfloat16")
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    eng = Llama(w, args, device=cuda)
    before = (flash_prefill.launches, decode_layers.launches, argmax_head.launches)
    toks = eng.generate_tokens(ids, 12).cpu()
    assert toks.shape == (1, 12)
    assert (flash_prefill.launches - before[0], decode_layers.launches - before[1],
            argmax_head.launches - before[2]) == (args.n_layers, 11, 11)
    got = eng(ids, 0)
    want = Llama(w, args.replace(attn_impl="xla"), device=cuda)(ids, 0)
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())
    assert got[0, -1].argmax() == want[0, -1].argmax()
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
    assert be.cache["k"].dtype == torch.bfloat16
    before = paged_attention.launches
    reqs = [be.submit([1, 7, 30, 41, 5], 9, stop_ids=()),
            be.submit([3, 9, 11], 6, stop_ids=())]
    steps = 0
    while be.num_active:
        be.step()
        steps += 1
    assert paged_attention.launches == before + args.n_layers * steps
    assert [len(r.generated) for r in reqs] == [9, 6]
    assert be.allocator.available == be.allocator.num_pages - 1



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("a_shape,N", [
    ((64, 4096), 14336),      # mistral-7b's FD, a 64-row chat step
    ((16, 4096), 12288),      # deepseek-7b's wqkv (MHA: 3 x 4096), 16 rows
    ((1, 512, 4096), 14336),  # a 512-row prefill, 3-D as the model passes it
    ((16, 4096), 102400),     # deepseek-7b's head
    ((64, 14336), 4096),      # mistral-7b's w_down, 64 rows: cuBLAS splits K here
    ((16, 11008), 4096),      # deepseek-7b's w_down, 16 rows: and here
], ids=["mistral-chat", "deepseek-longdoc", "prefill-512", "deepseek-head",
        "mistral-down", "deepseek-down"])
def test_dot_tensor_cores_match_widened_product(cuda, dtype, a_shape, N):
    """A 16-bit product on the card takes the tensor-core path: an f32
    result within 1e-4 of max |widened f32 product| (only the order of the
    f32 sums differs; a 16-bit rounding of the sum, or of a split-K
    partial, would show as ~4e-3 in bf16, ~5e-4 in fp16)."""
    g = torch.Generator(device=cuda).manual_seed(N)
    K = a_shape[-1]
    a = torch.randn(*a_shape, generator=g, device=cuda).to(dtype)
    b = (torch.randn(K, N, generator=g, device=cuda) * 0.02).to(dtype)
    before = dict(dot_calls)
    got = _dot(a, b)
    assert dot_calls == {"tensor_core": before["tensor_core"] + 1,
                         "widened": before["widened"]}
    want = _widened_dot(a, b)
    assert got.dtype == torch.float32 and got.shape == want.shape == (*a_shape[:-1], N)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.parametrize("name,dtype", [("test-tiny", "bfloat16"), ("test-tiny-mha", "bfloat16"),
                                        ("test-tiny", "float16")])
def test_card_16bit_engine_products_take_tensor_cores(cuda, name, dtype):
    """A 16-bit engine's greedy generation (prefill; decode is the kernel)
    and an admission prefill plus one serving step: every plain product
    takes the tensor-core path, none is widened."""
    args = preset(name, dtype=dtype)
    eng = Llama(synthetic_weights(args, seed=7), args, device=cuda)
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
    before = dict(dot_calls)
    eng.generate_tokens([[1, 7, 30, 41, 5]], 4)
    be.submit([1, 7, 30, 41, 5], 4, stop_ids=())
    be.submit([3, 9, 11], 4, stop_ids=())
    be.step()
    torch.cuda.synchronize()
    assert dot_calls["tensor_core"] > before["tensor_core"]
    assert dot_calls["widened"] == before["widened"]

@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_card_int8_bf16_engine_runs_the_kernels(cuda, name):
    """int8 weights under bf16 activations on the card: greedy generation
    through the bf16 flash kernel and the decode kernel's int8/bf16 mode
    (the int8 lm_head stays plain: no greedy-head launch), its last-prompt
    logits within the bf16 envelope of the plain path's, top-1 equal."""
    args = preset(name, dtype="bfloat16", quant="int8")
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    eng = Llama(w, args, device=cuda)
    assert eng.params["layers"]["wqkv"].dtype == torch.int8
    before = (flash_prefill.launches, decode_layers.launches, argmax_head.launches)
    toks = eng.generate_tokens(ids, 12).cpu()
    assert toks.shape == (1, 12)
    assert (flash_prefill.launches - before[0], decode_layers.launches - before[1],
            argmax_head.launches - before[2]) == (args.n_layers, 11, 0)
    got = eng(ids, 0)
    want = Llama(w, args.replace(attn_impl="xla"), device=cuda)(ids, 0)
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())
    assert got[0, -1].argmax() == want[0, -1].argmax()


def test_card_engine_refuses_unported_modes(cuda):
    """Nothing the JAX engine runs is refused on the card any more: the
    kv_dtype override (float32 over a bf16 cache, bf16 over a float32 one)
    builds on the kernel path and decodes through the decode kernel, as do
    float16 and int8 KV under a 16-bit q."""
    w = synthetic_weights(preset("test-tiny"), seed=1)
    for kw in (dict(dtype="float32", kv_dtype="bfloat16"),
               dict(dtype="bfloat16", kv_dtype="float32")):
        eng = Llama(w, preset("test-tiny", **kw), device=cuda)
        assert eng.cfg.kernels and eng.cache["k"].dtype == getattr(torch, kw["kv_dtype"])
        before = decode_layers.launches
        assert eng.generate_tokens([[1, 5, 9]], 4).shape == (1, 4)
        assert decode_layers.launches == before + 3
    assert Llama(w, preset("test-tiny", dtype="float16"), device=cuda).cfg.kernels
    eng = Llama(w, preset("test-tiny", dtype="bfloat16"), device=cuda)
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8, kv_quant="int8")
    assert be.cache["k"].dtype == torch.int8


# The kv_dtype override: (activation, cache) pairs of different float dtypes.
KV_PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16),
            (torch.float16, torch.float32), (torch.float16, torch.bfloat16)]
KV_IDS = ["f32-kv-bf16", "f32-kv-f16", "bf16-kv-f32", "bf16-kv-f16", "f16-kv-f32",
          "f16-kv-bf16"]


def _kv_tol(act):
    """Kernel against twin under the override: float32 activations 1e-3
    (the twin rounds q and the probabilities to a 16-bit cache where the
    kernel does, but an element computed an ulp apart in f32 may round the
    other way, moving the output by up to 2^-9 of a value); 16-bit
    activations the 16-bit modes' 3e-2."""
    return dict(rtol=1e-3, atol=1e-3) if act == torch.float32 else dict(rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act,kv", KV_PAIRS, ids=KV_IDS)
@pytest.mark.parametrize("pos,M", [(0, 64), (40, 128), (127, 128), (700, 1024)])
def test_decode_layers_kv_override_kernel_matches_plain(cuda, int8, act, kv, pos, M):
    """A cache of another float dtype than the activations', float or int8
    weights: output and new rows against the twin, other rows untouched;
    pos 0 (the appended column alone), one split, and many position splits
    (the max pass before a split attention over a 16-bit cache)."""
    nl, d, nh, kvh, fd = 2, 256, 8, 2, 512
    g = torch.Generator().manual_seed(pos + M)
    hd = d // nh
    layers = _decode_layers_tree(g, cuda, nl, d, nh, kvh, fd, int8, act)
    kc, vc = (torch.randn(nl, kvh, M, hd, generator=g).to(cuda, kv) for _ in range(2))
    x = torch.randn(1, d, generator=g).to(cuda, act)
    ang = torch.rand(1, hd // 2, generator=g).to(cuda) * pos
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = decode_layers.launches
    got = decode_layers(layers, x, pos, k1, v1, ang.cos(), ang.sin(), **kw)[0]
    torch.cuda.synchronize()
    assert decode_layers.launches == before + 1 and got.dtype == act and k1.dtype == kv
    want = decode_layers_plain(layers, x, pos, k2, v2, ang.cos(), ang.sin(), **kw)[0]
    tol = _kv_tol(act)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(k1[:, :, pos].float(), k2[:, :, pos].float(), **tol)
    torch.testing.assert_close(v1[:, :, pos].float(), v2[:, :, pos].float(), **tol)
    others = torch.arange(M, device=cuda) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])
    assert torch.equal(v1[:, :, others], vc[:, :, others])
    again = decode_layers(layers, x, pos, kc.clone(), vc.clone(), ang.cos(), ang.sin(), **kw)[0]
    assert torch.equal(again, got)  # deterministic, the max pass included


@pytest.mark.parametrize("act,kv", KV_PAIRS, ids=KV_IDS)
@pytest.mark.parametrize("mode", ["plain", "stacked", "window2"])
@pytest.mark.parametrize("NH,KVH,HD", [(8, 2, 64), (32, 8, 128), (4, 2, 20)])
def test_paged_attention_kv_override_kernel_matches_plain(cuda, act, kv, mode, NH, KVH, HD):
    """Float pools, current rows and window of `kv` under a q of `act`:
    the CUDA-core walk widens everything to f32 and rounds the output to
    q's dtype once, as the twin does; float32 q 1e-4, 16-bit q two ulps."""
    B, page, maxp, NL, Q = 5, 16, 9, 2, 3
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, Q, seed=HD + 1)
    q = a["q"].to(act)
    kp, vp, ck, cv, wk, wv = (a[n].to(kv) for n in ("kp", "vp", "ck", "cv", "wk", "wv"))
    if mode == "plain":
        args, kw = (q, kp[1].contiguous(), vp[1].contiguous(), a["bt"], a["pos"]), {}
    else:
        args, kw = (q, kp, vp, a["bt"], a["pos"]), dict(layer=1, cur_k=ck, cur_v=cv)
        if mode == "window2":
            kw.update(win_k=wk, win_v=wv, win_count=2)
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1 and got.dtype == act
    want = paged_attention_plain(*args, **kw)
    tol = (dict(rtol=1e-4, atol=1e-5) if act == torch.float32 else
           dict(rtol=1e-2, atol=1e-2) if act == torch.bfloat16 else dict(rtol=2e-3, atol=2e-3))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("kw", [dict(dtype="float32", kv_dtype="bfloat16"),
                                dict(dtype="float32", kv_dtype="bfloat16", quant="int8"),
                                dict(dtype="bfloat16", kv_dtype="float32"),
                                dict(dtype="float16", kv_dtype="bfloat16")],
                         ids=["f32-kv-bf16", "int8-kv-bf16", "bf16-kv-f32", "f16-kv-bf16"])
def test_card_kv_override_engine_runs_the_kernels(cuda, kw):
    """An engine with the override on the card: greedy generation through
    flash, the decode kernel's override mode and (float head) the greedy
    head, the same stream as the CPU engine on its kernel path (the twins);
    paged serving through the paged kernel's override mode at quanta 1 and
    3, every stream equal to the CPU twins' and every page back."""
    args = preset("test-tiny", **kw)
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    eng = Llama(w, args, device=cuda)
    cpu = Llama(w, args, device="cpu")
    cpu.cfg = cpu.cfg._replace(kernels=True)  # the twins, on the CPU
    before = (flash_prefill.launches, decode_layers.launches, argmax_head.launches)
    toks = eng.generate_tokens(ids, 12).cpu()
    assert (flash_prefill.launches - before[0], decode_layers.launches - before[1],
            argmax_head.launches - before[2]) == (
        args.n_layers, 11, 0 if args.quant else 11)
    assert toks.tolist() == cpu.generate_tokens(ids, 12).tolist()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, args.vocab_size, size=n).tolist() for n in (4, 9, 6)]
    for quantum in (1, 3):
        streams = []
        for e in (eng, cpu):
            be = BatchEngine(e, capacity=2, paged=True, page_size=8)
            assert be.cache["k"].dtype == getattr(torch, args.kv_dtype)
            reqs = [be.submit(p, 10, stop_ids=()) for p in prompts]
            be.run_to_completion()
            assert be.allocator.available == be.allocator.num_pages - 1
            streams.append([r.generated for r in reqs])
        assert streams[0] == streams[1]


def test_card_boots_converted_checkpoints_and_resumes(cuda, tmp_path):
    """A llama2.c `.bin` and a bf16 safetensors HF directory, both written
    here, convert and boot on the card to the stream of the same weights
    handed over directly; a generation saved on the card resumes there
    through the decode kernel (first + rest = the uninterrupted stream),
    over a bf16 cache under float32 activations."""
    import json
    import struct

    from llama3np_tpu_torch import checkpoint as ck
    from llama3np_tpu_torch.ops.core import rope_split_permutation

    args = preset("test-tiny")
    w = synthetic_weights(args, seed=3)
    ids = [[1, 17, 99, 5, 203]]
    direct = Llama(w, args, device=cuda).generate_tokens(ids, 8).tolist()
    L = args.n_layers
    p = "model.layers.{i}."
    names = ["input_layernorm", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "post_attention_layernorm", "mlp.gate_proj",
             "mlp.down_proj", "mlp.up_proj"]
    with open(tmp_path / "m.bin", "wb") as f:
        np.array([args.dim, args.hidden_dim, L, args.n_heads, args.kv_heads,
                  -args.vocab_size, args.max_seq_len], np.int32).tofile(f)
        w["model.embed_tokens.weight"].tofile(f)
        for n in names:
            np.stack([w[(p + n + ".weight").format(i=i)] for i in range(L)]).tofile(f)
        w["model.norm.weight"].tofile(f)
        np.zeros(args.max_seq_len * args.head_dim, np.float32).tofile(f)
        w["lm_head.weight"].tofile(f)
    cw, cargs = ck.convert_llama2c_bin(str(tmp_path / "m.bin"))
    assert Llama(cw, cargs, device=cuda).generate_tokens(ids, 8).tolist() == direct

    bf = preset("test-tiny", dtype="bfloat16")
    want = Llama(w, bf, device=cuda).generate_tokens(ids, 8).tolist()
    perm = {"q_proj": rope_split_permutation(args.n_heads, args.head_dim),
            "k_proj": rope_split_permutation(args.kv_heads, args.head_dim)}
    header, blobs, off = {}, [], 0
    for k, v in w.items():
        t = torch.from_numpy(v[perm[k.split(".")[-2]]] if k.split(".")[-2] in perm else v)
        raw = t.to(torch.bfloat16).view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": "BF16", "shape": list(t.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    d = tmp_path / "hf"
    d.mkdir()
    head = json.dumps(header).encode()
    (d / "model.safetensors").write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))
    (d / "config.json").write_text(json.dumps({
        "hidden_size": args.dim, "num_hidden_layers": L, "num_attention_heads": args.n_heads,
        "num_key_value_heads": args.kv_heads, "vocab_size": args.vocab_size,
        "max_position_embeddings": args.max_seq_len, "rms_norm_eps": args.norm_eps,
        "intermediate_size": args.hidden_dim, "torch_dtype": "bfloat16"}))
    hw = ck.convert_hf_model(str(d))
    hargs = ck.args_from_hf_config(str(d), norm_eps=bf.norm_eps, rope_theta=bf.rope_theta)
    assert hargs.dtype == "bfloat16"
    assert Llama(hw, hargs, device=cuda).generate_tokens(ids, 8).tolist() == want

    eng = Llama(w, preset("test-tiny", kv_dtype="bfloat16"), device=cuda)
    full = eng.generate_tokens(ids, 10).tolist()[0]
    first = eng.generate_tokens(ids, 4).tolist()[0]
    eng.save_generation_state(str(tmp_path / "s.npz"))
    eng.reset()
    before = decode_layers.launches
    rest = eng.resume_generate(str(tmp_path / "s.npz"), 6).tolist()[0]
    assert decode_layers.launches == before + 6
    assert first + rest == full


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_card_f16_engine_runs_the_kernels(cuda, name, quant):
    """A float16 model on the card (float16 or int8 weights): greedy
    generation through the float16 flash kernel, the decode kernel's
    float16 (int8/float16) mode and the float16 greedy head (none for an
    int8 lm_head), its last-prompt logits within the float16 envelope of
    tests/test_dtype.py (2e-2 x max(1, max |logits|)) of the plain path's,
    top-1 equal; paged serving over float16 pools, and over int8 pools,
    through the paged kernel, every page back."""
    args = preset(name, dtype="float16", quant=quant)
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    eng = Llama(w, args, device=cuda)
    before = (flash_prefill.launches, decode_layers.launches, argmax_head.launches)
    toks = eng.generate_tokens(ids, 12).cpu()
    assert toks.shape == (1, 12)
    assert (flash_prefill.launches - before[0], decode_layers.launches - before[1],
            argmax_head.launches - before[2]) == (args.n_layers, 11, 0 if quant else 11)
    got = eng(ids, 0)
    want = Llama(w, args.replace(attn_impl="xla"), device=cuda)(ids, 0)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())
    assert got[0, -1].argmax() == want[0, -1].argmax()
    for kv_quant in (None, "int8"):
        be = BatchEngine(eng, capacity=2, paged=True, page_size=8, kv_quant=kv_quant)
        assert be.cache["k"].dtype == (torch.int8 if kv_quant else torch.float16)
        before = paged_attention.launches
        reqs = [be.submit([1, 7, 30, 41, 5], 9, stop_ids=()),
                be.submit([3, 9, 11], 6, stop_ids=())]
        steps = 0
        while be.num_active:
            be.step()
            steps += 1
        assert paged_attention.launches == before + args.n_layers * steps
        assert [len(r.generated) for r in reqs] == [9, 6]
        assert be.allocator.available == be.allocator.num_pages - 1


@pytest.mark.parametrize("quantum", [1, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_card_16bit_int8_kv_batch_engine(cuda, dtype, quantum):
    """int8 KV under a 16-bit q on the card: every paged decode step runs
    the paged kernel's int8/bf16 (int8/float16) mode once a layer, every
    stream runs to its budget, every page comes back, and the first token
    of each request (from the prefill, no paged step) is the CPU engine's."""
    args = preset("test-tiny", dtype=dtype, kv_quant="int8")
    w = synthetic_weights(args, seed=23)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, args.vocab_size, size=n).tolist() for n in (4, 9, 6)]

    def serve(device):
        be = BatchEngine(Llama(w, args, device=device), capacity=2, paged=True,
                         page_size=8)
        assert be.cache["k"].dtype == torch.int8
        reqs, steps = [be.submit(prompts[0], 10, stop_ids=())], 0
        for p in prompts[1:]:
            be.step(quantum)
            steps += quantum
            reqs.append(be.submit(p, 10, stop_ids=()))
        while be.num_active or be._queue:
            be.step(quantum)
            steps += quantum
        assert be.allocator.available == be.allocator.num_pages - 1
        return [r.generated for r in reqs], steps

    before = paged_attention.launches
    got, steps = serve(cuda)
    assert paged_attention.launches == before + args.n_layers * steps
    assert [len(g) for g in got] == [10, 10, 10]
    assert [g[0] for g in got] == [g[0] for g in serve("cpu")[0]]


# -- the serving front end: shared pages, sampling ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["plain", "stacked", "window2"])
def test_paged_attention_kernel_over_shared_pages(cuda, dtype, mode):
    """The prefix cache's block tables: rows name the same page ids for
    their shared prefix (one row the whole prefix, one a part, one none),
    then pages of their own; the kernel only reads the pool, so each row
    matches the twin, and a sharing row matches itself alone (whose chunk
    plan may differ: within the tolerance)."""
    B, NH, KVH, HD, page, maxp, NL = 4, 8, 2, 64, 16, 12, 2
    a = _paged_inputs(cuda, B, NH, KVH, HD, page, maxp, NL, 3, seed=5)
    shared = [3, 9, 4, 11, 7]  # a five-page prefix
    bt = torch.zeros(B, maxp, dtype=torch.int32)
    bt[0, :5] = torch.tensor(shared)
    bt[0, 5:8] = torch.tensor([20, 21, 22])
    bt[1, :5] = torch.tensor(shared)
    bt[1, 5:6] = 30
    bt[2, :3] = torch.tensor(shared[:3])
    bt[2, 3:5] = torch.tensor([40, 41])
    bt[3, :2] = torch.tensor([44, 45])
    bt = bt.to(cuda)
    pos = torch.tensor([5 * page + 40, 5 * page + 3, 3 * page + 20, 25],
                       dtype=torch.int32, device=cuda)
    kp, vp, q = a["kp"], a["vp"], a["q"]
    kw = {}
    if dtype is torch.int8:
        kp, kw["k_scale"] = quantize_kv_rows(kp)
        vp, kw["v_scale"] = quantize_kv_rows(vp)
    elif dtype is torch.bfloat16:
        kp, vp, q = kp.to(dtype), vp.to(dtype), q.to(dtype)
    if mode == "plain":
        kp, vp = kp[1].contiguous(), vp[1].contiguous()
        kw = {k: v[1].contiguous() for k, v in kw.items()}
    else:
        cur = (a["ck"], a["cv"])
        if dtype is torch.bfloat16:
            cur = tuple(c.to(dtype) for c in cur)
        if dtype is torch.int8:
            (ck, cks), (cv, cvs) = quantize_kv_rows(cur[0]), quantize_kv_rows(cur[1])
            kw.update(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
        else:
            kw.update(cur_k=cur[0], cur_v=cur[1])
        kw["layer"] = 1
        if mode == "window2":
            wk, wv = a["wk"], a["wv"]
            if dtype is torch.int8:
                (wk, wks), (wv, wvs) = quantize_kv_rows(wk), quantize_kv_rows(wv)
                kw.update(win_ks=wks, win_vs=wvs)
            elif dtype is torch.bfloat16:
                wk, wv = wk.to(dtype), wv.to(dtype)
            kw.update(win_k=wk, win_v=wv, win_count=2)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(q, kp, vp, bt, pos, **kw)
    tol = BF16_TOL if dtype is torch.bfloat16 else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # a sharing row alone: the same output as in the batch
    alone = {k: (v[1:2] if torch.is_tensor(v) and v.dim() and v.shape[0] == B else v)
             for k, v in kw.items()}
    one = paged_attention(q[1:2], kp, vp, bt[1:2], pos[1:2], **alone)
    torch.testing.assert_close(one.float(), got[1:2].float(), **tol)


def test_prng_on_the_card_equals_the_cpu(cuda):
    from llama3np_tpu_torch import prng

    for seed in (0, 7, 2**31 - 1):
        kc, kg = prng.prng_key(seed), prng.prng_key(seed, cuda)
        assert torch.equal(kg.cpu(), kc)
        rids = torch.tensor([0, 3, 17, 400])
        assert torch.equal(prng.fold_in(kg, rids.to(cuda)).cpu(), prng.fold_in(kc, rids))
        assert torch.equal(prng.split(kg, 3).cpu(), prng.split(kc, 3))
        keys = prng.fold_in(kc, rids)
        for shape in ((1000,), (3, 128256)):
            assert torch.equal(prng.random_bits(keys.to(cuda), shape).cpu(),
                               prng.random_bits(keys, shape))
            assert torch.equal(prng.uniform(keys.to(cuda), shape, 1e-30).cpu(),
                               prng.uniform(keys, shape, 1e-30))
            torch.testing.assert_close(prng.gumbel(keys.to(cuda), shape).cpu(),
                                       prng.gumbel(keys, shape), rtol=0, atol=1e-6)
        logits = torch.randn(4, 128256, generator=torch.Generator().manual_seed(seed)) * 3
        assert torch.equal(prng.categorical(keys.to(cuda), logits.to(cuda)).cpu(),
                           prng.categorical(keys, logits))


@pytest.mark.parametrize("pol", [dict(temperature=0.8, top_p=0.9, seed=0),
                                 dict(temperature=1.0, top_k=50, seed=3),
                                 dict(temperature=0.6, seed=11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_sampled_decode_steps_matches_plain(cuda, pol, dtype):
    """Sampled batch-1 decode through the fused decode kernel (then the
    plain logits and the sampler) against the plain sampled loop on the
    same card; fp32 also against the CPU engine.  Equal streams (these
    seeds and weights give no near-tie), the decode kernel launched once a
    token, the greedy head never."""
    from llama3np_tpu_torch.generate import Sampling

    args = preset("test-tiny", dtype=dtype, max_seq_len=256)
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    eng = Llama(w, args, device=cuda)
    s = Sampling(**pol)
    before = decode_layers.launches, argmax_head.launches
    got = eng.generate_tokens(ids, 40, sampling=s).cpu()
    assert (decode_layers.launches - before[0], argmax_head.launches - before[1]) == (39, 0)
    plain = Llama(w, args.replace(attn_impl="xla"), device=cuda)
    assert got.tolist() == plain.generate_tokens(ids, 40, sampling=s).cpu().tolist()
    if dtype == "float32":
        cpu = Llama(w, args, device="cpu")
        assert got.tolist() == cpu.generate_tokens(ids, 40, sampling=s).tolist()
    assert torch.equal(eng.generate_tokens(ids, 40, sampling=s).cpu(), got)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("quantum", [1, 3])
def test_card_prefix_cache_and_sampling_match_cpu_engine(cuda, quantum, kv_quant):
    """Paged serving with the prefix cache and sampled requests on the
    card: the same streams, hits and page accounting as the CPU engine."""
    args = preset("test-tiny")
    w = synthetic_weights(args, seed=23)
    rng = np.random.default_rng(2)
    head = rng.integers(3, args.vocab_size, size=24).tolist()
    work = [(head + rng.integers(3, args.vocab_size, size=n).tolist(), b, t)
            for n, b, t in ((3, 9, 0.0), (5, 7, 0.8), (1, 8, 0.0), (9, 6, 1.1))]

    def serve(device):
        be = BatchEngine(Llama(w, args, device=device), capacity=2, paged=True,
                         page_size=8, prefix_cache=True, kv_quant=kv_quant,
                         sampling_seed=4, top_p=0.9)
        reqs = []
        for p, b, t in work:
            reqs.append(be.submit(p, b, stop_ids=(), temperature=t))
            be.step(quantum)
        while be.num_active or be._queue:
            be.step(quantum)
        return ([r.generated for r in reqs], be.prefix_stats, be.allocator.available,
                len(be._registry))

    before = paged_attention.launches
    got = serve(cuda)
    assert paged_attention.launches > before and got[1]["hits"] >= 2
    assert got == serve("cpu")


def test_unpack_int4_on_the_card_equals_the_cpu(cuda):
    from llama3np_tpu_torch.checkpoint import pack_int4
    from llama3np_tpu_torch.ops.core import unpack_int4

    for shape in ((2048, 5632), (22, 64, 33), (7,)):
        codes = torch.randint(-8, 8, shape, generator=torch.Generator().manual_seed(1),
                              dtype=torch.int8)
        packed = pack_int4(codes)
        assert torch.equal(pack_int4(codes.to(cuda)).cpu(), packed)
        got = unpack_int4(packed.to(cuda), shape[-1])
        assert got.device.type == "cuda" and torch.equal(got.cpu(), codes)


def test_int4_product_at_tinyllama_width_matches_f32(cuda):
    """A tinyllama-width int4 product (D=2048 -> 5632, packed) against the
    f32 product of its grid-snapped weight, on the card."""
    from llama3np_tpu_torch.checkpoint import pack_int4
    from llama3np_tpu_torch.ops.core import _scaled_dot

    g = torch.Generator().manual_seed(3)
    w = torch.randn(2048, 5632, generator=g) * 0.02
    s = torch.clamp(w.abs().amax(dim=0, keepdim=True) / 7, min=1e-12)
    codes = torch.clamp(torch.round(w / s), -7, 7).to(torch.int8)
    packed = pack_int4(codes.to(cuda))
    assert packed.shape == (2048, 2816) and packed.dtype == torch.uint8
    x = torch.randn(5, 2048, generator=g).to(cuda)
    got = _scaled_dot(x, packed, s.to(cuda))
    want = x @ (codes.float() * s).to(cuda)  # the f32 product on the grid weight
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_draft_kernel_steps_propose_the_plain_drafts_tokens(cuda, dtype):
    """The int8 draft's steps through the decode kernel propose the plain
    draft's tokens (or part at a near-tie of the plain draft's logits, in
    bf16), and the speculative stream is the target's own greedy stream;
    the decode kernel runs (k+1) times a round, the greedy head never."""
    from llama3np_tpu_torch import SpeculativeGenerator, quantized_draft
    from llama3np_tpu_torch.generate import pad_prompt

    args = preset("test-tiny", dtype=dtype, max_seq_len=256)
    w = synthetic_weights(args, seed=7)
    target = Llama(w, args, device=cuda)
    draft = quantized_draft(w, args, device=cuda)
    plain = quantized_draft(w, args.replace(attn_impl="xla"), device=cuda)
    ids = np.array([[1, 7, 30, 41, 5, 9]])
    k = 4
    spec = SpeculativeGenerator(target, draft, k=k)
    before = decode_layers.launches, argmax_head.launches
    got = spec.generate_tokens(ids, 40)
    rounds = spec.last_stats["rounds"]
    assert (decode_layers.launches - before[0], argmax_head.launches - before[1]) == \
        (rounds * (k + 1), 0)
    plain_spec = SpeculativeGenerator(target, plain, k=k)
    assert plain_spec.generate_tokens(ids, 40).tolist() == got.tolist()
    if dtype == "float32":
        assert got.tolist() == target.generate_tokens(ids, 40).cpu().tolist()
    padded, L = pad_prompt(ids, args)
    cur, _, dk = spec.prefill(torch.as_tensor(padded, device=cuda), L)
    _, _, dp = plain_spec.prefill(torch.as_tensor(padded, device=cuda), L)
    pk = spec.propose(cur, L, dk).tolist()
    pp = plain_spec.propose(cur, L, dp).tolist()
    i = next((j for j, (a, b) in enumerate(zip(pk, pp)) if a != b), None)
    if i is not None:
        assert dtype == "bfloat16", (pk, pp)
        ctx = np.array([ids[0].tolist() + [int(cur)] + pp[:i]])
        top = torch.from_numpy(plain(ctx, 0))[0, -1].float().topk(2).values
        assert float(top[0] - top[1]) < 0.05, (i, pk, pp)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_card_split_engine_matches_cpu_and_never_runs_the_decode_kernel(cuda, quant):
    """A split engine (float32 or int4) on the card: flash prefill once a
    layer, the plain decode (no decode kernel, no greedy head), the CPU
    engine's stream and logits, and paged int4 serving equal to its
    capacity-1 streams."""
    args = preset("test-tiny", fuse_matmuls=False, quant=quant, max_seq_len=256)
    w = synthetic_weights(args, seed=9)
    eng = Llama(w, args, device=cuda)
    cpu = Llama(w, args, device="cpu")
    ids = np.array([[1, 7, 30, 41, 5]])
    before = decode_layers.launches, argmax_head.launches, flash_prefill.launches
    got = eng.generate_tokens(ids, 20).cpu()
    assert (decode_layers.launches - before[0], argmax_head.launches - before[1],
            flash_prefill.launches - before[2]) == (0, 0, args.n_layers)
    assert got.tolist() == cpu.generate_tokens(ids, 20).tolist()
    torch.testing.assert_close(torch.from_numpy(eng(ids, 0)), torch.from_numpy(cpu(ids, 0)),
                               rtol=1e-4, atol=1e-4)
    prompts = [[1, 5, 9, 14], [3, 8, 2, 44, 19, 7, 30]]

    def serve(capacity, ps):
        be = BatchEngine(eng, capacity=capacity, paged=True, page_size=8, kv_quant="int8")
        reqs = [be.submit(p, 10, stop_ids=()) for p in ps]
        while be.num_active or be._queue:
            be.step(3)
        return [r.generated for r in reqs]

    assert serve(2, prompts) == [serve(1, [p])[0] for p in prompts]


@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(quant="int8", dtype="bfloat16"),
                                dict(quant="int4", fuse_matmuls=False)])
def test_card_engine_quantizes_on_the_card_as_the_host_does(cuda, kw):
    """On the card `Llama` quantizes its weights there
    (`quantize_param_tree(device=...)`): every leaf equals the CPU
    engine's, whose weights quantize in host numpy."""
    args = preset("test-tiny", **kw)
    w = synthetic_weights(args, seed=5)
    card, cpu = Llama(w, args, device=cuda), Llama(w, args, device="cpu")
    for part in ("layers", None):
        a = card.params[part] if part else {k: v for k, v in card.params.items()
                                            if k != "layers"}
        b = cpu.params[part] if part else {k: v for k, v in cpu.params.items()
                                           if k != "layers"}
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].device.type == "cuda" and a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k].cpu(), b[k]), k


# ---------------------------------------------------------------------------
# LoRA, training, perplexity and data (ROADMAP A7, A8)
# ---------------------------------------------------------------------------

def _adapters(args, device, n=2, seed=1):
    """n adapters on attention and FFN targets with non-zero B factors."""
    from llama3np_tpu_torch.lora import init_lora
    out = []
    for i in range(n):
        lora = init_lora(args, rank=4, alpha=8.0, seed=seed + i, device=device,
                         targets=("wq", "wv", "w_gate", "w_down"))
        g = torch.Generator(device=device).manual_seed(100 + i)
        lora["layers"] = {k: (v if k.endswith("_a") else
                              0.05 * torch.randn(v.shape, generator=g, device=device))
                          for k, v in lora["layers"].items()}
        out.append(lora)
    return out


@pytest.mark.parametrize("quantum", [1, 3])
def test_card_multilora_engine_matches_cpu_engine(cuda, quantum):
    """Multi-LoRA serving on the card: base, adapter 0 and adapter 1
    co-tenants, admissions through flash prefill and every decode step
    through the paged kernel once a layer; the streams are the CPU
    engine's."""
    args = preset("test-tiny", fuse_matmuls=False, max_seq_len=256)
    w = synthetic_weights(args, seed=7)
    ads = _adapters(args, "cpu")
    prompts = [[1, 5, 9, 14], [1, 7, 2], [1, 3, 3, 8, 2, 40, 41]]

    def serve(device):
        be = BatchEngine(Llama(w, args, device=device), capacity=3, paged=True,
                         page_size=8, adapters=ads)
        reqs = [be.submit(p, 12, stop_ids=(), adapter=a)
                for p, a in zip(prompts, (None, 0, 1))]
        steps = 0
        while be.num_active:
            be.step(quantum)
            steps += quantum
        return [r.generated for r in reqs], steps

    before = paged_attention.launches, flash_prefill.launches
    got, steps = serve(cuda)
    assert paged_attention.launches - before[0] == args.n_layers * steps
    assert flash_prefill.launches - before[1] == args.n_layers * len(prompts)
    assert got == serve("cpu")[0]


def test_card_lora_train_step_matches_cpu(cuda):
    """Three LoRA AdamW steps over a frozen bf16 base on the card: the
    losses and adapters of the same steps on the CPU (bf16 envelope), the
    base bit-unchanged."""
    from llama3np_tpu_torch.checkpoint import build_param_tree, params_to_device
    from llama3np_tpu_torch.lora import init_lora, make_lora_train_step
    from llama3np_tpu_torch.models.llama import StaticConfig
    from llama3np_tpu_torch.ops.core import rope_tables
    from llama3np_tpu_torch.train import init_optimizer
    args = preset("test-tiny", dtype="bfloat16")
    tree = build_param_tree(synthetic_weights(args, seed=0), args)
    batch = np.random.default_rng(3).integers(3, args.vocab_size, size=(2, 17))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = params_to_device(tree, dev, "bfloat16")
        before = {k: v.clone() for k, v in params["layers"].items()}
        cfg = StaticConfig.from_args(args, dev)._replace(fused=False, rope_split=False)
        cos, sin = rope_tables(args.head_dim, args.max_seq_len, args.rope_theta, device=dev)
        lora = init_lora(args, rank=4, seed=1, device="cpu")
        ly = {k: v.to(dev) for k, v in lora["layers"].items()}
        opt, st = init_optimizer(ly, learning_rate=1e-2)
        step = make_lora_train_step(opt, cfg, 2.0, remat=True)
        losses = []
        for _ in range(3):
            ly, st, loss = step(ly, st, params, torch.as_tensor(batch, device=dev), cos, sin)
            losses.append(float(loss))
        for k, v in params["layers"].items():
            assert torch.equal(v, before[k]), k
        out[dev.type] = losses, {k: v.detach().cpu() for k, v in ly.items()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-2, atol=1e-2)
    assert out["cuda"][0][-1] < out["cuda"][0][0]
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_scorer_matches_plain_twin(cuda, dtype):
    """A Scorer batch on the card (flash prefill once a layer, buckets 8 to
    64) against the same engine with its kernels off."""
    from llama3np_tpu_torch.eval import Scorer
    args = preset("test-tiny", dtype=dtype)
    eng = Llama(synthetic_weights(args, seed=0), args, device=cuda)
    twin = Llama(synthetic_weights(args, seed=0), args.replace(attn_impl="xla"),
                 device=cuda)
    rng = np.random.default_rng(5)
    seqs = [[1] + rng.integers(3, args.vocab_size, size=n).tolist() for n in (3, 9, 20, 40, 63)]
    before = flash_prefill.launches
    nll, cnt = Scorer(eng, batch_size=2).score(seqs)
    assert flash_prefill.launches - before == args.n_layers * 3
    pnll, pcnt = Scorer(twin, batch_size=2).score(seqs)
    assert flash_prefill.launches - before == args.n_layers * 3
    np.testing.assert_array_equal(cnt, pcnt)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=0.1)
    np.testing.assert_allclose(nll, pnll, **tol)


def test_card_prefetch_hands_out_the_host_batches(cuda, tmp_path):
    from llama3np_tpu_torch.data import TokenDataset, pack_documents, prefetch_to_device

    class Tok:
        def encode(self, text, add_bos=True):
            return [1] + [ord(c) + 3 for c in text]

    p = str(tmp_path / "s.bin")
    pack_documents(["hello world " * 40, "abc " * 30], Tok(), p)
    ds = TokenDataset(p)
    host = list(ds.batches(4, 16, seed=1, epochs=2))
    dev = list(prefetch_to_device(ds.batches(4, 16, seed=1, epochs=2), size=3))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert d.device.type == "cuda" and d.dtype == torch.int32
        assert np.array_equal(d.cpu().numpy(), h)


def test_card_two_ranks_tp_and_pp_match_one_rank(cuda):
    """Parallelism (ROADMAP A9) on one card: two ranks under gloo (NCCL
    refuses two ranks on one device) take their shards of one fp32 split
    tree through CUDA IPC.  tp=2: greedy tokens and paged serving streams
    equal the single-rank engine's, with flash prefill (once a layer a
    prefill) and the paged kernel launched on each rank; pp=2: both
    schedules' tokens equal the single-rank engine's, with flash on each
    stage's layers."""
    import torch_parallel_workers as W
    from llama3np_tpu_torch.checkpoint import (build_param_tree, params_to_device,
                                               permute_rope_layout)
    from llama3np_tpu_torch.parallel.launch import launch

    args = preset("test-tiny", dim=128, n_heads=8, n_kv_heads=4, vocab_size=512,
                  hidden_dim=256, max_batch_size=2, fuse_matmuls=False)
    tree = params_to_device(permute_rope_layout(build_param_tree(
        synthetic_weights(args, seed=3), args), args), cuda)
    ref = Llama.from_param_tree(tree, args, device=cuda)
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, args.vocab_size, size=(1, 12))
    workload = [([1, 5, 9, 14, 3], 6), ([1, 7, 2, 9], 6),
                (rng.integers(3, args.vocab_size, size=20).tolist(), 5)]
    n = 8
    want = ref.generate_tokens(prompt, n).cpu().tolist()
    be = BatchEngine(ref, capacity=4, paged=True, page_size=16)
    reqs = [be.submit(p, b, stop_ids=()) for p, b in workload]
    be.run_to_completion()
    served = [r.generated for r in reqs]
    batch = np.concatenate([prompt, prompt[:, ::-1]])
    want_pp = ref.generate_tokens(batch, n).cpu().tolist()
    ranks = launch(W.card_ranks, 2, (tree, args, prompt, n, workload),
                   backend="gloo", devices=["cuda:0", "cuda:0"], timeout_s=300)
    nl = args.n_layers
    for r in ranks:
        assert r["tp_tokens"] == want
        assert r["tp_served"] == served
        assert r["tp_launches"]["flash_prefill"] == nl * (1 + len(workload))
        assert r["tp_decode_steps"] > 0
        assert r["tp_launches"]["paged_attention"] == nl * r["tp_decode_steps"]
        assert r["pp_tokens"] == r["pp_mb_tokens"] == want_pp
        assert r["pp_launches"]["flash_prefill"] == 2 * (nl // 2)
    assert ranks[0]["tp_launches"] == ranks[1]["tp_launches"]
    assert ranks[0]["pp_bytes"] == ranks[1]["pp_bytes"]
