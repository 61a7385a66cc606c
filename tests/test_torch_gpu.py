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
from llama3np_tpu_torch.ops.core import quantize_kv_rows
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)
from llama3np_tpu_torch.ops.kernels.flash_prefill import (flash_prefill,
                                                          flash_prefill_plain)
from llama3np_tpu_torch.ops.kernels.greedy_head import (argmax_head,
                                                        argmax_head_plain)
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
    """A float pool under a q of another dtype, and int8 scales other than
    float32: no kernel mode takes them (int8 pools under a bf16 or float16
    q, and float16 pools, run)."""
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 1, 4, 16, device=cuda, dtype=torch.bfloat16)
    half = torch.zeros(3, 2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="under a q of their dtype"):
        paged_attention(q, half, half, bt, pos)
    with pytest.raises(NotImplementedError, match="under a q of their dtype"):
        paged_attention(q.float(), half, half, bt, pos)
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
    """On the card's kernel path only the kv_dtype override still raises;
    float16 and int8 KV under a 16-bit q build."""
    w = synthetic_weights(preset("test-tiny"), seed=1)
    for kw in (dict(dtype="float32", kv_dtype="bfloat16"),
               dict(dtype="bfloat16", kv_dtype="float32")):
        with pytest.raises(NotImplementedError, match="ROADMAP B11"):
            Llama(w, preset("test-tiny", **kw), device=cuda)
    assert Llama(w, preset("test-tiny", dtype="float16"), device=cuda).cfg.kernels
    eng = Llama(w, preset("test-tiny", dtype="bfloat16"), device=cuda)
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8, kv_quant="int8")
    assert be.cache["k"].dtype == torch.int8


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
