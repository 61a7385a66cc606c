"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device is present
(the check runs inside the fixture, never at import).  The file imports
only torch and the port, so it needs no JAX and runs on the card as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import pytest
import torch

from llama3np_tpu_torch import Llama, preset, synthetic_weights
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)
from llama3np_tpu_torch.ops.kernels.flash_prefill import (flash_prefill,
                                                          flash_prefill_plain)

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


def test_flash_prefill_kernel_refuses_bf16(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_prefill(q, q, q)


@pytest.mark.parametrize("pos", [0, 5, 63])
def test_decode_layers_kernel_matches_plain(cuda, pos):
    nl, d, nh, kvh, fd, M = 2, 64, 4, 2, 128, 64
    hd = d // nh
    g = torch.Generator().manual_seed(pos)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(cuda)

    layers = {"wqkv": rnd(nl, d, (nh + 2 * kvh) * hd, scale=0.05),
              "wo": rnd(nl, nh * hd, d, scale=0.05),
              "wgu": rnd(nl, d, 2 * fd, scale=0.05),
              "w_down": rnd(nl, fd, d, scale=0.05),
              "attn_norm": 1 + rnd(nl, 1, d, scale=0.05),
              "ffn_norm": 1 + rnd(nl, 1, d, scale=0.05)}
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


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_card_engine_matches_cpu_engine(cuda, name):
    args = preset(name)
    w = synthetic_weights(args, seed=7)
    ids = [[1, 7, 30, 41, 5]]
    on_card = Llama(w, args, device=cuda)
    before = flash_prefill.launches, decode_layers.launches
    got = on_card.generate_tokens(ids, 12).cpu()
    assert flash_prefill.launches == before[0] + args.n_layers
    assert decode_layers.launches == before[1] + 11
    want = Llama(w, args, device="cpu").generate_tokens(ids, 12)
    assert got.tolist() == want.tolist()
