"""The port's kernel wrappers on CPU tensors against the JAX package's
Pallas kernels in interpret mode.

On a CPU tensor each wrapper runs its plain PyTorch version (the CUDA
kernels themselves are held against the same plain versions on the card by
`chip_smoke.py` and tests/test_torch_gpu.py).  Inputs are made with numpy
from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.ops.core import rope_tables as j_rope_tables
from llama3np_tpu.ops.kernels.decode_step import decode_layers as j_decode_layers
from llama3np_tpu.ops.kernels.flash_prefill import flash_prefill as j_flash_prefill
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)
from llama3np_tpu_torch.ops.kernels.flash_prefill import (flash_prefill,
                                                          flash_prefill_plain)

torch.set_num_threads(1)


@pytest.mark.parametrize("L,nh,kvh,hd,bq,bk", [
    (32, 4, 2, 16, 16, 16),   # GQA, multiple blocks (tests/test_pallas.py shapes)
    (64, 2, 2, 32, 32, 16),   # MHA, asymmetric blocks
    (16, 3, 1, 8, 16, 16),    # single block, MQA
    (24, 6, 3, 48, 8, 8),     # ragged for the port's tiles, HD=48
])
def test_flash_prefill_matches_jax(rng, L, nh, kvh, hd, bq, bk):
    B = 2
    q = rng.standard_normal((B, L, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, kvh, hd)).astype(np.float32)
    want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_block=bq, kv_block=bk, interpret=True)
    before = flash_prefill.launches
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v))
    assert flash_prefill.launches == before  # CPU: plain version, no launch
    assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


def test_flash_prefill_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_prefill(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_prefill(q, torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16))
    with pytest.raises(ValueError):
        flash_prefill(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 8))


def test_flash_prefill_plain_is_causal(rng):
    """Row i of the output depends on keys 0..i only."""
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 12, 1, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 12, 1, 8)).astype(np.float32))
    full = flash_prefill_plain(q, k, v)
    head = flash_prefill_plain(q[:, :5], k[:, :5], v[:, :5])
    torch.testing.assert_close(full[:, :5], head, rtol=0, atol=1e-6)


def _fused_layers(name, seed):
    """The fused rope-split layer tree of both packages from one checkpoint."""
    jargs, targs = jpreset(name), tpreset(name)
    w = jsynth(jargs, seed=seed)
    jtree = jckpt.fuse_param_tree(jckpt.permute_rope_layout(
        jckpt.build_param_tree(w, jargs), jargs))
    ttree = tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs))
    return jargs, jtree["layers"], tckpt.params_to_device(ttree, "cpu")["layers"]


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_layers_matches_jax(rng, name, where):
    args, jlayers, tlayers = _fused_layers(name, seed=5)
    M = args.max_seq_len
    pos = {"first": 0, "mid": M // 2 - 3, "last": M - 1}[where]
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((1, args.dim)).astype(np.float32)
    cos, sin = j_rope_tables(args.head_dim, M, args.rope_theta)
    cos_row, sin_row = np.array(cos)[pos : pos + 1], np.array(sin)[pos : pos + 1]
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)

    jx, jk, jv = j_decode_layers(
        {n: jnp.asarray(a) for n, a in jlayers.items()}, jnp.asarray(x),
        jnp.int32(pos), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cos_row), jnp.asarray(sin_row), interpret=True, **kw)

    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    before = decode_layers.launches
    tx, tk2, tv2 = decode_layers(tlayers, torch.from_numpy(x), pos, tk, tv,
                                 torch.from_numpy(cos_row),
                                 torch.from_numpy(sin_row), **kw)
    assert decode_layers.launches == before  # CPU: plain version, no launch
    assert tk2 is tk and tv2 is tv  # the caches are updated in place
    assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-4, atol=1e-4)
    assert_allclose(tk.numpy()[:, :, pos], np.asarray(jk)[:, :, pos], rtol=2e-4, atol=1e-4)
    assert_allclose(tv.numpy()[:, :, pos], np.asarray(jv)[:, :, pos], rtol=2e-4, atol=1e-4)
    others = np.arange(M) != pos
    np.testing.assert_array_equal(tk.numpy()[:, :, others], kc[:, :, others])
    np.testing.assert_array_equal(tv.numpy()[:, :, others], vc[:, :, others])


def test_decode_layers_never_reads_row_pos(rng):
    """Row pos of the cache may hold anything (a padded prefill tail, a stale
    slot): the output must not depend on it."""
    args, _, tlayers = _fused_layers("test-tiny", seed=3)
    M, pos = args.max_seq_len, 9
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)
    kc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, args.dim)).astype(np.float32))
    cos, sin = torch.ones(1, args.head_dim // 2), torch.zeros(1, args.head_dim // 2)
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    a = decode_layers_plain(tlayers, x, pos, kc.clone(), vc.clone(), cos, sin, **kw)[0]
    kc[:, :, pos] = 1e4
    vc[:, :, pos] = -1e4
    b = decode_layers_plain(tlayers, x, pos, kc, vc, cos, sin, **kw)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_layers_rejects_bad_args():
    args, _, tlayers = _fused_layers("test-tiny", seed=3)
    M = args.max_seq_len
    kc = torch.zeros(args.n_layers, args.kv_heads, M, args.head_dim)
    x = torch.zeros(1, args.dim)
    row = torch.zeros(1, args.head_dim // 2)
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    with pytest.raises(ValueError, match="pos"):
        decode_layers(tlayers, x, M, kc, kc.clone(), row, row, **kw)
    with pytest.raises(ValueError, match="x must be"):
        decode_layers(tlayers, torch.zeros(2, args.dim), 0, kc, kc.clone(), row, row, **kw)
    with pytest.raises(ValueError, match="caches"):
        decode_layers(tlayers, x, 0, kc[:, :1], kc[:, :1].clone(), row, row, **kw)
