"""The port's bf16 path on the CPU against the JAX package.

Each kernel wrapper runs its plain PyTorch version on CPU tensors; here it
is held against the JAX function run as the JAX tests run it (the Pallas
kernels in interpret mode), on the same inputs made with numpy from a
seed: the greedy head (exact tokens), flash prefill, the decode step
against the streamed TPU layout (the 8B-class layout whose rounding points
the bf16 decode kernel follows) and paged attention in its three modes.
Then the whole bf16 engine against the JAX bf16 engine, its parameter
tree carried over bit for bit, and a bf16 `BatchEngine` against its
capacity-1 streams.

Tolerances: bf16 keeps 8 significant bits (one ulp is 2^-8 relative, up to
2^-7 just above a power of two).  Kernels whose only rounding is their bf16
output agree to 1e-2 (about two ulps: the f32 sums run in other orders, so
a value near a rounding boundary may round the other way).  The decode
step rounds at many points over two layers, so 1-ulp flips propagate: 3e-2,
inside the 5e-2 that tests/test_pallas.py sets for the same kernel against
the XLA scan.  Engine logits: 2e-2 x max(1, max |logits|), a seventh of
tests/test_dtype.py's fp32-vs-bf16 envelope (both sides are bf16 here).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.ops.core import rope_tables as j_rope_tables
from llama3np_tpu.ops.kernels.decode_step import decode_layers as j_decode_layers
from llama3np_tpu.ops.kernels.flash_prefill import flash_prefill as j_flash_prefill
from llama3np_tpu.ops.kernels.greedy_head import argmax_head as j_argmax_head
from llama3np_tpu.ops.kernels.paged_attention import (
    paged_attention as j_paged_attention)
from llama3np_tpu_torch import Llama, argmax_head, params_from_jax, preset
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch.ops.kernels.decode_step import decode_layers
from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill
from llama3np_tpu_torch.ops.kernels.greedy_head import argmax_head_plain
from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

BF16 = torch.bfloat16
OUT_TOL = dict(rtol=1e-2, atol=1e-2)     # one bf16 rounding of an f32 result
DECODE_TOL = dict(rtol=3e-2, atol=3e-2)  # many roundings over two layers
LOGITS_ENVELOPE = 2e-2                   # x max(1, max |logits|)
PRESETS = ["test-tiny", "test-tiny-mha"]


def bf16_pair(a: np.ndarray):
    """One f32 array as a bf16 torch tensor and a bf16 JAX array (both
    round to nearest even: the same numbers)."""
    return torch.from_numpy(a).to(BF16), jnp.asarray(a, jnp.bfloat16)


def f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# greedy head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,vs,blk", [
    (288, 32000, 3584),   # stories15M shape (tests/test_pallas.py shapes)
    (64, 1000, 384),      # vocab not a multiple of the block (masked tail)
    (128, 512, 512),      # single block
])
def test_argmax_head_matches_jax(rng, dtype, d, vs, blk):
    x = rng.standard_normal((1, d)).astype(np.float32)
    w = rng.standard_normal((d, vs)).astype(np.float32)
    jw = jnp.asarray(w, jnp.dtype(dtype))
    want = int(j_argmax_head(jnp.asarray(x), jw, block=blk, interpret=True)[0])
    tw = torch.from_numpy(w).to(tckpt.torch_dtype(dtype))
    before = argmax_head.launches
    got = argmax_head(torch.from_numpy(x), tw)
    assert argmax_head.launches == before  # CPU: plain version, no launch
    assert got.dtype == torch.int64 and tuple(got.shape) == (1,)
    assert int(got[0]) == want
    assert int(argmax_head_plain(torch.from_numpy(x), tw)[0]) == want


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_argmax_head_tie_breaks_first(dtype):
    """np.argmax tie order across a block boundary (tests/test_pallas.py
    :206-215), and a masked tail that must not win."""
    x = torch.ones(1, 4)
    w = torch.zeros(4, 600)
    w[:, 7] = 2.5
    w[:, 300] = 2.5
    assert int(argmax_head(x, w.to(dtype))[0]) == 7
    want = int(j_argmax_head(jnp.ones((1, 4)), jnp.asarray(w.numpy(), jnp.dtype(
        "bfloat16" if dtype == BF16 else "float32")), block=256, interpret=True)[0])
    assert want == 7
    tail = torch.full((4, 600), -1.0)
    tail[:, 599] = -0.5  # the last real column wins over the padded tail
    assert int(argmax_head(x, tail.to(dtype))[0]) == 599


def test_argmax_head_rejects_bad_shapes():
    with pytest.raises(ValueError):
        argmax_head(torch.zeros(2, 8), torch.zeros(8, 16))
    with pytest.raises(ValueError):
        argmax_head(torch.zeros(1, 8), torch.zeros(9, 16))


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nh,kvh,hd,bq,bk", [
    (32, 4, 2, 16, 16, 16),   # GQA, multiple blocks
    (64, 2, 2, 32, 32, 16),   # MHA, asymmetric blocks
    (16, 3, 1, 8, 16, 16),    # single block, MQA
    (32, 4, 1, 128, 16, 16),  # llama3-8b head width, G=4
])
def test_flash_prefill_bf16_matches_jax(rng, L, nh, kvh, hd, bq, bk):
    B = 2
    q, jq = bf16_pair(rng.standard_normal((B, L, nh, hd)).astype(np.float32))
    k, jk = bf16_pair(rng.standard_normal((B, L, kvh, hd)).astype(np.float32))
    v, jv = bf16_pair(rng.standard_normal((B, L, kvh, hd)).astype(np.float32))
    want = j_flash_prefill(jq, jk, jv, q_block=bq, kv_block=bk, interpret=True)
    assert want.dtype == jnp.bfloat16
    before = flash_prefill.launches
    got = flash_prefill(q, k, v)
    assert flash_prefill.launches == before
    assert got.dtype == BF16
    assert_allclose(f32(got), f32(want), **OUT_TOL)


# ---------------------------------------------------------------------------
# decode step against the streamed (8B-class) TPU layout
# ---------------------------------------------------------------------------

STREAM = {"test-tiny": (32, 16, 32, 32), "test-tiny-mha": (24, 16, 24, 48)}


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_layers_bf16_matches_jax_streamed(rng, name, where):
    """The port's bf16 decode step (whole-layer tree) against the JAX
    streamed kernel in interpret mode (KV-head-grouped, FFN-blocked tree of
    the same weights, set up as tests/test_pallas.py:123-184 does)."""
    args = jpreset(name, dtype="bfloat16", kv_dtype="bfloat16")
    plan = STREAM[name]
    w = jsynth(args, seed=11)
    jparams = jckpt.permute_rope_layout(jckpt.build_param_tree(w, args), args)
    jtree = jckpt.fuse_param_tree(jparams, plan[3], attn_group=True,
                                  n_heads=args.n_heads, kv_heads=args.kv_heads,
                                  head_dim=args.head_dim)
    jlayers = jax.tree.map(lambda a: jnp.asarray(
        a, jnp.bfloat16 if np.asarray(a).dtype == np.float32 else None), jtree["layers"])
    targs = preset(name, dtype="bfloat16")
    ttree = tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs))
    tlayers = tckpt.params_to_device(ttree, "cpu", "bfloat16")["layers"]

    M = args.max_seq_len
    pos = {"first": 0, "mid": M // 2 - 3, "last": M - 1}[where]
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)
    tk, jk = bf16_pair(rng.standard_normal(shape).astype(np.float32))
    tv, jv = bf16_pair(rng.standard_normal(shape).astype(np.float32))
    tx, jx = bf16_pair(rng.standard_normal((1, args.dim)).astype(np.float32))
    cos, sin = j_rope_tables(args.head_dim, M, args.rope_theta)
    cos_row, sin_row = np.array(cos)[pos : pos + 1], np.array(sin)[pos : pos + 1]
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)

    jx_out, jk2, jv2 = j_decode_layers(
        jlayers, jx, jnp.int32(pos), jk, jv, jnp.asarray(cos_row),
        jnp.asarray(sin_row), interpret=True, stream_plan=plan, **kw)
    k0, v0 = tk.clone(), tv.clone()
    before = decode_layers.launches
    x_out, tk2, tv2 = decode_layers(tlayers, tx, pos, tk, tv,
                                    torch.from_numpy(cos_row),
                                    torch.from_numpy(sin_row), **kw)
    assert decode_layers.launches == before
    assert tk2 is tk and x_out.dtype == BF16 and tk.dtype == BF16
    assert_allclose(f32(x_out), f32(jx_out), **DECODE_TOL)
    assert_allclose(f32(tk[:, :, pos]), f32(jk2)[:, :, pos], **DECODE_TOL)
    assert_allclose(f32(tv[:, :, pos]), f32(jv2)[:, :, pos], **DECODE_TOL)
    others = torch.arange(M) != pos
    assert torch.equal(tk[:, :, others], k0[:, :, others])
    assert torch.equal(tv[:, :, others], v0[:, :, others])


def test_decode_layers_plain_rounds_bf16_residual(rng):
    """bf16 rounding points: the output is the bf16 residual, and a float32
    tree through the same function is left unrounded."""
    args = preset("test-tiny", dtype="bfloat16")
    w = jsynth(jpreset("test-tiny"), seed=2)
    tree = tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, args), args))
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    M, hd = args.max_seq_len, args.head_dim
    kc = torch.from_numpy(rng.standard_normal(
        (args.n_layers, args.kv_heads, M, hd)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, args.dim)).astype(np.float32))
    row = torch.zeros(1, hd // 2)
    out = {}
    for dt in ("float32", "bfloat16"):
        layers = tckpt.params_to_device(tree, "cpu", dt)["layers"]
        c = kc.to(tckpt.torch_dtype(dt))
        out[dt] = decode_layers(layers, x.to(c.dtype), 5, c, c.clone(),
                                row + 1, row, **kw)[0]
    assert out["bfloat16"].dtype == BF16 and out["float32"].dtype == torch.float32
    assert_allclose(f32(out["bfloat16"]), f32(out["float32"]), rtol=5e-2, atol=5e-2)
    assert not torch.equal(out["float32"], out["float32"].to(BF16).float())


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window3"])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 2, 32), (8, 2, 16), (4, 1, 128)])
def test_paged_attention_bf16_matches_jax(rng, mode, nh, kvh, hd):
    """bf16 pools, q and rows in the three modes, against the JAX kernel
    in interpret mode: ragged rows, an empty row, shuffled block tables
    with null-page padding."""
    NL, B, P, maxp, page, Q, li = 2, 3, 17, 4, 8, 4, 1
    q, jq = bf16_pair(rng.standard_normal((B, 1, nh, hd)).astype(np.float32))
    kp, jkp = bf16_pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32))
    vp, jvp = bf16_pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32))
    ck, jck = bf16_pair(rng.standard_normal((B, kvh, hd)).astype(np.float32))
    cv, jcv = bf16_pair(rng.standard_normal((B, kvh, hd)).astype(np.float32))
    wk, jwk = bf16_pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32))
    wv, jwv = bf16_pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32))
    bt = rng.permutation(np.arange(1, P))[: B * maxp].reshape(B, maxp).astype(np.int32)
    if mode == "plain":
        pos = np.array([0, page + 3, maxp * page - 1], np.int32)
        bt[0, 1:], bt[1, 2:] = 0, 0
        want = j_paged_attention(jq, jkp[li], jvp[li], jnp.asarray(bt),
                                 jnp.asarray(pos), interpret=True)
        got = paged_attention(q, kp[li], vp[li], torch.from_numpy(bt),
                              torch.from_numpy(pos))
    else:
        pos = np.array([0, page + 3, maxp * page - Q], np.int32)
        bt[0, :], bt[1, 2:] = 0, 0
        jkw = dict(layer=li, cur_k=jck, cur_v=jcv)
        tkw = dict(layer=li, cur_k=ck, cur_v=cv)
        if mode != "stacked":
            n = int(mode[-1])
            jkw.update(win_k=jwk, win_v=jwv, win_count=jnp.int32(n))
            tkw.update(win_k=wk, win_v=wv, win_count=n)
        want = j_paged_attention(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(pos),
                                 interpret=True, **jkw)
        got = paged_attention(q, kp, vp, torch.from_numpy(bt),
                              torch.from_numpy(pos), **tkw)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert_allclose(f32(got), f32(want), **OUT_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def engines(name, seed=7):
    w = jsynth(jpreset(name), seed=seed)
    return (w, JLlama(w, jpreset(name, dtype="bfloat16", pallas_ffn_block=0)),
            Llama(w, preset(name, dtype="bfloat16"), device="cpu"))


def assert_in_envelope(got, want):
    got, want = f32(got), f32(want)
    assert np.abs(got - want).max() <= LOGITS_ENVELOPE * max(1.0, np.abs(want).max())
    assert (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).all()


@pytest.mark.parametrize("name", PRESETS)
def test_params_from_jax_bf16_tree_is_bit_exact(name):
    _, jeng, teng = engines(name)
    carried = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    assert carried.keys() == teng.params.keys()
    for key, leaf in teng.params.items():
        pairs = leaf.items() if isinstance(leaf, dict) else [(key, leaf)]
        for k, v in pairs:
            c = carried["layers"][k] if isinstance(leaf, dict) else carried[k]
            assert c.dtype == v.dtype == BF16, k
            assert torch.equal(c, v), k


@pytest.mark.parametrize("name", PRESETS)
def test_bf16_engine_matches_jax(name, rng):
    """Last-prompt logits and single-token decode logits within the bf16
    envelope with top-1 equal, and the same greedy stream."""
    _, jeng, teng = engines(name)
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 6)).astype(np.int32)
    assert_in_envelope(teng(ids, 0), jeng(ids, 0))
    for step, tok in enumerate([5, 17, 99]):
        nxt = np.array([[tok]], np.int32)
        assert_in_envelope(teng(nxt, 6 + step), jeng(nxt, 6 + step))
    got = teng.generate_tokens(ids, 10)
    assert teng.cache["k"].dtype == BF16
    assert got[0].tolist() == np.asarray(jeng.generate_tokens(ids, 10))[0].tolist()


@pytest.mark.parametrize("quantum", [1, 3])
def test_bf16_batch_engine_matches_capacity_one(quantum):
    """bf16 pools: every served stream equals the same request's stream
    from a capacity-1 engine (the schedule-independence rule)."""
    args = preset("test-tiny", dtype="bfloat16")
    eng = Llama(jsynth(jpreset("test-tiny"), seed=23), args, device="cpu")
    rng = np.random.default_rng(1)
    work = [(rng.integers(3, args.vocab_size, size=n).tolist(), b)
            for n, b in ((4, 10), (9, 7), (6, 12), (20, 9), (3, 8))]
    be = BatchEngine(eng, capacity=3, paged=True, page_size=8)
    assert be.cache["k"].dtype == BF16
    reqs = [be.submit(p, b) for p, b in work[:3]]
    be.step(quantum)
    reqs += [be.submit(p, b) for p, b in work[3:]]
    while be.num_active or be._queue:
        be.step(quantum)
    assert be.allocator.available == be.allocator.num_pages - 1
    for req, (p, b) in zip(reqs, work):
        solo = BatchEngine(eng, capacity=1, paged=True, page_size=8)
        want = solo.submit(p, b)
        solo.run_to_completion()
        assert req.generated == want.generated
