"""The port's float16 path on the CPU against the JAX package.

The JAX package accepts `dtype="float16"` (`tests/test_dtype.py`) and runs
it through the same Pallas kernels as bf16.  Each kernel wrapper runs its
plain PyTorch version on CPU tensors; here it is held against the JAX
function run as the JAX tests run it (the Pallas kernels in interpret
mode), on the same inputs made with numpy from a seed: the greedy head
(exact tokens and ties), flash prefill, the decode step against the
streamed TPU layout (float16 weights, and int8 weights under float16
activations, where `_wdot` rounds the activation to bf16), and paged
attention over float16 pools in its three modes.  Then the whole float16
engine against the JAX float16 engine, and its parameter trees (float and
int8) carried over bit for bit.

Tolerances: float16 keeps 11 significant bits (one ulp is 2^-11 relative).
Kernels whose only rounding is their float16 output agree to 2e-3 (about
two ulps: the f32 sums run in other orders, so a value near a rounding
boundary may round the other way).  The decode step rounds at many points
over two layers: 3e-2, the bf16 decode tolerance of tests/test_torch_bf16.py
(int8 under float16 rounds the activation to bf16).  Engine logits: the
float16 envelope of tests/test_dtype.py, 0.02 x max(1, max |logits|).
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
from llama3np_tpu_torch.ops.kernels.paged_attention import (
    paged_attention, paged_attention_plain)

torch.set_num_threads(1)

F16 = torch.float16
OUT_TOL = dict(rtol=2e-3, atol=2e-3)     # one float16 rounding of an f32 result
DECODE_TOL = dict(rtol=3e-2, atol=3e-2)  # many roundings over two layers
LOGITS_ENVELOPE = 2e-2                   # x max(1, max |logits|): tests/test_dtype.py
PRESETS = ["test-tiny", "test-tiny-mha"]


def f16_pair(a: np.ndarray):
    """One f32 array as a float16 torch tensor and a float16 JAX array (both
    round to nearest even: the same numbers)."""
    return torch.from_numpy(a).to(F16), jnp.asarray(a, jnp.float16)


def f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# greedy head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,vs,blk", [
    (288, 32000, 3584),   # stories15M shape (tests/test_pallas.py shapes)
    (64, 1000, 384),      # vocab not a multiple of the block (masked tail)
    (128, 512, 512),      # single block
])
def test_argmax_head_f16_matches_jax(rng, d, vs, blk):
    x = rng.standard_normal((1, d)).astype(np.float32)
    w = rng.standard_normal((d, vs)).astype(np.float32)
    want = int(j_argmax_head(jnp.asarray(x), jnp.asarray(w, jnp.float16), block=blk,
                             interpret=True)[0])
    tw = torch.from_numpy(w).to(F16)
    before = argmax_head.launches
    got = argmax_head(torch.from_numpy(x), tw)
    assert argmax_head.launches == before  # CPU: plain version, no launch
    assert got.dtype == torch.int64 and tuple(got.shape) == (1,)
    assert int(got[0]) == want
    assert int(argmax_head_plain(torch.from_numpy(x), tw)[0]) == want


def test_argmax_head_f16_tie_breaks_first():
    """Exact ties in float16: across a block boundary the lower column wins,
    as in the JAX kernel; a masked tail never wins."""
    x = torch.ones(1, 4)
    w = torch.zeros(4, 600)
    w[:, 7] = 2.5
    w[:, 300] = 2.5
    assert int(argmax_head(x, w.to(F16))[0]) == 7
    want = int(j_argmax_head(jnp.ones((1, 4)), jnp.asarray(w.numpy(), jnp.float16),
                             block=256, interpret=True)[0])
    assert want == 7
    tail = torch.full((4, 600), -1.0)
    tail[:, 599] = -0.5
    assert int(argmax_head(x, tail.to(F16))[0]) == 599


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nh,kvh,hd,bq,bk", [
    (32, 4, 2, 16, 16, 16),   # GQA, multiple blocks
    (64, 2, 2, 32, 32, 16),   # MHA, asymmetric blocks
    (16, 3, 1, 8, 16, 16),    # single block, MQA
    (32, 4, 1, 128, 16, 16),  # llama3-8b head width, G=4
])
def test_flash_prefill_f16_matches_jax(rng, L, nh, kvh, hd, bq, bk):
    B = 2
    q, jq = f16_pair(rng.standard_normal((B, L, nh, hd)).astype(np.float32))
    k, jk = f16_pair(rng.standard_normal((B, L, kvh, hd)).astype(np.float32))
    v, jv = f16_pair(rng.standard_normal((B, L, kvh, hd)).astype(np.float32))
    want = j_flash_prefill(jq, jk, jv, q_block=bq, kv_block=bk, interpret=True)
    assert want.dtype == jnp.float16
    before = flash_prefill.launches
    got = flash_prefill(q, k, v)
    assert flash_prefill.launches == before
    assert got.dtype == F16
    assert_allclose(f32(got), f32(want), **OUT_TOL)


# ---------------------------------------------------------------------------
# decode step against the streamed (8B-class) TPU layout
# ---------------------------------------------------------------------------

STREAM = {"test-tiny": (32, 16, 32, 32), "test-tiny-mha": (24, 16, 24, 48)}


def grid_weights(args, seed):
    """Synthetic weights snapped per output channel onto an int8 grid (the
    rule of tests/test_quant.py): the JAX streamed tree's per-(block,
    column) scales and the port's per-column scales then hold the same
    weights."""
    out = {}
    for k, v in jsynth(args, seed).items():
        if v.ndim == 2:
            s = np.maximum(np.abs(v).max(axis=-1, keepdims=True) / 127.0, 1e-12)
            v = (np.clip(np.rint(v / s), -127, 127) * s).astype(np.float32)
        out[k] = v
    return out


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("where", ["first", "mid", "last"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_layers_f16_matches_jax_streamed(rng, name, where, quant):
    """The port's float16 decode step (whole-layer tree; float16 weights, or
    int8 weights under float16 activations) against the JAX streamed kernel
    in interpret mode (KV-head-grouped, FFN-blocked tree of the same
    weights, with a `stream_plan`)."""
    args = jpreset(name, dtype="float16", kv_dtype="float16", quant=quant)
    plan = STREAM[name]
    w = grid_weights(args, seed=11) if quant else jsynth(args, seed=11)
    jtree = jckpt.fuse_param_tree(
        jckpt.permute_rope_layout(jckpt.build_param_tree(w, args), args), plan[3],
        attn_group=True, n_heads=args.n_heads, kv_heads=args.kv_heads,
        head_dim=args.head_dim)
    if quant:
        jtree = jckpt.quantize_param_tree(jtree)
    jlayers = {k: jnp.asarray(v, jnp.float16 if np.asarray(v).dtype == np.float32
                              and not k.endswith("_scale") else None)
               for k, v in jtree["layers"].items()}
    targs = preset(name, dtype="float16", quant=quant)
    ttree = tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs))
    if quant:
        ttree = tckpt.quantize_param_tree(ttree)
    tlayers = tckpt.params_to_device(ttree, "cpu", "float16")["layers"]
    assert tlayers["wqkv"].dtype == (torch.int8 if quant else F16)
    assert tlayers["attn_norm"].dtype == F16

    M = args.max_seq_len
    pos = {"first": 0, "mid": M // 2 - 3, "last": M - 1}[where]
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)
    tk, jk = f16_pair(rng.standard_normal(shape).astype(np.float32))
    tv, jv = f16_pair(rng.standard_normal(shape).astype(np.float32))
    tx, jx = f16_pair(rng.standard_normal((1, args.dim)).astype(np.float32))
    cos, sin = j_rope_tables(args.head_dim, M, args.rope_theta)
    cos_row, sin_row = np.array(cos)[pos : pos + 1], np.array(sin)[pos : pos + 1]
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)

    jx_out, jk2, jv2 = j_decode_layers(
        jlayers, jx, jnp.int32(pos), jk, jv, jnp.asarray(cos_row),
        jnp.asarray(sin_row), interpret=True, stream_plan=plan, **kw)
    assert jx_out.dtype == jnp.float16
    k0, v0 = tk.clone(), tv.clone()
    before = decode_layers.launches
    x_out, tk2, tv2 = decode_layers(tlayers, tx, pos, tk, tv,
                                    torch.from_numpy(cos_row),
                                    torch.from_numpy(sin_row), **kw)
    assert decode_layers.launches == before
    assert tk2 is tk and x_out.dtype == F16 and tk.dtype == F16
    assert_allclose(f32(x_out), f32(jx_out), **DECODE_TOL)
    assert_allclose(f32(tk[:, :, pos]), f32(jk2)[:, :, pos], **DECODE_TOL)
    assert_allclose(f32(tv[:, :, pos]), f32(jv2)[:, :, pos], **DECODE_TOL)
    others = torch.arange(M) != pos
    assert torch.equal(tk[:, :, others], k0[:, :, others])
    assert torch.equal(tv[:, :, others], v0[:, :, others])


def test_decode_int8_under_f16_rounds_the_activation_to_bf16(rng):
    """`_wdot`'s rule: an int8 weight sees the activation rounded to bf16,
    whatever the activation dtype, so an int8 layer under float16 and under
    bf16 activations takes the same products; a float16 weight sees it
    rounded to float16."""
    from llama3np_tpu_torch.ops.kernels.decode_step import _weight_input

    a = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    w8 = torch.zeros(64, 8, dtype=torch.int8)
    assert torch.equal(_weight_input(a, w8, F16), a.to(torch.bfloat16).float())
    assert torch.equal(_weight_input(a, w8, torch.bfloat16), a.to(torch.bfloat16).float())
    assert torch.equal(_weight_input(a, w8, torch.float32), a)
    assert torch.equal(_weight_input(a, w8.to(F16), F16), a.to(F16).float())


# ---------------------------------------------------------------------------
# paged attention over float16 pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "stacked", "window0", "window1", "window4"])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 2, 32), (8, 2, 16), (4, 1, 128)])
def test_paged_attention_f16_matches_jax(rng, mode, nh, kvh, hd):
    """float16 pools, q and rows in the three modes (window count 0, partial
    and full), against the JAX kernel in interpret mode: ragged rows, a row
    at pos 0, one ending on a page boundary, shuffled block tables with
    null-page padding."""
    NL, B, P, maxp, page, Q, li = 2, 3, 17, 4, 8, 4, 1
    q, jq = f16_pair(rng.standard_normal((B, 1, nh, hd)).astype(np.float32))
    kp, jkp = f16_pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32))
    vp, jvp = f16_pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32))
    ck, jck = f16_pair(rng.standard_normal((B, kvh, hd)).astype(np.float32))
    cv, jcv = f16_pair(rng.standard_normal((B, kvh, hd)).astype(np.float32))
    wk, jwk = f16_pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32))
    wv, jwv = f16_pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32))
    bt = rng.permutation(np.arange(1, P))[: B * maxp].reshape(B, maxp).astype(np.int32)
    if mode == "plain":
        pos = np.array([0, 2 * page - 1, maxp * page - 1], np.int32)
        bt[0, 1:], bt[1, 2:] = 0, 0
        want = j_paged_attention(jq, jkp[li], jvp[li], jnp.asarray(bt),
                                 jnp.asarray(pos), interpret=True)
        got = paged_attention(q, kp[li], vp[li], torch.from_numpy(bt),
                              torch.from_numpy(pos))
    else:
        pos = np.array([0, page, maxp * page - Q], np.int32)
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
    assert want.dtype == jnp.float16 and got.dtype == F16
    assert_allclose(f32(got), f32(want), **OUT_TOL)


def test_paged_plain_f16_is_f32_math_rounded_once(rng):
    """The twin widens a float16 q and rows to f32 and rounds once: it
    equals the float32 function of the same (float16-representable) numbers
    rounded to float16."""
    B, nh, kvh, hd, P, page, maxp = 2, 4, 2, 16, 9, 4, 3
    q = torch.from_numpy(rng.standard_normal((B, 1, nh, hd)).astype(np.float32)).to(F16)
    kp = torch.from_numpy(rng.standard_normal((P, kvh, page, hd)).astype(np.float32)).to(F16)
    vp = torch.from_numpy(rng.standard_normal((P, kvh, page, hd)).astype(np.float32)).to(F16)
    bt = torch.tensor([[3, 5, 0], [1, 2, 7]], dtype=torch.int32)
    pos = torch.tensor([5, 10], dtype=torch.int32)
    got = paged_attention_plain(q, kp, vp, bt, pos)
    want = paged_attention_plain(q.float(), kp.float(), vp.float(), bt, pos).to(F16)
    assert got.dtype == F16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def engines(name, seed=7, **kw):
    w = jsynth(jpreset(name), seed=seed)
    return (w, JLlama(w, jpreset(name, dtype="float16", pallas_ffn_block=0, **kw)),
            Llama(w, preset(name, dtype="float16", **kw), device="cpu"))


def assert_in_envelope(got, want):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGITS_ENVELOPE * max(1.0, np.abs(want).max())
    assert (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).all()


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("quant", [None, "int8"])
def test_params_from_jax_f16_tree_is_bit_exact(name, quant):
    """The JAX engine's float16 tree (float, or int8 with f32 scales under
    float16 norms) carries over bit for bit.  A float tree also equals the
    port's own; an int8 one is quantized by the JAX engine from the
    float16-rounded weights, by the port from the f32 ones (ROADMAP C3)."""
    _, jeng, teng = engines(name, quant=quant)
    jtree = jax.tree.map(np.asarray, jeng.params)
    carried = params_from_jax(jtree, "cpu")
    assert carried.keys() == teng.params.keys()
    assert carried["norm"].dtype == teng.params["norm"].dtype == F16
    for key, leaf in teng.params.items():
        pairs = leaf.items() if isinstance(leaf, dict) else [(key, leaf)]
        for k, v in pairs:
            c = carried["layers"][k] if isinstance(leaf, dict) else carried[k]
            j = jtree["layers"][k] if isinstance(leaf, dict) else jtree[k]
            assert c.dtype == v.dtype, k
            assert str(j.dtype) == str(c.dtype).replace("torch.", ""), k
            assert np.array_equal(c.numpy(), j), k
            if not quant:
                assert torch.equal(c, v), k


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("quant", [None, "int8"])
def test_f16_engine_matches_jax(name, quant, rng):
    """Last-prompt logits and single-token decode logits within the float16
    envelope with top-1 equal, and the same 10-token greedy stream."""
    _, jeng, teng = engines(name, quant=quant)
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 6)).astype(np.int32)
    assert_in_envelope(teng(ids, 0), jeng(ids, 0))
    for step, tok in enumerate([5, 17, 99]):
        nxt = np.array([[tok]], np.int32)
        assert_in_envelope(teng(nxt, 6 + step), jeng(nxt, 6 + step))
    got = teng.generate_tokens(ids, 10)
    assert teng.cache["k"].dtype == F16
    assert got[0].tolist() == np.asarray(jeng.generate_tokens(ids, 10))[0].tolist()
