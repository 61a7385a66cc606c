"""The `kv_dtype` override on the CPU against the JAX package: a float KV
cache of another dtype than the activations' (float32 over a bf16 cache,
the case tests/test_dtype.py runs, and every other ordered pair of
float32, bfloat16 and float16).

Each kernel wrapper runs its plain PyTorch version on CPU tensors; here it
is held against the JAX kernel run as the JAX tests run it (the Pallas
kernels in interpret mode), on the same inputs made with numpy from a
seed: the decode step against the whole-layer kernel (whose `_attend_head`
rounds q and the probabilities to a 16-bit cache's dtype), int8 weights
against the streamed kernel, and paged attention (f32 math, the output in
q's dtype).  Then the engine against the JAX engine, greedy and served.

Tolerances.  float32 activations: the twin rounds where the JAX kernel
does, so only f32 sums in another order differ: 1e-5 (without the
roundings the outputs part by ~1e-4).  16-bit activations: two ulps of the
output (bf16 1e-2, float16 2e-3).  int8 weights against the streamed
kernel: tests/test_torch_bf16.py's 3e-2 (the streamed kernel rounds
neither q nor P, and rounds a float32 activation to bf16 before an int8
product).  Engine logits: 2e-2 x max(1, max |logits|), a seventh of
tests/test_dtype.py's fp32-vs-bf16 envelope (both sides compute in the
same dtypes here); greedy streams equal.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.ops.core import rope_tables as j_rope_tables
from llama3np_tpu.ops.kernels.decode_step import decode_layers as j_decode_layers
from llama3np_tpu.ops.kernels.paged_attention import (
    paged_attention as j_paged_attention)
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.ops.kernels import decode_step
from llama3np_tpu_torch.ops.kernels.decode_step import decode_layers
from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

PAIRS = [("float32", "bfloat16"), ("float32", "float16"), ("bfloat16", "float32"),
         ("bfloat16", "float16"), ("float16", "float32"), ("float16", "bfloat16")]
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2),
       "float16": dict(rtol=2e-3, atol=2e-3)}
STREAMED_TOL = dict(rtol=3e-2, atol=3e-2)
LOGITS_ENVELOPE = 2e-2
STREAM = (32, 16, 32, 32)  # the JAX streamed plan for test-tiny


def f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def pair(a: np.ndarray, dtype: str):
    """One f32 array as a torch tensor and a JAX array of `dtype` (both
    round to nearest even: the same numbers)."""
    return torch.from_numpy(a).to(TD[dtype]), jnp.asarray(a, JD[dtype])


def decode_inputs(rng, args, pos, act, kv):
    M = args.max_seq_len
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)
    tk, jk = pair(rng.standard_normal(shape).astype(np.float32), kv)
    tv, jv = pair(rng.standard_normal(shape).astype(np.float32), kv)
    tx, jx = pair(rng.standard_normal((1, args.dim)).astype(np.float32), act)
    cos, sin = j_rope_tables(args.head_dim, M, args.rope_theta)
    rows = np.array(cos)[pos : pos + 1], np.array(sin)[pos : pos + 1]
    return (tk, tv, tx), (jk, jv, jx), rows


def check_decode(tout, jout, tk, k0, pos, tol):
    x_out, tk2, tv2 = tout
    jx_out, jk2, jv2 = jout
    assert x_out.dtype == tout[0].dtype and tk2.dtype == k0.dtype
    assert_allclose(f32(x_out), f32(jx_out), **tol)
    assert_allclose(f32(tk2[:, :, pos]), f32(jk2)[:, :, pos], **tol)
    assert_allclose(f32(tv2[:, :, pos]), f32(jv2)[:, :, pos], **tol)
    others = torch.arange(k0.shape[2]) != pos
    assert torch.equal(tk[:, :, others], k0[:, :, others])


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,kv", PAIRS)
@pytest.mark.parametrize("where", ["mid", "last"])
def test_decode_layers_kv_override_matches_jax(rng, act, kv, where):
    """Float weights in the activation dtype over a cache of `kv`: the
    port's decode step (CPU: its plain version) against the JAX whole-layer
    kernel in interpret mode."""
    args = jpreset("test-tiny", dtype=act, kv_dtype=kv)
    w = jsynth(jpreset("test-tiny"), seed=5)
    jtree = jckpt.fuse_param_tree(jckpt.permute_rope_layout(
        jckpt.build_param_tree(w, args), args))
    jlayers = {n: jnp.asarray(a) for n, a in jtree["layers"].items()}
    targs = tpreset("test-tiny", dtype=act, kv_dtype=kv)
    tlayers = tckpt.params_to_device(tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs)), "cpu", act)["layers"]
    pos = {"mid": args.max_seq_len // 2 - 3, "last": args.max_seq_len - 1}[where]
    (tk, tv, tx), (jk, jv, jx), (cos_row, sin_row) = decode_inputs(rng, args, pos, act, kv)
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    jout = j_decode_layers(jlayers, jx, jnp.int32(pos), jk, jv, jnp.asarray(cos_row),
                           jnp.asarray(sin_row), interpret=True, **kw)
    k0 = tk.clone()
    before = decode_layers.launches
    tout = decode_layers(tlayers, tx, pos, tk, tv, torch.from_numpy(cos_row),
                         torch.from_numpy(sin_row), **kw)
    assert decode_layers.launches == before  # CPU: the plain version
    assert tout[1] is tk  # the caches are updated in place
    check_decode(tout, jout, tk, k0, pos, TOL[act])


def test_decode_layers_kv_override_rounds_q_and_p(rng):
    """float32 activations over a bf16 cache: the twin's roundings of q
    and of the probabilities are what brings it to the JAX kernel; the same
    twin without them parts by more than the f32 tolerance."""
    args = tpreset("test-tiny", kv_dtype="bfloat16")
    tree = tckpt.params_to_device(tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(jsynth(jpreset("test-tiny"), seed=5), args), args)),
        "cpu")["layers"]
    pos = args.max_seq_len - 1
    (tk, tv, tx), _, (cos_row, sin_row) = decode_inputs(rng, args, pos, "float32",
                                                        "bfloat16")
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    rows = torch.from_numpy(cos_row), torch.from_numpy(sin_row)
    rounded = decode_layers(tree, tx, pos, tk.clone(), tv.clone(), *rows, **kw)[0]
    # The same cache widened to f32: no rounding point applies.
    plain = decode_layers(tree, tx, pos, tk.float(), tv.float(), *rows, **kw)[0]
    assert not np.allclose(f32(rounded), f32(plain), **TOL["float32"])


@pytest.mark.parametrize("act,kv", PAIRS)
def test_decode_layers_int8_kv_override_matches_jax_streamed(rng, act, kv):
    """int8 weights under `act` activations over a cache of `kv`: the
    port's decode step against the JAX streamed kernel (the only layout
    with int8 scales) in interpret mode, on int8-grid weights."""
    from tests.test_torch_decode_schedule import grid_weights

    args = jpreset("test-tiny", dtype=act, kv_dtype=kv, quant="int8")
    w = grid_weights(args, seed=13)
    jtree = jckpt.fuse_param_tree(
        jckpt.permute_rope_layout(jckpt.build_param_tree(w, args), args), STREAM[3],
        attn_group=True, n_heads=args.n_heads, kv_heads=args.kv_heads,
        head_dim=args.head_dim)
    jlayers = {k: jnp.asarray(v, JD[act] if np.asarray(v).dtype.kind == "f"
                              and not k.endswith("_scale") else None)
               for k, v in jckpt.quantize_param_tree(jtree)["layers"].items()}
    targs = tpreset("test-tiny", dtype=act, kv_dtype=kv, quant="int8")
    ttree = tckpt.quantize_param_tree(tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs)))
    tlayers = tckpt.params_to_device(ttree, "cpu", act)["layers"]
    assert tlayers["wqkv"].dtype == torch.int8
    pos = args.max_seq_len // 2 - 3
    (tk, tv, tx), (jk, jv, jx), (cos_row, sin_row) = decode_inputs(rng, args, pos, act, kv)
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads,
              head_dim=args.head_dim, norm_eps=args.norm_eps)
    jout = j_decode_layers(jlayers, jx, jnp.int32(pos), jk, jv, jnp.asarray(cos_row),
                           jnp.asarray(sin_row), interpret=True, stream_plan=STREAM, **kw)
    k0 = tk.clone()
    tout = decode_layers(tlayers, tx, pos, tk, tv, torch.from_numpy(cos_row),
                         torch.from_numpy(sin_row), **kw)
    check_decode(tout, jout, tk, k0, pos, STREAMED_TOL)


def test_decode_entries_cover_every_mode():
    """Every (weight, activation, cache) mode has its own C entry: float
    weights in the activation dtype or int8, any float cache."""
    entries = decode_step._ENTRIES
    assert len(entries) == 18 and len(set(entries.values())) == 18
    assert entries[torch.float32, torch.float32, torch.bfloat16] == \
        "l3t_decode_layers_f32_kv_bf16"
    assert entries[torch.int8, torch.bfloat16, torch.float32] == \
        "l3t_decode_layers_i8_bf16_kv_f32"
    assert entries[torch.int8, torch.float32, torch.float32] == "l3t_decode_layers_i8"


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,kv,mode", [(a, k, "window2") for a, k in PAIRS] + [
    ("float32", "bfloat16", "plain"), ("float32", "bfloat16", "stacked")])
def test_paged_attention_kv_override_matches_jax(rng, act, kv, mode):
    """Pools, the current rows and the window of `kv` under a q of `act`,
    against the JAX kernel in interpret mode: ragged rows, an empty row,
    shuffled block tables with null-page padding (the window mode for
    every pair: the stacked mode's pools and current column plus two window
    columns; the plain and stacked modes for the float32-over-bf16 pair)."""
    NL, B, P, maxp, page, Q, li, nh, kvh, hd = 2, 3, 17, 4, 8, 4, 1, 4, 2, 32
    q, jq = pair(rng.standard_normal((B, 1, nh, hd)).astype(np.float32), act)
    kp, jkp = pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32), kv)
    vp, jvp = pair(rng.standard_normal((NL, P, kvh, page, hd)).astype(np.float32), kv)
    ck, jck = pair(rng.standard_normal((B, kvh, hd)).astype(np.float32), kv)
    cv, jcv = pair(rng.standard_normal((B, kvh, hd)).astype(np.float32), kv)
    wk, jwk = pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32), kv)
    wv, jwv = pair(rng.standard_normal((B, kvh, Q, hd)).astype(np.float32), kv)
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
        jkw, tkw = dict(layer=li, cur_k=jck, cur_v=jcv), dict(layer=li, cur_k=ck, cur_v=cv)
        if mode != "stacked":
            jkw.update(win_k=jwk, win_v=jwv, win_count=jnp.int32(2))
            tkw.update(win_k=wk, win_v=wv, win_count=2)
        want = j_paged_attention(jq, jkp, jvp, jnp.asarray(bt), jnp.asarray(pos),
                                 interpret=True, **jkw)
        got = paged_attention(q, kp, vp, torch.from_numpy(bt), torch.from_numpy(pos),
                              **tkw)
    assert want.dtype == JD[act] and got.dtype == TD[act]
    assert_allclose(f32(got), f32(want), **{"float32": dict(rtol=2e-4, atol=1e-5)}.get(
        act, TOL[act]))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def assert_in_envelope(got, want):
    got, want = f32(got), f32(want)
    assert np.abs(got - want).max() <= LOGITS_ENVELOPE * max(1.0, np.abs(want).max())
    assert (got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).all()


def with_wrappers(eng):
    """The engine on its kernel path, whose wrappers run their plain
    versions on CPU tensors: flash prefill, the decode step, the greedy
    head, paged attention."""
    eng.cfg = eng.cfg._replace(kernels=True)
    eng._gen = None
    return eng


@pytest.mark.parametrize("act,kv", [("float32", "bfloat16"), ("bfloat16", "float32"),
                                    ("float16", "bfloat16")])
def test_kv_override_engine_matches_jax(act, kv, rng):
    """The engine with the override against the JAX engine (both plain on
    the CPU): last-prompt and single-token decode logits within the
    envelope with top-1 equal, the cache in `kv`, the same greedy stream."""
    w = jsynth(jpreset("test-tiny"), seed=3)
    jeng = JLlama(w, jpreset("test-tiny", dtype=act, kv_dtype=kv))
    teng = Llama(w, tpreset("test-tiny", dtype=act, kv_dtype=kv), device="cpu")
    assert teng.cache["k"].dtype == TD[kv]
    ids = rng.integers(3, 512, size=(1, 6)).astype(np.int32)
    assert_in_envelope(teng(ids, 0), jeng(ids, 0))
    for step, tok in enumerate([5, 17]):
        nxt = np.array([[tok]], np.int32)
        assert_in_envelope(teng(nxt, 6 + step), jeng(nxt, 6 + step))
    want = np.asarray(jeng.generate_tokens(ids, 10))[0].tolist()
    assert teng.generate_tokens(ids, 10)[0].tolist() == want


@pytest.mark.parametrize("act,kv", [("float32", "bfloat16"), ("bfloat16", "float32")])
def test_kv_override_kernel_path_matches_jax_kernels(act, kv, rng):
    """The engine's kernel path (its wrappers' plain versions) against the
    JAX engine on its kernels (attn_impl="pallas": the whole-layer decode
    kernel in interpret mode): the same greedy stream, through the decode
    step once a token."""
    w = jsynth(jpreset("test-tiny"), seed=3)
    jeng = JLlama(w, jpreset("test-tiny", dtype=act, kv_dtype=kv, attn_impl="pallas"))
    teng = with_wrappers(Llama(w, tpreset("test-tiny", dtype=act, kv_dtype=kv),
                               device="cpu"))
    ids = rng.integers(3, 512, size=(1, 5)).astype(np.int32)
    calls = []
    real = decode_step.decode_layers_plain
    decode_step.decode_layers_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = teng.generate_tokens(ids, 6)[0].tolist()
    finally:
        decode_step.decode_layers_plain = real
    assert len(calls) == 5 and teng.cache["k"].dtype == TD[kv]
    assert got == np.asarray(jeng.generate_tokens(ids, 6))[0].tolist()


SERVE_WORK = [(n, b) for n, b in ((4, 8), (9, 6), (6, 9), (13, 7))]


def serve_streams(cls, eng, quantum, seed=1, vocab=512):
    rng = np.random.default_rng(seed)
    work = [(rng.integers(3, vocab, size=n).tolist(), b) for n, b in SERVE_WORK]
    be = cls(eng, capacity=3, paged=True, page_size=8)
    reqs = [be.submit(p, b) for p, b in work[:3]]
    be.step(quantum)
    reqs += [be.submit(p, b) for p, b in work[3:]]
    while be.num_active or be._queue:
        be.step(quantum)
    assert be.allocator.available == be.allocator.num_pages - 1
    return be.cache["k"].dtype, [list(r.generated) for r in reqs]


@pytest.mark.parametrize("quantum", [1, 3])
def test_kv_override_serving_matches_jax(quantum):
    """float32 activations over bf16 pools: the port's paged `BatchEngine`
    (plain, and on its kernel path: the paged wrapper's plain version)
    against the JAX `BatchEngine`: the pools in bf16, the same streams."""
    w = jsynth(jpreset("test-tiny"), seed=23)
    jdt, want = serve_streams(JBatchEngine, JLlama(
        w, jpreset("test-tiny", kv_dtype="bfloat16")), quantum)
    targs = tpreset("test-tiny", kv_dtype="bfloat16")
    tdt, got = serve_streams(BatchEngine, Llama(w, targs, device="cpu"), quantum)
    assert jdt == jnp.bfloat16 and tdt == torch.bfloat16
    assert got == want
    before = paged_attention.launches
    _, kern = serve_streams(BatchEngine, with_wrappers(Llama(w, targs, device="cpu")),
                            quantum)
    assert paged_attention.launches == before  # CPU: the plain version
    assert kern == want
