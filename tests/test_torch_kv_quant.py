"""The port's int8 KV cache (serving `kv_quant="int8"`) against the JAX
package (CPU).

Inputs are made with numpy from a seed and handed to both packages.
`quantize_kv_rows` gives equal payloads and scales; the dense and paged
attention over int8 rows agree at rtol 2e-5 / atol 1e-6 (the tolerance of
tests/test_kv_quant.py); the paged-attention wrapper on CPU tensors (its
plain version) is held against the JAX Pallas kernel in interpret mode at
rtol 2e-4 / atol 1e-4; the commits leave pools equal to JAX's; and every
int8-KV serving scenario of tests/test_kv_quant.py gives the same streams
through both `BatchEngine`s.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from llama3np_tpu import kvcache as jkv
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models import llama as jllama
from llama3np_tpu.ops import core as jops
from llama3np_tpu.ops.kernels.paged_attention import paged_attention as j_paged_kernel
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import kvcache as tkv
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.models import llama as tllama
from llama3np_tpu_torch.ops import core as tops
from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

OPS_RTOL, OPS_ATOL = 2e-5, 1e-6        # tests/test_kv_quant.py:62,104
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 1e-4  # tests/test_kv_quant.py:136
B, KVH, HD, M, PAGE, MAXP, P, NL = 3, 2, 16, 32, 8, 4, 14, 2


def t(a):
    return torch.from_numpy(np.array(a))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def q8(x):
    """JAX-quantized rows of the fp32 array x, as numpy (int8, scales)."""
    k, s = jops.quantize_kv_rows(jnp.asarray(x))
    return np.asarray(k), np.asarray(s)


def _table(rng):
    """Shuffled distinct page ids per row; unused entries -> null page 0."""
    bt = rng.permutation(np.arange(1, P))[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    bt[0, 1:] = 0
    bt[1, 3:] = 0
    return bt


def _jt(kw):
    """JAX and torch copies of a dict of numpy arrays (None stays None)."""
    return ({k: None if a is None else jnp.asarray(a) for k, a in kw.items()},
            {k: None if a is None else t(a) for k, a in kw.items()})


# ---------------------------------------------------------------------------
# quantization and the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "grid", "zero"])
def test_quantize_kv_rows_equals_jax(rng, kind):
    x = normal(rng, 4, 1, 3, 64) * 3
    if kind == "grid":  # rows on the int8 lattice (ties to even are exact)
        x = rng.integers(-127, 128, size=x.shape).astype(np.float32)
        x[..., 0] = 127
        x *= 0.5
    elif kind == "zero":
        x[1] = 0
    k8, s = tops.quantize_kv_rows(t(x))
    want_k, want_s = q8(x)
    assert k8.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(k8.numpy(), want_k)
    np.testing.assert_array_equal(s.numpy(), want_s)


@pytest.mark.parametrize("mode", ["plain", "append", "win0", "win1", "win3"])
def test_ragged_cache_attention_int8_matches_jax(rng, mode):
    nh, Q = 4, 3
    q = normal(rng, B, 1, nh, HD)
    (k8, ks), (v8, vs) = q8(normal(rng, B, KVH, M, HD)), q8(normal(rng, B, KVH, M, HD))
    pos = np.array([0, 9, M - 1], np.int32)
    kw = dict(k_scale=ks, v_scale=vs)
    if mode != "plain":
        (ck, cks), (cv, cvs) = q8(normal(rng, B, KVH, HD)), q8(normal(rng, B, KVH, HD))
        kw.update(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
    if mode.startswith("win"):
        (wk, wks), (wv, wvs) = q8(normal(rng, B, KVH, Q, HD)), q8(normal(rng, B, KVH, Q, HD))
        kw.update(win_k=wk, win_v=wv, win_ks=wks, win_vs=wvs)
    jkw, tkw = _jt(kw)
    count = int(mode[-1]) if mode.startswith("win") else None
    want = jops.ragged_cache_attention(*map(jnp.asarray, (q, k8, v8, pos)), **jkw,
                                       **({"win_count": jnp.int32(count)}
                                          if count is not None else {}))
    got = tops.ragged_cache_attention(*map(t, (q, k8, v8, pos)), **tkw,
                                      win_count=count)
    assert_allclose(got.numpy(), np.asarray(want), rtol=OPS_RTOL, atol=OPS_ATOL)


@pytest.mark.parametrize("mode", ["plain", "append", "win0", "win1", "win3"])
def test_ragged_cache_attention_int8_bf16_q_matches_jax(rng, mode):
    """int8 caches under a bf16 q: the probabilities times the value scales
    are rounded to q's dtype before P.V in the cache part as in the window
    part, as the JAX op rounds them (ROADMAP C1).  bf16 output: 1e-2, two
    bf16 ulps."""
    nh, Q = 4, 3
    q = normal(rng, B, 1, nh, HD)
    (k8, ks), (v8, vs) = q8(normal(rng, B, KVH, M, HD)), q8(normal(rng, B, KVH, M, HD))
    pos = np.array([0, 9, M - 1], np.int32)
    kw = dict(k_scale=ks, v_scale=vs)
    if mode != "plain":
        (ck, cks), (cv, cvs) = q8(normal(rng, B, KVH, HD)), q8(normal(rng, B, KVH, HD))
        kw.update(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
    if mode.startswith("win"):
        (wk, wks), (wv, wvs) = q8(normal(rng, B, KVH, Q, HD)), q8(normal(rng, B, KVH, Q, HD))
        kw.update(win_k=wk, win_v=wv, win_ks=wks, win_vs=wvs)
    jkw, tkw = _jt(kw)
    count = int(mode[-1]) if mode.startswith("win") else None
    want = jops.ragged_cache_attention(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (k8, v8, pos)), **jkw,
        **({"win_count": jnp.int32(count)} if count is not None else {}))
    got = tops.ragged_cache_attention(t(q).to(torch.bfloat16), *map(t, (k8, v8, pos)),
                                      **tkw, win_count=count)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_int8_kv_streams_do_not_depend_on_the_quantum(paged):
    """bf16 activations, int8 weights and int8 KV (ROADMAP C1's case): the
    capacity-1 engine's stream and its top log-probabilities at quantum 3
    equal those at quantum 1, bit for bit, as the JAX engine's do; without
    the cache part's rounding (the window part had it) they differ at every
    token and this stream parts from the other."""
    w = jsynth(jpreset("test-tiny"), seed=23)
    eng = tllama.Llama(w, tpreset("test-tiny", dtype="bfloat16", quant="int8",
                                  kv_quant="int8"), device="cpu")
    prompt = np.random.default_rng(1).integers(3, 512, size=6).tolist()

    def stream(quantum):
        be = BatchEngine(eng, capacity=1, paged=paged, logprobs=1,
                         **(dict(page_size=8) if paged else {}))
        assert be.cache["k"].dtype == torch.int8
        req = be.submit(prompt, 12, stop_ids=(), logprobs=1)
        while not req.done:
            be.step(quantum)
        return req.generated, [top[0][1] for top in req.top_logprobs]

    got = stream(1)
    assert len(got[0]) == 12 and stream(3) == got


@pytest.mark.parametrize("count", ["plain", None, 0, 2])
def test_paged_attention_int8_matches_jax(rng, count):
    """The gather forms: `paged_attention` (plain) and
    `paged_attention_stacked` (current column, and window at `count`)."""
    nh, Q, li = 4, 3, 1
    q = normal(rng, B, 1, nh, HD)
    (kp, ksp), (vp, vsp) = (q8(normal(rng, NL, P, KVH, PAGE, HD)) for _ in range(2))
    bt, pos = _table(rng), np.array([0, 11, MAXP * PAGE - Q], np.int32)
    if count == "plain":
        want = jops.paged_attention(*map(jnp.asarray, (q, kp[li], vp[li], bt, pos)),
                                    k_scale=jnp.asarray(ksp[li]),
                                    v_scale=jnp.asarray(vsp[li]))
        got = tops.paged_attention(*map(t, (q, kp[li], vp[li], bt, pos)),
                                   k_scale=t(ksp[li]), v_scale=t(vsp[li]))
        assert_allclose(got.numpy(), np.asarray(want), rtol=OPS_RTOL, atol=OPS_ATOL)
        return
    (ck, cks), (cv, cvs) = q8(normal(rng, B, KVH, HD)), q8(normal(rng, B, KVH, HD))
    kw = dict(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
    if count is not None:
        (wk, wks), (wv, wvs) = q8(normal(rng, B, KVH, Q, HD)), q8(normal(rng, B, KVH, Q, HD))
        kw.update(win_k=wk, win_v=wv, win_ks=wks, win_vs=wvs)
    jkw, tkw = _jt(kw)
    want = jops.paged_attention_stacked(
        *map(jnp.asarray, (q, kp, vp)), li, jnp.asarray(bt), jnp.asarray(pos),
        k_scale_pool=jnp.asarray(ksp), v_scale_pool=jnp.asarray(vsp), **jkw,
        **({"win_count": jnp.int32(count)} if count is not None else {}))
    got = tops.paged_attention_stacked(
        *map(t, (q, kp, vp)), li, t(bt), t(pos), k_scale_pool=t(ksp),
        v_scale_pool=t(vsp), win_count=count, **tkw)
    assert_allclose(got.numpy(), np.asarray(want), rtol=OPS_RTOL, atol=OPS_ATOL)


def test_gather_page_scales_equal_jax(rng):
    pools = rng.random((NL, P, KVH, PAGE)).astype(np.float32)
    bt = _table(rng)
    np.testing.assert_array_equal(
        tops.gather_page_scales(t(pools[0]), t(bt)).numpy(),
        np.asarray(jops.gather_page_scales(jnp.asarray(pools[0]), jnp.asarray(bt))))
    np.testing.assert_array_equal(
        tops.gather_page_scales_stacked(t(pools), 1, t(bt)).numpy(),
        np.asarray(jops.gather_page_scales_stacked(jnp.asarray(pools), 1,
                                                   jnp.asarray(bt))))
    np.testing.assert_array_equal(
        tops.gather_page_scales_all(t(pools), t(bt)).numpy(),
        np.asarray(jops.gather_page_scales_all(jnp.asarray(pools), jnp.asarray(bt))))


def test_scale_updates_equal_jax(rng):
    s = rng.random((B, KVH)).astype(np.float32)
    dense = rng.random((B, KVH, M)).astype(np.float32)
    pos = np.array([0, 17, M + 3], np.int32)  # the last clamps to M-1
    got = tops.ragged_update_scales(t(dense), t(s), t(pos))
    want = jops.ragged_update_scales(jnp.asarray(dense), jnp.asarray(s), jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pool = rng.random((P, KVH, PAGE)).astype(np.float32)
    pids, offs = np.array([3, 7, 1], np.int32), np.array([0, 5, 7], np.int32)
    got = tops.paged_update_scales(t(pool), t(s), t(pids), t(offs))
    want = jops.paged_update_scales(jnp.asarray(pool), jnp.asarray(s),
                                    jnp.asarray(pids), jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the kernel wrapper on CPU tensors against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win_count", ["plain", None, 0, 1, 3])
@pytest.mark.parametrize("nh,kvh,hd,page", [(4, 2, 32, 8), (4, 4, 16, 8)])
def test_paged_kernel_wrapper_int8_matches_jax_kernel(rng, win_count, nh, kvh, hd, page):
    """Plain mode (win_count "plain"), stacked mode (None) and window
    mode; row 0 of the stacked modes has pos 0 and an all-null table."""
    Lk, Bk, Pk, maxp, Q, li = 2, 3, 17, 4, 4, 1
    q = normal(rng, Bk, 1, nh, hd)
    (kp, ksp), (vp, vsp) = (q8(normal(rng, Lk, Pk, kvh, page, hd)) for _ in range(2))
    bt = rng.permutation(np.arange(1, Pk))[: Bk * maxp].reshape(Bk, maxp).astype(np.int32)
    if win_count == "plain":
        pos = np.array([0, page + 3, maxp * page - 1], np.int32)
        bt[0, 1:] = 0
        bt[1, 2:] = 0
        rows = (jops.gather_page_scales(jnp.asarray(ksp[li]), jnp.asarray(bt)),
                jops.gather_page_scales(jnp.asarray(vsp[li]), jnp.asarray(bt)))
        want = j_paged_kernel(*map(jnp.asarray, (q, kp[li], vp[li], bt, pos)),
                              k_scale_rows=rows[0], v_scale_rows=rows[1],
                              interpret=True)
        before = paged_attention.launches
        got = paged_attention(*map(t, (q, kp[li], vp[li], bt, pos)),
                              k_scale=t(ksp[li]), v_scale=t(vsp[li]))
        assert paged_attention.launches == before  # CPU: the plain version
        assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        return
    pos = np.array([0, page + 3, maxp * page - Q], np.int32)
    bt[0, :] = 0
    bt[1, 2:] = 0
    (ck, cks), (cv, cvs) = q8(normal(rng, Bk, kvh, hd)), q8(normal(rng, Bk, kvh, hd))
    kw = dict(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
    if win_count is not None:
        (wk, wks), (wv, wvs) = q8(normal(rng, Bk, kvh, Q, hd)), q8(normal(rng, Bk, kvh, Q, hd))
        kw.update(win_k=wk, win_v=wv, win_ks=wks, win_vs=wvs)
    jkw, tkw = _jt(kw)
    rows = (jops.gather_page_scales_stacked(jnp.asarray(ksp), li, jnp.asarray(bt)),
            jops.gather_page_scales_stacked(jnp.asarray(vsp), li, jnp.asarray(bt)))
    want = j_paged_kernel(*map(jnp.asarray, (q, kp, vp, bt, pos)), k_scale_rows=rows[0],
                          v_scale_rows=rows[1], layer=li, **jkw,
                          **({} if win_count is None else {"win_count": jnp.int32(win_count)}),
                          interpret=True)
    got = paged_attention(*map(t, (q, kp, vp, bt, pos)), k_scale=t(ksp), v_scale=t(vsp),
                          layer=li, win_count=win_count, **tkw)
    assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


# int8 pools under a 16-bit q: one rounding of the f32 result in q's dtype,
# so two ulps of it (bf16 2^-8, float16 2^-11 relative a ulp).
HALF_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),
            torch.float16: dict(rtol=2e-3, atol=2e-3)}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("win_count", ["plain", None, 0, 1, 4])
@pytest.mark.parametrize("nh,kvh,hd,page", [(4, 2, 32, 8), (8, 2, 16, 8), (4, 1, 128, 4)])
def test_paged_kernel_wrapper_int8_16bit_q_matches_jax_kernel(rng, qdt, win_count, nh,
                                                              kvh, hd, page):
    """int8 pools under a bf16 or float16 q (a 16-bit model's int8 KV) in
    plain mode (win_count "plain"), stacked mode (None) and window mode
    (count 0, partial, full), against the JAX kernel in interpret mode,
    which widens q to f32 and rounds once, at the output.  Row 0 sits at
    pos 0 (stacked: an all-null table), row 1 ends on a page boundary, and
    the twin never takes the XLA op's rounding of the probabilities to q's
    dtype."""
    Lk, Bk, Pk, maxp, Q, li = 2, 3, 17, 4, 4, 1
    q = normal(rng, Bk, 1, nh, hd)
    jq, tq = jnp.asarray(q, JNP[qdt]), t(q).to(qdt)
    (kp, ksp), (vp, vsp) = (q8(normal(rng, Lk, Pk, kvh, page, hd)) for _ in range(2))
    bt = rng.permutation(np.arange(1, Pk))[: Bk * maxp].reshape(Bk, maxp).astype(np.int32)
    if win_count == "plain":
        pos = np.array([0, 2 * page - 1, maxp * page - 1], np.int32)
        bt[0, 1:] = 0
        bt[1, 2:] = 0
        rows = (jops.gather_page_scales(jnp.asarray(ksp[li]), jnp.asarray(bt)),
                jops.gather_page_scales(jnp.asarray(vsp[li]), jnp.asarray(bt)))
        want = j_paged_kernel(jq, *map(jnp.asarray, (kp[li], vp[li], bt, pos)),
                              k_scale_rows=rows[0], v_scale_rows=rows[1],
                              interpret=True)
        before = paged_attention.launches
        got = paged_attention(tq, *map(t, (kp[li], vp[li], bt, pos)),
                              k_scale=t(ksp[li]), v_scale=t(vsp[li]))
        assert paged_attention.launches == before  # CPU: the plain version
    else:
        pos = np.array([0, 2 * page, maxp * page - Q], np.int32)
        bt[0, :] = 0
        bt[1, 2:] = 0
        (ck, cks), (cv, cvs) = q8(normal(rng, Bk, kvh, hd)), q8(normal(rng, Bk, kvh, hd))
        kw = dict(cur_k=ck, cur_v=cv, cur_ks=cks, cur_vs=cvs)
        if win_count is not None:
            (wk, wks), (wv, wvs) = (q8(normal(rng, Bk, kvh, Q, hd)),
                                    q8(normal(rng, Bk, kvh, Q, hd)))
            kw.update(win_k=wk, win_v=wv, win_ks=wks, win_vs=wvs)
        jkw, tkw = _jt(kw)
        rows = (jops.gather_page_scales_stacked(jnp.asarray(ksp), li, jnp.asarray(bt)),
                jops.gather_page_scales_stacked(jnp.asarray(vsp), li, jnp.asarray(bt)))
        want = j_paged_kernel(jq, *map(jnp.asarray, (kp, vp, bt, pos)),
                              k_scale_rows=rows[0], v_scale_rows=rows[1], layer=li, **jkw,
                              **({} if win_count is None
                                 else {"win_count": jnp.int32(win_count)}),
                              interpret=True)
        got = paged_attention(tq, *map(t, (kp, vp, bt, pos)), k_scale=t(ksp),
                              v_scale=t(vsp), layer=li, win_count=win_count, **tkw)
    assert want.dtype == JNP[qdt] and got.dtype == qdt
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **HALF_TOL[qdt])


# ---------------------------------------------------------------------------
# commits, caches
# ---------------------------------------------------------------------------

def _pools(rng, paged):
    shape = (NL, P, KVH, PAGE) if paged else (NL, B, KVH, M)
    (k, ks), (v, vs) = (q8(normal(rng, *shape, HD)) for _ in range(2))
    return {"k": k, "v": v, "k_s": ks, "v_s": vs}


def _equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("paged", [False, True])
def test_commit_decode_rows_int8_match_jax(rng, paged):
    (kr, ksr), (vr, vsr) = (q8(normal(rng, NL, B, KVH, HD)) for _ in range(2))
    cache = _pools(rng, paged)
    jc, tc = _jt(cache)
    rows = (kr, vr)
    if paged:
        at = (np.array([5, 2, 9], np.int32), np.array([1, 7, 0], np.int32))
        fn_j, fn_t = jops.commit_decode_rows_paged, tops.commit_decode_rows_paged
    else:
        at = (np.array([4, M, M - 1], np.int32),)  # M is dropped
        fn_j, fn_t = jops.commit_decode_rows_dense, tops.commit_decode_rows_dense
    want = fn_j(jc, *map(jnp.asarray, rows + at), jnp.asarray(ksr), jnp.asarray(vsr))
    got = fn_t(tc, *map(t, rows + at), t(ksr), t(vsr))
    _equal(got, want)


@pytest.mark.parametrize("paged", [False, True])
def test_commit_window_int8_matches_jax(rng, paged):
    Q = 3
    (wk, wks), (wv, wvs) = (q8(normal(rng, NL, B, KVH, Q, HD)) for _ in range(2))
    jwin, twin = _jt({"k": wk, "v": wv, "k_s": wks, "v_s": wvs})
    cache = _pools(rng, paged)
    jc, tc = _jt(cache)
    if paged:  # distinct targets; row 2 ends at the table's end
        bt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
        pos0 = np.array([0, 6, MAXP * PAGE - Q], np.int32)
        want = jops.commit_window_paged(jc, jwin, jnp.asarray(pos0), jnp.asarray(bt), Q)
        got = tops.commit_window_paged(tc, twin, t(pos0), t(bt), Q)
    else:  # overrun positions past M are dropped
        pos0 = np.array([0, M - 2, 7], np.int32)
        want = jops.commit_window_dense(jc, jwin, jnp.asarray(pos0), Q)
        got = tops.commit_window_dense(tc, twin, t(pos0), Q)
    _equal(got, want)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_int8_cache_layouts_match_jax(name):
    jargs, targs = jpreset(name), tpreset(name)
    want = jkv.init_cache(jargs, 3, quant="int8")
    got = tkv.init_cache(targs, 3, quant="int8", device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert tkv.cache_nbytes(targs, 3, quant="int8") == jkv.cache_nbytes(jargs, 3, quant="int8")
    with pytest.raises(ValueError, match="kv quant"):
        tkv.init_cache(targs, 3, quant="int4", device="cpu")


def test_cache_nbytes_accounting():
    args = tpreset("llama3-8b")
    bf16 = tkv.cache_nbytes(args.replace(kv_dtype="bfloat16"), batch_size=1)
    q8b = tkv.cache_nbytes(args, batch_size=1, quant="int8")
    # int8 halves the bf16 cache, plus one f32 scale per row (HD=128).
    assert q8b / bf16 == pytest.approx((128 + 4) / 256)


# ---------------------------------------------------------------------------
# ragged decode through the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    w = jsynth(jpreset("test-tiny"), seed=23)
    return (jllama.Llama(w, jpreset("test-tiny")),
            tllama.Llama(w, tpreset("test-tiny"), device="cpu"))


def _state(rng, args, paged, Bs=3):
    """A seeded int8 cache or pool, per-row positions and a block table."""
    hd, kvh, nl, Mx = args.head_dim, args.kv_heads, args.n_layers, args.max_seq_len
    pos = np.array([0, 5, Mx - 2][:Bs], np.int32)
    toks = rng.integers(3, args.vocab_size, size=Bs).astype(np.int32)
    bt = None
    if paged:
        page, maxp = 8, Mx // 8
        Pn = 1 + Bs * maxp
        bt = rng.permutation(np.arange(1, Pn)).reshape(Bs, maxp).astype(np.int32)
        shape = (nl, Pn, kvh, page)
    else:
        shape = (nl, Bs, kvh, Mx)
    (k, ks), (v, vs) = (q8(normal(rng, *shape, hd)) for _ in range(2))
    return toks, pos, bt, {"k": k, "v": v, "k_s": ks, "v_s": vs}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("commit", [True, False])
def test_forward_ragged_decode_int8_matches_jax(tiny, rng, paged, commit):
    jeng, teng = tiny
    toks, pos, bt, cache = _state(rng, teng.args, paged)
    jc, tc = _jt(cache)
    jl, jout = jllama.forward_ragged_decode(
        jeng.params, jnp.asarray(toks), jnp.asarray(pos), jc, jeng.cos, jeng.sin,
        jeng.cfg, block_table=None if bt is None else jnp.asarray(bt), commit=commit)
    tl, tout = tllama.forward_ragged_decode(
        teng.params, t(toks), t(pos), tc, teng.cos, teng.sin, teng.cfg,
        block_table=None if bt is None else t(bt), commit=commit)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if commit:
        assert tout is tc
        for k in ("k_s", "v_s"):
            assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-7)
        for k in ("k", "v"):  # int8 codes: at most one step off at a rounding tie
            diff = np.abs(tout[k].numpy().astype(int) - np.asarray(jout[k]).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    else:
        assert len(tout) == len(jout) == 4  # (k, v, k_s, v_s)
        for g, w in zip(tout, jout):
            assert_allclose(g.numpy().astype(np.float32), np.asarray(w).astype(np.float32),
                            rtol=1e-4, atol=1.0 if g.dtype == torch.int8 else 1e-7)


@pytest.mark.parametrize("paged,quantum", [(False, 4), (True, 3)])
def test_ragged_decode_steps_int8_match_jax(tiny, rng, paged, quantum):
    jeng, teng = tiny
    toks, pos, bt, cache = _state(rng, teng.args, paged)
    pos[2] = teng.args.max_seq_len - 2  # overruns mid-quantum
    jc, tc = _jt(cache)
    jt_, jcache = jllama.ragged_decode_steps(
        jeng.params, jnp.asarray(toks), jnp.asarray(pos), jc, jeng.cos, jeng.sin,
        jeng.cfg, quantum, block_table=None if bt is None else jnp.asarray(bt))
    tt, tcache = tllama.ragged_decode_steps(
        teng.params, t(toks), t(pos), tc, teng.cos, teng.sin, teng.cfg, quantum,
        block_table=None if bt is None else t(bt))
    keep = (pos[:, None] + np.arange(quantum)) < teng.args.max_seq_len
    np.testing.assert_array_equal(tt.numpy()[keep], np.asarray(jt_)[keep])
    if not paged:
        assert_allclose(tcache["k_s"].numpy()[:, :2], np.asarray(jcache["k_s"])[:, :2],
                        rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# serving: every tests/test_kv_quant.py scenario through both engines
# ---------------------------------------------------------------------------

def both(tiny, run):
    jeng, teng = tiny
    got = run(BatchEngine, teng)
    assert got == run(JBatchEngine, jeng)
    return got


def solo(BE, eng, prompt, n, paged):
    be = BE(eng, capacity=1, paged=paged, kv_quant="int8")
    req = be.submit(prompt, max_new_tokens=n)
    be.run_to_completion()
    return req.generated


@pytest.mark.parametrize("paged", [False, True])
def test_int8_serving_schedule_independent(tiny, rng, paged):
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 7, 5)]

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=paged, kv_quant="int8")
        r0 = be.submit(prompts[0], 8)
        be.step()
        r1 = be.submit(prompts[1], 8)
        be.step()
        r2 = be.submit(prompts[2], 8)
        be.run_to_completion()
        return [r.generated for r in (r0, r1, r2)]

    got = both(tiny, run)
    assert got == [solo(BatchEngine, tiny[1], p, 8, paged) for p in prompts]


def test_int8_serving_close_to_fp_serving(tiny, rng):
    prompt = rng.integers(3, 512, size=6).tolist()

    def run(BE, eng):
        fp, q8e = BE(eng, capacity=1), BE(eng, capacity=1, kv_quant="int8")
        r_fp, r_q8 = fp.submit(prompt, 4), q8e.submit(prompt, 4)
        fp.run_to_completion()
        q8e.run_to_completion()
        assert r_q8.generated[0] == r_fp.generated[0]
        return [r_fp.generated, r_q8.generated]

    both(tiny, run)


@pytest.mark.parametrize("quantum", [1, 3])
def test_int8_serving_quantum_and_mixed(tiny, rng, quantum):
    """Quantum decode, mixed lengths and slot reuse under int8 paged KV."""
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 6, 5)]

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=True, kv_quant="int8")
        reqs = [be.submit(p, 8) for p in prompts]
        while any(not r.done for r in reqs):
            be.step(quantum=quantum)
        return [r.generated for r in reqs]

    got = both(tiny, run)
    assert got == [solo(BatchEngine, tiny[1], p, 8, True) for p in prompts]


def test_int8_serving_chunked_admission(tiny, rng):
    """Chunked admission prefills in f32 and quantizes once, at the copy
    into the pages: the same stream as an unchunked admission."""
    short, long_p = (rng.integers(3, 512, size=n).tolist() for n in (4, 40))

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=True, admit_chunk=16, kv_quant="int8")
        r_short = be.submit(short, 12)
        be.step()
        r_long = be.submit(long_p, 4)
        be.run_to_completion()
        assert be.allocator.available == be.allocator.num_pages - 1
        return [r_short.generated, r_long.generated]

    got = both(tiny, run)
    assert got[1] == solo(BatchEngine, tiny[1], long_p, 4, True)


def test_int8_kv_with_int8_weights_matches_jax(rng):
    """int8 weights and int8 KV together (the chip smoke's serving cell),
    dense and paged, quantum 3."""
    w = jsynth(jpreset("test-tiny"), seed=29)
    kw = dict(quant="int8", kv_quant="int8")
    engs = (jllama.Llama(w, jpreset("test-tiny", pallas_ffn_block=0, **kw)),
            tllama.Llama(w, tpreset("test-tiny", **kw), device="cpu"))
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (5, 9)]

    def run(BE, eng):
        out = []
        for paged in (False, True):
            be = BE(eng, capacity=2, paged=paged)
            assert be.cache["k"].dtype in (jnp.int8, torch.int8)
            reqs = [be.submit(p, 7) for p in prompts]
            while any(not r.done for r in reqs):
                be.step(quantum=3)
            out.append([r.generated for r in reqs])
        assert out[0] == out[1]
        return out[0]

    both(engs, run)


def test_card_path_int8_with_cpu_tensors(rng):
    """The kernel path (`cfg.kernels`) on CPU tensors runs the wrappers'
    plain versions with the scale pools and serves the same streams, with
    no launch counted."""
    w = jsynth(jpreset("test-tiny"), seed=23)
    eng = tllama.Llama(w, tpreset("test-tiny", kv_quant="int8"), device="cpu")
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 9)]

    def serve():
        be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
        r0 = be.submit(prompts[0], 8)
        be.step(2)
        r1 = be.submit(prompts[1], 8)
        while be.num_active or be._queue:
            be.step(2)
        return [r0.generated, r1.generated]

    want = serve()
    plain = eng.cfg
    eng.cfg = plain._replace(kernels=True)
    before = paged_attention.launches
    assert serve() == want
    assert paged_attention.launches == before
    eng.cfg = plain


# ---------------------------------------------------------------------------
# int8 KV under 16-bit activations: the serving engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_kv_under_16bit_activations_matches_jax(rng, dtype, paged):
    """BatchEngine(kv_quant="int8") under bf16 and float16 activations,
    dense and paged, quantum 3, staggered admissions: the same streams as
    the JAX BatchEngine on the same weights, and every stream its
    capacity-1 stream."""
    w = jsynth(jpreset("test-tiny"), seed=31)
    engs = (jllama.Llama(w, jpreset("test-tiny", dtype=dtype, pallas_ffn_block=0)),
            tllama.Llama(w, tpreset("test-tiny", dtype=dtype), device="cpu"))
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (5, 9, 3)]

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=paged, kv_quant="int8")
        assert be.cache["k"].dtype in (jnp.int8, torch.int8)
        reqs = [be.submit(prompts[0], 9)]
        be.step(quantum=3)
        reqs += [be.submit(p, 9) for p in prompts[1:]]
        while any(not r.done for r in reqs):
            be.step(quantum=3)
        return [r.generated for r in reqs]

    got = both(engs, run)
    assert got == [solo(BatchEngine, engs[1], p, 9, paged) for p in prompts]


@pytest.mark.parametrize("dtype,quant", [("bfloat16", None), ("float16", None),
                                         ("float16", "int8")])
@pytest.mark.parametrize("paged", [False, True])
def test_16bit_int8_kv_streams_do_not_depend_on_the_quantum(dtype, quant, paged):
    """The C1 rule for the other 16-bit int8-KV engines: the capacity-1
    stream at quantum 3 equals the one at quantum 1, and so do its top
    log-probabilities, bit for bit in bf16 (bf16 with int8 weights is the
    test above).  In float16 they agree to 1e-3: a quantum moves a token's
    score from the cache's columns to the window's, the f32 softmax sums
    the same values in another order, and a probability one f32 ulp apart
    may round to float16 the other way (an 8th as likely in bf16).  The JAX
    engine's float16 log-probabilities are not bit-equal across quanta
    either."""
    w = jsynth(jpreset("test-tiny"), seed=23)
    eng = tllama.Llama(w, tpreset("test-tiny", dtype=dtype, quant=quant, kv_quant="int8"),
                       device="cpu")
    prompt = np.random.default_rng(2).integers(3, 512, size=6).tolist()

    def stream(quantum):
        be = BatchEngine(eng, capacity=1, paged=paged, logprobs=1,
                         **(dict(page_size=8) if paged else {}))
        assert be.cache["k"].dtype == torch.int8
        req = be.submit(prompt, 12, stop_ids=(), logprobs=1)
        while not req.done:
            be.step(quantum)
        return req.generated, [top[0][1] for top in req.top_logprobs]

    got, again = stream(1), stream(3)
    assert len(got[0]) == 12 and again[0] == got[0]
    if dtype == "float16":
        assert_allclose(again[1], got[1], rtol=0, atol=1e-3)
    else:
        assert again[1] == got[1]
