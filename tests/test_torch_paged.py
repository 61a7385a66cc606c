"""The port's paged KV cache, ragged/paged ops, paged-attention wrapper and
ragged decode against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages.
Attention agrees at rtol 2e-4 / atol 1e-4 (sums in another order); cache
commits give bit-equal pools; the kernel wrapper on CPU tensors (its plain
version) is held against the JAX Pallas kernel in interpret mode.
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
from llama3np_tpu_torch import kvcache as tkv
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.models import llama as tllama
from llama3np_tpu_torch.ops import core as tops
from llama3np_tpu_torch.ops.kernels.paged_attention import (
    paged_attention, paged_attention_plain)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want):
    assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# paged cache and allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_init_paged_cache_layout(name):
    want = jkv.init_paged_cache(jpreset(name), 7, page_size=8)
    got = tkv.init_paged_cache(tpreset(name), 7, page_size=8, device="cpu")
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32 and not got[k].any()
    # int8 pools: int8 values and f32 scale pools of the JAX shapes.
    want = jkv.init_paged_cache(jpreset(name), 7, page_size=8, quant="int8")
    got = tkv.init_paged_cache(tpreset(name), 7, page_size=8, quant="int8",
                               device="cpu")
    assert got.keys() == want.keys() == {"k", "v", "k_s", "v_s"}
    for k, dt in (("k", torch.int8), ("v", torch.int8), ("k_s", torch.float32),
                  ("v_s", torch.float32)):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == dt and not got[k].any()
    with pytest.raises(ValueError, match="kv quant"):
        tkv.init_paged_cache(tpreset(name), 7, quant="int4", device="cpu")


def test_page_allocator_matches_jax():
    ja, ta = jkv.PageAllocator(9), tkv.PageAllocator(9)

    def same():
        assert ta._free == ja._free and ta._rc == ja._rc
        assert ta.available == ja.available

    for op, arg in [("alloc", 3), ("alloc", 2), ("share", [2, 4]),
                    ("free", [2, 3]), ("free", [4, 0]), ("alloc", 3),
                    ("free", [2]), ("share", [1]), ("free", [1, 1]),
                    ("alloc", 3)]:
        got, want = getattr(ta, op)(arg), getattr(ja, op)(arg)
        assert got == want, op
        same()
    assert [ta.refcount(p) for p in range(9)] == [ja.refcount(p) for p in range(9)]
    for alloc in (ja, ta):
        with pytest.raises(MemoryError, match="exhausted"):
            alloc.alloc(alloc.available + 1)
    same()
    fresh = tkv.PageAllocator(3)
    with pytest.raises(ValueError, match="double free"):
        fresh.free([1])
    with pytest.raises(ValueError, match="share of free page"):
        fresh.share([2])


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

B, KVH, HD, M, PAGE, MAXP, P, NL = 3, 2, 16, 32, 8, 4, 14, 2


def _table(rng):
    """Shuffled distinct page ids per row; unused entries -> null page 0."""
    bt = rng.permutation(np.arange(1, P))[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    bt[0, 1:] = 0
    bt[1, 3:] = 0
    return bt


def test_ragged_and_paged_updates_match_jax(rng):
    kc, vc = normal(rng, B, KVH, M, HD), normal(rng, B, KVH, M, HD)
    k, v = normal(rng, B, 1, KVH, HD), normal(rng, B, 1, KVH, HD)
    pos = np.array([0, 17, M + 3], np.int32)  # the last clamps to row M-1
    jk, jv = jops.ragged_update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos))
    tk, tv = t(kc), t(vc)
    tops.ragged_update_kv_cache(tk, tv, t(k), t(v), t(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    kp, vp = normal(rng, P, KVH, PAGE, HD), normal(rng, P, KVH, PAGE, HD)
    pids, offs = np.array([3, 7, 1], np.int32), np.array([0, 5, 7], np.int32)
    jk, jv = jops.paged_update_kv_cache(jnp.asarray(kp), jnp.asarray(vp),
                                        jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pids), jnp.asarray(offs))
    tk, tv = t(kp), t(vp)
    tops.paged_update_kv_cache(tk, tv, t(k), t(v), t(pids), t(offs))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("nh", [2, 6])
def test_paged_attention_gather_matches_jax(rng, nh):
    q = normal(rng, B, 1, nh, HD)
    kp, vp = normal(rng, P, KVH, PAGE, HD), normal(rng, P, KVH, PAGE, HD)
    bt, pos = _table(rng), np.array([3, 20, MAXP * PAGE - 1], np.int32)
    want = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, bt, pos)))
    close(tops.paged_attention(*map(t, (q, kp, vp, bt, pos))), want)


@pytest.mark.parametrize("mode", ["plain", "append", "win0", "win1", "win3"])
def test_ragged_cache_attention_matches_jax(rng, mode):
    nh, Q = 4, 3
    q = normal(rng, B, 1, nh, HD)
    kc, vc = normal(rng, B, KVH, M, HD), normal(rng, B, KVH, M, HD)
    pos = np.array([0, 9, M - 1], np.int32)
    kw = {}
    if mode != "plain":
        kw = dict(cur_k=normal(rng, B, KVH, HD), cur_v=normal(rng, B, KVH, HD))
    if mode.startswith("win"):
        kw.update(win_k=normal(rng, B, KVH, Q, HD), win_v=normal(rng, B, KVH, Q, HD))
    count = int(mode[-1]) if mode.startswith("win") else None
    want = jops.ragged_cache_attention(
        *map(jnp.asarray, (q, kc, vc, pos)),
        **{k: jnp.asarray(a) for k, a in kw.items()},
        **({"win_count": jnp.int32(count)} if count is not None else {}))
    got = tops.ragged_cache_attention(
        *map(t, (q, kc, vc, pos)), **{k: t(a) for k, a in kw.items()},
        **({"win_count": count} if count is not None else {}))
    close(got, want)


@pytest.mark.parametrize("count", [None, 0, 2])
def test_paged_attention_stacked_matches_jax(rng, count):
    nh, Q, li = 4, 3, 1
    q = normal(rng, B, 1, nh, HD)
    kp, vp = normal(rng, NL, P, KVH, PAGE, HD), normal(rng, NL, P, KVH, PAGE, HD)
    bt, pos = _table(rng), np.array([0, 11, MAXP * PAGE - Q], np.int32)
    kw = dict(cur_k=normal(rng, B, KVH, HD), cur_v=normal(rng, B, KVH, HD))
    if count is not None:
        kw.update(win_k=normal(rng, B, KVH, Q, HD), win_v=normal(rng, B, KVH, Q, HD))
    want = jops.paged_attention_stacked(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), li, jnp.asarray(bt),
        jnp.asarray(pos), **{k: jnp.asarray(a) for k, a in kw.items()},
        **({"win_count": jnp.int32(count)} if count is not None else {}))
    got = tops.paged_attention_stacked(
        t(q), t(kp), t(vp), li, t(bt), t(pos), **{k: t(a) for k, a in kw.items()},
        **({"win_count": count} if count is not None else {}))
    close(got, want)


def _pools(rng):
    return {"k": normal(rng, NL, P, KVH, PAGE, HD), "v": normal(rng, NL, P, KVH, PAGE, HD)}


def _dense(rng):
    return {"k": normal(rng, NL, B, KVH, M, HD), "v": normal(rng, NL, B, KVH, M, HD)}


def _equal(got, want):
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_commit_decode_rows_match_jax(rng):
    kr, vr = normal(rng, NL, B, KVH, HD), normal(rng, NL, B, KVH, HD)
    pool = _pools(rng)
    pids, offs = np.array([5, 2, 9], np.int32), np.array([1, 7, 0], np.int32)
    want = jops.commit_decode_rows_paged(
        {k: jnp.asarray(a) for k, a in pool.items()}, jnp.asarray(kr),
        jnp.asarray(vr), jnp.asarray(pids), jnp.asarray(offs))
    got = tops.commit_decode_rows_paged({k: t(a) for k, a in pool.items()},
                                        t(kr), t(vr), t(pids), t(offs))
    _equal(got, want)

    dense = _dense(rng)
    pos = np.array([4, M, M - 1], np.int32)  # M is dropped
    want = jops.commit_decode_rows_dense(
        {k: jnp.asarray(a) for k, a in dense.items()}, jnp.asarray(kr),
        jnp.asarray(vr), jnp.asarray(pos))
    got = tops.commit_decode_rows_dense({k: t(a) for k, a in dense.items()},
                                        t(kr), t(vr), t(pos))
    _equal(got, want)


def test_commit_window_matches_jax(rng):
    Q = 3
    win = {"k": normal(rng, NL, B, KVH, Q, HD), "v": normal(rng, NL, B, KVH, Q, HD)}
    jwin = {k: jnp.asarray(a) for k, a in win.items()}
    twin = {k: t(a) for k, a in win.items()}
    # Paged: distinct targets (row 0 writes into its own pages only).
    bt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    pos0 = np.array([0, 6, MAXP * PAGE - Q], np.int32)
    pool = _pools(rng)
    want = jops.commit_window_paged({k: jnp.asarray(a) for k, a in pool.items()},
                                    jwin, jnp.asarray(pos0), jnp.asarray(bt), Q)
    got = tops.commit_window_paged({k: t(a) for k, a in pool.items()}, twin,
                                   t(pos0), t(bt), Q)
    _equal(got, want)
    # Dense: overrun positions past M are dropped.
    dense = _dense(rng)
    pos0 = np.array([0, M - 2, 7], np.int32)
    want = jops.commit_window_dense({k: jnp.asarray(a) for k, a in dense.items()},
                                    jwin, jnp.asarray(pos0), Q)
    got = tops.commit_window_dense({k: t(a) for k, a in dense.items()}, twin,
                                   t(pos0), Q)
    _equal(got, want)


def test_commit_window_paged_overrun_clamps_into_last_page(rng):
    """A row whose quantum ran past its table writes into its last page
    only; other rows' slots are exact."""
    Q = 4
    win = {k: t(normal(rng, NL, B, KVH, Q, HD)) for k in ("k", "v")}
    bt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    pos0 = np.array([MAXP * PAGE - 2, 3, 12], np.int32)
    pool = {k: t(a) for k, a in _pools(rng).items()}
    before = {k: v.clone() for k, v in pool.items()}
    tops.commit_window_paged(pool, win, t(pos0), t(bt), Q)
    for b in (1, 2):
        for s in range(Q):
            p = int(pos0[b]) + s
            torch.testing.assert_close(pool["k"][:, bt[b, p // PAGE], :, p % PAGE],
                                       win["k"][:, b, :, s], rtol=0, atol=0)
    changed = (pool["k"] != before["k"]).any(dim=(0, 2, 3, 4)).nonzero()[:, 0].tolist()
    assert set(changed) <= {int(bt[0, MAXP - 1])} | set(bt[1:].reshape(-1).tolist())


# ---------------------------------------------------------------------------
# the kernel wrapper on CPU tensors against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nh,kvh,hd,page", [
    (4, 4, 16, 8),    # MHA
    (4, 2, 32, 8),    # GQA
    (8, 2, 16, 16),   # wider group
])
def test_paged_kernel_wrapper_matches_jax_kernel(rng, nh, kvh, hd, page):
    Bk, Pk, maxp = 3, 17, 4
    q = normal(rng, Bk, 1, nh, hd)
    kp, vp = normal(rng, Pk, kvh, page, hd), normal(rng, Pk, kvh, page, hd)
    bt = rng.permutation(np.arange(1, Pk))[: Bk * maxp].reshape(Bk, maxp).astype(np.int32)
    pos = np.array([0, page + 3, maxp * page - 1], np.int32)
    bt[0, 1:] = 0
    bt[1, 2:] = 0
    want = j_paged_kernel(*map(jnp.asarray, (q, kp, vp, bt, pos)), interpret=True)
    before = paged_attention.launches
    got = paged_attention(*map(t, (q, kp, vp, bt, pos)))
    assert paged_attention.launches == before  # CPU: plain version, no launch
    close(got, want)


def test_paged_kernel_wrapper_overrun_row(rng):
    nh, kvh, hd, page, Bk, Pk, maxp = 4, 2, 32, 8, 2, 9, 4
    q = normal(rng, Bk, 1, nh, hd)
    kp, vp = normal(rng, Pk, kvh, page, hd), normal(rng, Pk, kvh, page, hd)
    bt = np.arange(1, 1 + Bk * maxp, dtype=np.int32).reshape(Bk, maxp)
    pos = np.array([maxp * page + 5, page + 2], np.int32)
    want = j_paged_kernel(*map(jnp.asarray, (q, kp, vp, bt, pos)), interpret=True)
    got = paged_attention(*map(t, (q, kp, vp, bt, pos)))
    assert torch.isfinite(got).all()
    close(got, want)  # both attend the whole table for the overrun row


@pytest.mark.parametrize("win_count", [None, 0, 1, 3])
def test_paged_kernel_wrapper_stacked_and_window(rng, win_count):
    """Stacked mode (win_count None) and window mode; row 0 has pos 0, so
    the current column (and the window) is all it attends."""
    Lk, Bk, Pk, maxp, nh, kvh, hd, page, Q, li = 2, 3, 17, 4, 4, 2, 32, 8, 4, 1
    q = normal(rng, Bk, 1, nh, hd)
    kp, vp = normal(rng, Lk, Pk, kvh, page, hd), normal(rng, Lk, Pk, kvh, page, hd)
    ck, cv = normal(rng, Bk, kvh, hd), normal(rng, Bk, kvh, hd)
    wk, wv = normal(rng, Bk, kvh, Q, hd), normal(rng, Bk, kvh, Q, hd)
    bt = rng.permutation(np.arange(1, Pk))[: Bk * maxp].reshape(Bk, maxp).astype(np.int32)
    pos = np.array([0, page + 3, maxp * page - Q], np.int32)
    bt[0, :] = 0
    bt[1, 2:] = 0
    win = {} if win_count is None else dict(win_k=wk, win_v=wv)
    want = j_paged_kernel(
        *map(jnp.asarray, (q, kp, vp, bt, pos)), layer=li, cur_k=jnp.asarray(ck),
        cur_v=jnp.asarray(cv), **{k: jnp.asarray(a) for k, a in win.items()},
        **({} if win_count is None else {"win_count": jnp.int32(win_count)}),
        interpret=True)
    before = paged_attention.launches
    got = paged_attention(*map(t, (q, kp, vp, bt, pos)), layer=li, cur_k=t(ck),
                          cur_v=t(cv), **{k: t(a) for k, a in win.items()},
                          win_count=win_count)
    assert paged_attention.launches == before
    close(got, want)
    if win_count is None:  # pos 0: the output is the current V row itself
        G = nh // kvh
        torch.testing.assert_close(got[0, 0].reshape(kvh, G, hd),
                                   t(cv)[0][:, None].expand(kvh, G, hd),
                                   rtol=1e-6, atol=1e-6)


def test_paged_kernel_wrapper_refusals(rng):
    q = t(normal(rng, 1, 1, 4, 16))
    pool = t(normal(rng, 3, 2, 8, 16))
    bt, pos = torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    scales = torch.ones(3, 2, 8)
    with pytest.raises(ValueError, match="float pools none"):  # scales, float pools
        paged_attention(q, pool, pool, bt, pos, k_scale=scales, v_scale=scales)
    pool8 = pool.to(torch.int8)
    with pytest.raises(ValueError, match="int8 pools take"):  # int8, no scales
        paged_attention(q, pool8, pool8, bt, pos)
    with pytest.raises(ValueError, match="k_scale must be"):
        paged_attention(q, pool8, pool8, bt, pos, k_scale=scales[:, :1],
                        v_scale=scales)
    with pytest.raises(ValueError, match="int8 pools take"):  # stacked: cur scales
        paged_attention(q, pool8[None], pool8[None], bt, pos, k_scale=scales[None],
                        v_scale=scales[None], layer=0,
                        cur_k=torch.zeros(1, 2, 16, dtype=torch.int8),
                        cur_v=torch.zeros(1, 2, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="pools"):
        paged_attention(q, pool[None], pool[None], bt, pos)  # 5-d without layer
    with pytest.raises(ValueError, match="cur_k"):
        paged_attention(q, pool[None], pool[None], bt, pos, layer=0)
    with pytest.raises(ValueError, match="window mode"):
        paged_attention(q, pool, pool, bt, pos, win_k=torch.zeros(1, 2, 2, 16),
                        win_v=torch.zeros(1, 2, 2, 16), win_count=1)
    assert paged_attention_plain(q, pool, pool, bt, pos).shape == (1, 1, 4, 16)


# ---------------------------------------------------------------------------
# ragged decode through the model
# ---------------------------------------------------------------------------

def _engines(name):
    w = jsynth(jpreset(name), seed=13)
    return (jllama.Llama(w, jpreset(name)),
            tllama.Llama(w, tpreset(name), device="cpu"))


def _state(rng, args, paged, Bs=3):
    """Seeded cache or pool, per-row positions and a block table."""
    hd, kvh, nl, Mx = args.head_dim, args.kv_heads, args.n_layers, args.max_seq_len
    pos = np.array([0, 5, Mx - 2][:Bs], np.int32)
    toks = rng.integers(3, args.vocab_size, size=Bs).astype(np.int32)
    if not paged:
        shape = (nl, Bs, kvh, Mx, hd)
        return toks, pos, None, {k: normal(rng, *shape) for k in ("k", "v")}
    page, maxp = 8, Mx // 8
    Pn = 1 + Bs * maxp
    bt = rng.permutation(np.arange(1, Pn)).reshape(Bs, maxp).astype(np.int32)
    shape = (nl, Pn, kvh, page, hd)
    return toks, pos, bt, {k: normal(rng, *shape) for k in ("k", "v")}


def _assert_logits(got, want):
    close(got, want)
    top = lambda a: np.argsort(-a, axis=-1, kind="stable")[:, :5]  # noqa: E731
    np.testing.assert_array_equal(top(got.numpy()), top(np.asarray(want)))


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("commit", [True, False])
def test_forward_ragged_decode_matches_jax(rng, name, paged, commit):
    jeng, teng = _engines(name)
    toks, pos, bt, cache = _state(rng, teng.args, paged)
    jbt = None if bt is None else jnp.asarray(bt)
    jl, jout = jllama.forward_ragged_decode(
        jeng.params, jnp.asarray(toks), jnp.asarray(pos),
        {k: jnp.asarray(a) for k, a in cache.items()}, jeng.cos, jeng.sin,
        jeng.cfg, block_table=jbt, commit=commit)
    tcache = {k: t(a) for k, a in cache.items()}
    tl, tout = tllama.forward_ragged_decode(
        teng.params, t(toks), t(pos), tcache, teng.cos, teng.sin, teng.cfg,
        block_table=None if bt is None else t(bt), commit=commit)
    _assert_logits(tl, jl)
    if commit:
        assert tout is tcache  # committed in place
        for k in ("k", "v"):
            close(tout[k], jout[k])
            changed = np.asarray(jout[k]) != cache[k]
            np.testing.assert_array_equal(tout[k].numpy() != cache[k], changed)
    else:
        for got, want in zip(tout, jout):
            close(got, want)


@pytest.mark.parametrize("name,paged,quantum", [
    ("test-tiny", False, 4), ("test-tiny", True, 3), ("test-tiny-mha", True, 2)])
def test_ragged_decode_steps_match_jax(rng, name, paged, quantum):
    jeng, teng = _engines(name)
    toks, pos, bt, cache = _state(rng, teng.args, paged)
    pos[2] = teng.args.max_seq_len - 2  # overruns mid-quantum
    jbt = None if bt is None else jnp.asarray(bt)
    jt, jlp, jc = jllama.ragged_decode_steps(
        jeng.params, jnp.asarray(toks), jnp.asarray(pos),
        {k: jnp.asarray(a) for k, a in cache.items()}, jeng.cos, jeng.sin,
        jeng.cfg, quantum, block_table=jbt, num_logprobs=3)
    tt, tlp, tc = tllama.ragged_decode_steps(
        teng.params, t(toks), t(pos), {k: t(a) for k, a in cache.items()},
        teng.cos, teng.sin, teng.cfg, quantum,
        block_table=None if bt is None else t(bt), num_logprobs=3)
    # The overrun row's tokens past max_seq_len are discarded by the engine
    # (the JAX package reads NaN RoPE rows there); the others are exact.
    keep = (pos[:, None] + np.arange(quantum)) < teng.args.max_seq_len
    np.testing.assert_array_equal(tt.numpy()[keep], np.asarray(jt)[keep])
    close(tlp[0].numpy()[keep], np.asarray(jlp[0])[keep])
    np.testing.assert_array_equal(tlp[1].numpy()[keep], np.asarray(jlp[1])[keep])
    for k in ("k", "v"):
        if paged:  # slots the rows in range committed
            for b in (0, 1):
                for s in range(quantum):
                    p = int(pos[b]) + s
                    got = tc[k][:, bt[b, p // 8], :, p % 8]
                    close(got, np.asarray(jc[k])[:, bt[b, p // 8], :, p % 8])
        else:
            close(tc[k], jc[k])


def test_ragged_decode_refuses_unported():
    _, teng = _engines("test-tiny")
    args = teng.args
    cache = tkv.init_cache(args, 2, device="cpu")
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tllama.forward_ragged_decode(teng.params, z, z, cache, teng.cos,
                                     teng.sin, teng.cfg, lora={})
    # Pre-gathered scale rows (the plain quantum loop's hoist) give the
    # same step as the per-layer gather of the scale pools.
    pool = tkv.init_paged_cache(args, 9, 8, quant="int8", device="cpu")
    bt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    pos = torch.tensor([3, 17], dtype=torch.int32)
    for name, t in pool.items():
        t.copy_(torch.randint(-50, 50, t.shape) if t.dtype == torch.int8
                else torch.rand(t.shape) / 50)
    rows = (tops.gather_page_scales_all(pool["k_s"], bt),
            tops.gather_page_scales_all(pool["v_s"], bt))
    kw = dict(block_table=bt, commit=False)
    want = tllama.forward_ragged_decode(teng.params, z, pos, pool, teng.cos,
                                        teng.sin, teng.cfg, **kw)
    got = tllama.forward_ragged_decode(teng.params, z, pos, pool, teng.cos,
                                       teng.sin, teng.cfg, scale_rows=rows, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_token_logprobs_matches_jax(rng):
    logits = normal(rng, 3, 50) * 3
    chosen = np.array([4, 0, 49], np.int32)
    jl, ji, jv = jllama.token_logprobs(jnp.asarray(logits), jnp.asarray(chosen), 5)
    tl, ti, tv = tllama.token_logprobs(t(logits), t(chosen), 5)
    close(tl, jl)
    close(tv, jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
