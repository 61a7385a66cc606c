"""The schedules of the port's two attention kernels, modelled in plain
PyTorch on the CPU and held against the plain versions and the JAX
kernels (in interpret mode), on inputs made with numpy from a seed.

(a) Paged attention cut into chunks of C pages: each row's visible tokens
    in chunks of C pages, partials (max, sum, P.V) per chunk (chunk 0 also
    folds the window rows and the current column), then a merge over the
    chunks the row used only; a row that used one chunk takes its
    normalized output.  Rows hold the schedule's boundary lengths.
(b) The wrapper's chunk size is a pure function of static shapes: no value
    of `pos` reaches it.
(c) Flash prefill's split-P arithmetic: bf16 QK^T products (exact in f32),
    f32 sums, the f32 probabilities entering P.V as P_hi + P_lo (two bf16
    values), agree in f32 with the f32 function before the output's bf16
    rounding: the design needs no new envelope.

The models live here, not in the package: the kernels are their
implementation on the card.

Tolerances: fp32 and int8 rtol 2e-4 / atol 1e-4 (sums in another order);
bf16 outputs 1e-2 (two bf16 ulps, tests/test_torch_bf16.py); the split-P
emulation 1e-5 relative to the output's largest value.
"""

import math

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from llama3np_tpu.ops import core as jops
from llama3np_tpu.ops.kernels.flash_prefill import flash_prefill as j_flash_prefill
from llama3np_tpu.ops.kernels.paged_attention import paged_attention as j_paged_attention
from llama3np_tpu_torch.ops.core import causal_attention, quantize_kv_rows
from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill_plain
from llama3np_tpu_torch.ops.kernels.paged_attention import (
    chunk_pages, paged_attention_plain, schedule)

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# (a) paged attention by chunks of C pages
# ---------------------------------------------------------------------------

def chunked_paged_attention(q, k_pages, v_pages, block_table, pos, C, k_scale=None,
                            v_scale=None, layer=None, cur_k=None, cur_v=None,
                            cur_ks=None, cur_vs=None, win_k=None, win_v=None,
                            win_ks=None, win_vs=None, win_count=None):
    """The paged kernel's schedule in f32, with its call signature plus C."""
    stacked = layer is not None
    if stacked:
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, _, NH, HD = q.shape
    P, KVH, page = k_pages.shape[:3]
    maxp, G = block_table.shape[1], NH // KVH
    qf = q.float().reshape(B, KVH, G, HD)
    out = torch.empty(B, KVH, G, HD)
    for b in range(B):
        held = max(int(pos[b]) if stacked else int(pos[b]) + 1, 0)
        vis = min(held, maxp * page)
        pages = -(-vis // page)
        used = max(1, -(-pages // C))
        for kh in range(KVH):
            parts = []
            for s in range(used):
                toks = torch.arange(s * C * page, min(vis, (s + 1) * C * page))
                ids = block_table[b, toks // page].long().clamp(0, P - 1)
                k = k_pages[ids, kh, toks % page].float()
                v = v_pages[ids, kh, toks % page].float()
                ks = vs = torch.ones(len(toks))
                if k_scale is not None:
                    ks, vs = k_scale[ids, kh, toks % page], v_scale[ids, kh, toks % page]
                if s == 0 and stacked:  # window rows c < win_count, then the current row
                    n = 0 if win_k is None else int(win_count)
                    rows = [(win_k[b, kh, :n], win_v[b, kh, :n],
                             None if win_ks is None else win_ks[b, kh, :n],
                             None if win_vs is None else win_vs[b, kh, :n])] if n else []
                    rows.append((cur_k[b, kh][None], cur_v[b, kh][None],
                                 None if cur_ks is None else cur_ks[b, kh][None],
                                 None if cur_vs is None else cur_vs[b, kh][None]))
                    for rk, rv, rks, rvs in rows:
                        k, v = torch.cat([k, rk.float()]), torch.cat([v, rv.float()])
                        ks = torch.cat([ks, torch.ones(len(rk)) if rks is None else rks])
                        vs = torch.cat([vs, torch.ones(len(rv)) if rvs is None else rvs])
                scores = (qf[b, kh] @ k.T) * ks / math.sqrt(HD)  # [G, T]
                m = scores.max(-1).values if scores.shape[1] else torch.full((G,), -math.inf)
                p = torch.exp(scores - m[:, None])
                parts.append((m, p.sum(-1), (p * vs) @ v))
            if used == 1:
                _, l, acc = parts[0]
            else:  # the merge: every used chunk rescaled to the common max
                ms = torch.stack([m for m, _, _ in parts])
                w = torch.where(ms == -math.inf, 0.0, torch.exp(ms - ms.max(0).values))
                l = sum(w[i] * parts[i][1] for i in range(used))
                acc = sum(w[i][:, None] * parts[i][2] for i in range(used))
            out[b, kh] = acc / l.clamp(min=1e-30)[:, None]
    return out.reshape(B, 1, NH, HD).to(q.dtype)


B, NH, KVH, HD, PAGE, MAXP, NL, Q, LAYER = 8, 4, 2, 16, 4, 5, 2, 3, 1
C_MODEL = 2  # chunk boundaries at 8 and 16 tokens; the last chunk is partial


def boundary_held(C):
    """The held lengths at the schedule's boundaries, the last row past its
    table."""
    return [0, 1, PAGE - 1, PAGE, C * PAGE, C * PAGE + 1, MAXP * PAGE, MAXP * PAGE + 6]


def paged_inputs(rng, mode):
    """numpy inputs: shuffled block tables with null-page padding; pos from
    the boundary lengths (plain mode holds pos + 1 tokens)."""
    P = 1 + B * MAXP
    bt = rng.permutation(np.arange(1, P))[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    held = boundary_held(C_MODEL)
    for b, h in enumerate(held[:-1]):
        bt[b, -(-h // PAGE):] = 0
    pos = np.array([max(h - (mode == "plain"), 0) for h in held], np.int32)
    x = {n: rng.standard_normal(s).astype(np.float32) for n, s in (
        ("q", (B, 1, NH, HD)), ("kp", (NL, P, KVH, PAGE, HD)), ("vp", (NL, P, KVH, PAGE, HD)),
        ("ck", (B, KVH, HD)), ("cv", (B, KVH, HD)), ("wk", (B, KVH, Q, HD)),
        ("wv", (B, KVH, Q, HD)))}
    return x, bt, pos


def torch_call(x, bt, pos, mode, dtype):
    """(args, kwargs) of the port's call in `dtype` (int8: pools and rows
    quantized per token and KV head, q and scales f32)."""
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    sc = {}
    if dtype == torch.int8:
        (t["kp"], sc["k_scale"]), (t["vp"], sc["v_scale"]) = (quantize_kv_rows(t[n]) for n in ("kp", "vp"))
        (t["ck"], sc["cur_ks"]), (t["cv"], sc["cur_vs"]) = (quantize_kv_rows(t[n]) for n in ("ck", "cv"))
        (t["wk"], sc["win_ks"]), (t["wv"], sc["win_vs"]) = (quantize_kv_rows(t[n]) for n in ("wk", "wv"))
    elif dtype == torch.bfloat16:
        t = {n: a.to(dtype) for n, a in t.items()}
    bt, pos = torch.from_numpy(bt), torch.from_numpy(pos)
    if mode == "plain":
        kw = {k: sc[k][LAYER] for k in ("k_scale", "v_scale")} if sc else {}
        return (t["q"], t["kp"][LAYER], t["vp"][LAYER], bt, pos), kw
    kw = dict(layer=LAYER, cur_k=t["ck"], cur_v=t["cv"])
    kw.update({k: sc[k] for k in ("k_scale", "v_scale", "cur_ks", "cur_vs")} if sc else {})
    if mode == "window":
        kw.update(win_k=t["wk"], win_v=t["wv"], win_count=2)
        kw.update({k: sc[k] for k in ("win_ks", "win_vs")} if sc else {})
    return (t["q"], t["kp"], t["vp"], bt, pos), kw


def jax_call(args, kw, mode):
    """The same call to the JAX kernel in interpret mode (int8: the scales
    gathered per row, as the JAX serving path feeds them)."""
    q, kp, vp, bt, pos = args

    def j(a):
        if a.dtype == torch.bfloat16:
            return jnp.asarray(a.float().numpy(), jnp.bfloat16)
        return jnp.asarray(a.numpy())

    jkw = {}
    if "k_scale" in kw:
        gather = (jops.gather_page_scales if mode == "plain"
                  else lambda s, b: jops.gather_page_scales_stacked(s, LAYER, b))
        jkw.update(k_scale_rows=gather(j(kw["k_scale"]), j(bt)),
                   v_scale_rows=gather(j(kw["v_scale"]), j(bt)))
    if mode != "plain":
        jkw.update(layer=LAYER, cur_k=j(kw["cur_k"]), cur_v=j(kw["cur_v"]))
        for n in ("cur_ks", "cur_vs", "win_k", "win_v", "win_ks", "win_vs"):
            if n in kw:
                jkw[n] = j(kw[n])
        if "win_count" in kw:
            jkw["win_count"] = jnp.int32(kw["win_count"])
    return np.asarray(j_paged_attention(j(q), j(kp), j(vp), j(bt), j(pos), interpret=True,
                                        **jkw), np.float32)


@pytest.mark.parametrize("mode", ["plain", "stacked", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.bfloat16],
                         ids=["fp32", "int8", "bf16"])
def test_chunked_paged_schedule_matches_plain_and_jax(rng, dtype, mode):
    x, bt, pos = paged_inputs(rng, mode)
    args, kw = torch_call(x, bt, pos, mode, dtype)
    want = paged_attention_plain(*args, **kw)
    want_jax = jax_call(args, kw, mode)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for C in (1, C_MODEL, 3, MAXP):  # C = MAXP: every row fits one chunk
        got = chunked_paged_attention(*args, C=C, **kw)
        assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
        assert_allclose(got.float().numpy(), want.float().numpy(), **tol)
        assert_allclose(got.float().numpy(), want_jax, **tol)


def test_chunked_paged_schedule_rows_are_independent(rng):
    """The overrun guarantee: a row's output depends on its own length
    only, so moving another row's pos leaves it bit for bit the same."""
    x, bt, pos = paged_inputs(rng, "stacked")
    args, kw = torch_call(x, bt, pos, "stacked", torch.float32)
    base = chunked_paged_attention(*args, C=C_MODEL, **kw)
    moved = args[4].clone()
    moved[3] = MAXP * PAGE + 40  # row 3 now runs past its table
    got = chunked_paged_attention(*args[:4], moved, C=C_MODEL, **kw)
    others = torch.arange(B) != 3
    assert torch.equal(got[others], base[others])


# ---------------------------------------------------------------------------
# (b) the chunk size is a function of static shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kvh,page,maxp", [
    (8, 8, 16, 512),   # llama3-8b serving (C = 16: 256 tokens a block)
    (8, 4, 16, 128),   # tinyllama-1.1b serving (C = 8)
    (4, 6, 16, 64),    # stories15M
    (64, 8, 16, 512),  # a wide batch: still at most 256 tokens a block
    (3, 2, 4, 5),      # a table shorter than the wanted chunk
    (1, 1, 128, 3),    # pages larger than a block's wanted tokens
])
def test_chunk_size_depends_on_static_shapes_only(rng, b, kvh, page, maxp):
    sms = 132
    q = torch.zeros(b, 1, 2 * kvh, 16)
    pool = torch.zeros(3, kvh, page, 16)
    table = torch.zeros(b, maxp, dtype=torch.int32)
    C, S = schedule(q, pool, table, torch.zeros(b, dtype=torch.int32), sms)
    assert C == chunk_pages(b, kvh, page, maxp, sms)
    assert 1 <= C <= maxp and S == -(-maxp // C)
    assert C * page <= max(256, page)
    for pos in (torch.full((b,), maxp * page - 1, dtype=torch.int32),
                torch.from_numpy(rng.integers(-1, 3 * maxp * page, size=b).astype(np.int32)),
                torch.empty(b, dtype=torch.int32, device="meta")):  # no values at all
        assert schedule(q, pool, table, pos, sms) == (C, S)
    with pytest.raises(ValueError):
        schedule(q, pool, table, torch.zeros(b + 1, dtype=torch.int32), sms)


# ---------------------------------------------------------------------------
# (c) flash prefill's split-P arithmetic
# ---------------------------------------------------------------------------

def split_p_flash(q, k, v, kv_tile=64, split=True):
    """The bf16 flash kernel's arithmetic in f32 on bf16 inputs: QK^T of
    bf16 values (exact products, f32 sums), an online softmax over
    `kv_tile`-key tiles with masked entries an explicit 0, P.V as
    P_hi.V + P_lo.V (`split`; else P rounded to bf16 once), the normalizer
    the f32 P's sum clamped at 1e-30.  Returns f32, before the output's
    bf16 rounding."""
    Bq, L, nh, hd = q.shape
    g = nh // k.shape[2]
    out = torch.empty(Bq, L, nh, hd)
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    for b in range(Bq):
        for h in range(nh):
            qh, kh, vh = q[b, :, h].float(), k[b, :, h // g].float(), v[b, :, h // g].float()
            m = torch.full((L,), -math.inf)
            l, acc = torch.zeros(L), torch.zeros(L, hd)
            for t0 in range(0, L, kv_tile):
                vis = mask[:, t0 : t0 + kv_tile]
                s = torch.where(vis, (qh @ kh[t0 : t0 + kv_tile].T) / math.sqrt(hd), -math.inf)
                m_new = torch.maximum(m, s.max(-1).values)
                alpha = torch.where(m == -math.inf, 0.0, torch.exp(m - m_new))
                p = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
                vt = vh[t0 : t0 + kv_tile]
                acc = acc * alpha[:, None] + hi @ vt + lo @ vt
                l, m = l * alpha + p.sum(-1), m_new
            out[b, :, h] = acc / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("name,nh,kvh,hd", [("test-tiny", 4, 2, 16), ("test-tiny-mha", 3, 3, 16)])
@pytest.mark.parametrize("L", [1, 17, 64, 100])
def test_split_p_flash_needs_no_new_envelope(rng, name, nh, kvh, hd, L):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, L, h, hd)).astype(np.float32))
               .to(torch.bfloat16) for h in (nh, kvh, kvh))
    got = split_p_flash(q, k, v, kv_tile=16)
    want = causal_attention(q.float(), k.float(), v.float())  # the plain version, unrounded
    want_jax = np.asarray(j_flash_prefill(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                          q_block=L, kv_block=L, interpret=True))
    bound = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= bound
    assert np.abs(got.numpy() - want_jax).max() <= bound
    # Rounded once, the kernel's output is the plain version's within its
    # one bf16 rounding; P rounded to bf16 once would not meet the bound.
    assert_allclose(got.bfloat16().float().numpy(),
                    flash_prefill_plain(q, k, v).float().numpy(), **BF16_TOL)
    if L >= 17:
        once = split_p_flash(q, k, v, kv_tile=16, split=False)
        assert float((once - want).abs().max()) > bound
