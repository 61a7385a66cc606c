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
(d) The float32 flash kernel's schedule: query tiles of BM rows chosen from
    L, each tile's key tiles of 64 cut into pieces of KS (L >= 256), every
    piece an online softmax of its own, the pieces' (m, l, acc) merged in
    piece order; against the JAX kernel in interpret mode and the plain
    version at L in {1, 15, 16, 17, 64, 100, 512}, HD in {48, 64}.
(e) The float32 kernel's tensor-core form (L >= 256, HD <= 64): every f32
    operand of QK^T and P.V cut into three bf16 pieces and each product
    taken as the six products of pieces whose orders add up to at most 2,
    in f32: inside the fp32 tolerance of the JAX kernel, with inputs next
    to the subnormals too; with large scores (where any two f32 summation
    orders part by more than the tolerance) as close to a float64
    reference as the plain f32 version is.

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
from llama3np_tpu_torch.ops.kernels.flash_prefill import (
    F32_KEY_TILE, f32_plan, f32_scratch_words, flash_prefill, flash_prefill_plain)
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


# ---------------------------------------------------------------------------
# (d) the float32 flash kernel's tiles, key pieces and merge
# ---------------------------------------------------------------------------

def pieced_flash_f32(q, k, v, dot=torch.matmul):
    """The float32 kernel's schedule in f32: for each query tile of BM rows
    (`f32_plan`), its visible key tiles of 64 in pieces of KS, each piece an
    online softmax over its key tiles (masked entries an explicit 0); one
    piece is normalized as it stands, several are merged in piece order,
    rescaled to the rows' common max, the normalizer clamped at 1e-30.
    `dot` takes the two products (QK^T and P.V)."""
    Bq, L, nh, hd = q.shape
    g = nh // k.shape[2]
    BM, KS = f32_plan(L)
    T = F32_KEY_TILE
    out = torch.empty(Bq, L, nh, hd)
    for b in range(Bq):
        for h in range(nh):
            qh, kh, vh = q[b, :, h], k[b, :, h // g], v[b, :, h // g]
            for q0 in range(0, L, BM):
                rows = torch.arange(q0, min(q0 + BM, L))
                n_keys = min(q0 + BM, L)
                n_kt = -(-n_keys // T)
                parts = []
                for kt0 in range(0, n_kt, KS):
                    m = torch.full((len(rows),), -1e30)
                    l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), hd)
                    for t0 in range(kt0 * T, min(n_kt, kt0 + KS) * T, T):
                        keys = torch.arange(t0, min(t0 + T, n_keys))
                        vis = keys[None, :] <= rows[:, None]
                        s = torch.where(vis, dot(qh[rows], kh[keys].T) / math.sqrt(hd), -1e30)
                        m_new = torch.maximum(m, s.max(-1).values)
                        p = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
                        alpha = torch.exp(m - m_new)
                        l, acc = l * alpha + p.sum(-1), acc * alpha[:, None] + dot(p, vh[keys])
                        m = m_new
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    _, l, acc = parts[0]
                else:
                    mx = torch.stack([p[0] for p in parts]).max(0).values
                    w = [torch.exp(p[0] - mx) for p in parts]
                    l = sum(wi * p[1] for wi, p in zip(w, parts))
                    acc = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
                out[b, rows, h] = acc / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("hd", [48, 64])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 64, 100, 512])
def test_pieced_flash_f32_matches_jax_and_plain(rng, L, hd):
    nh, kvh = 4, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, h, hd)).astype(np.float32))
               for h in (nh, kvh, kvh))
    got = pieced_flash_f32(q, k, v)
    want_jax = np.asarray(j_flash_prefill(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                          interpret=True))
    assert torch.isfinite(got).all()
    assert_allclose(got.numpy(), want_jax, **F32_TOL)
    assert_allclose(got.numpy(), flash_prefill_plain(q, k, v).numpy(), **F32_TOL)
    assert torch.equal(flash_prefill(q, k, v), flash_prefill_plain(q, k, v))  # CPU: the twin
    BM, KS = f32_plan(L)
    if L >= 256:  # the long tiles really are merged from several pieces
        assert -(-(-(-L // F32_KEY_TILE)) // KS) > 1


@pytest.mark.parametrize("L,BM,KS", [
    (1, 16, 1), (16, 16, 1), (64, 16, 1), (100, 16, 2), (128, 16, 2),   # stories15M prompts
    (129, 64, 3), (255, 64, 4), (256, 64, 2), (500, 64, 4), (512, 64, 4),
    (1024, 64, 8), (2048, 64, 16),
])
def test_f32_tile_height_and_pieces_from_L(L, BM, KS):
    """16 query rows a block for short prompts (a 16-token prompt computes
    16 rows, not 64), more for longer ones; from L = 256 at most two
    pieces of at least two key tiles a query tile."""
    assert f32_plan(L) == (BM, KS)
    n_kt = -(-L // F32_KEY_TILE)
    pieces = -(-n_kt // KS)
    assert pieces == 1 if L < 256 else pieces == 2
    words, tickets = f32_scratch_words(2, L, 3, 48)
    tiles = 2 * 3 * -(-L // BM)
    assert (words, tickets) == ((0, 0) if pieces == 1 else (tiles * pieces * BM * 50, tiles))


# ---------------------------------------------------------------------------
# (e) the tensor-core form: f32 products from three bf16 pieces
# ---------------------------------------------------------------------------

def split3(x):
    """x = x0 + x1 + x2, each piece a bf16 value (held in f32)."""
    x0 = x.bfloat16().float()
    r = x - x0
    x1 = r.bfloat16().float()
    return x0, x1, (r - x1).bfloat16().float()


def x3_dot(a, b):
    """a @ b as the kernel's six products of pieces (orders i + j <= 2),
    the smallest first; products of bf16 values are exact in f32."""
    pa, pb = split3(a), split3(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        out = out + pa[i] @ pb[j]
    return out


def test_split3_is_exact_for_normal_values(rng):
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * np.float32(10.0) ** rng.integers(-30, 30, 4096).astype(np.float32))
    x0, x1, x2 = split3(x)
    assert torch.equal((x0.double() + x1.double() + x2.double()).float(), x)


@pytest.mark.parametrize("inputs", ["normal", "near-subnormal"])
@pytest.mark.parametrize("hd", [48, 64])
@pytest.mark.parametrize("L", [256, 512])
def test_x3_flash_f32_inside_the_fp32_tolerance(rng, L, hd, inputs):
    nh, kvh = 2, 1
    q, k, v = (rng.standard_normal((1, L, h, hd)).astype(np.float32) for h in (nh, kvh, kvh))
    if inputs == "near-subnormal":  # a third of each row's entries at 1e-36 .. 1e-39
        for t in (q, k, v):
            t[..., ::3] *= np.float32(1e-37)
    q, k, v = (torch.from_numpy(t) for t in (q, k, v))
    got = pieced_flash_f32(q, k, v, dot=x3_dot)
    want_jax = np.asarray(j_flash_prefill(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                          interpret=True))
    assert torch.isfinite(got).all()
    assert_allclose(got.numpy(), want_jax, **F32_TOL)
    assert_allclose(got.numpy(), flash_prefill_plain(q, k, v).numpy(), rtol=1e-4, atol=1e-5)


def attention_f64(q, k, v):
    """Causal GQA attention in float64: the reference for large scores."""
    B, L, nh, hd = q.shape
    g = nh // k.shape[2]
    out = torch.empty(B, L, nh, hd, dtype=torch.float64)
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    for b in range(B):
        for h in range(nh):
            s = (q[b, :, h].double() @ k[b, :, h // g].double().T) / math.sqrt(hd)
            out[b, :, h] = torch.softmax(s.masked_fill(~mask, -math.inf), -1) @ v[b, :, h // g].double()
    return out


@pytest.mark.parametrize("hd", [48, 64])
def test_x3_flash_f32_large_scores_as_accurate_as_f32(rng, hd):
    """Scores in the hundreds (q, k x 12) and values at 1e4: the softmax
    turns a score error of one f32 rounding into an output error past the
    fp32 tolerance, for any summation order but the plain version's own; so
    the split form is held to a float64 reference, no further from it than
    twice the plain f32 version's distance."""
    L, nh, kvh = 256, 2, 1
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, h, hd)).astype(np.float32))
               for h in (nh, kvh, kvh))
    q, k, v = q * 12, k * 12, v * 1e4
    ref = attention_f64(q, k, v)
    err_x3 = float((pieced_flash_f32(q, k, v, dot=x3_dot).double() - ref).abs().max())
    err_f32 = float((flash_prefill_plain(q, k, v).double() - ref).abs().max())
    assert err_x3 <= 2 * err_f32
