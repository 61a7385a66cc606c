"""The schedule of the port's fused decode kernel (`csrc/decode_step.cu`),
modelled in plain PyTorch on the CPU and held against the kernel's plain
version (`decode_layers_plain`) and, for the int8/bf16 mode, against the
JAX streamed kernel in interpret mode, on inputs made with numpy from a
seed.

(a) Every GEMV splits K into row ranges over column tiles of 512 bytes
    of a row (the splits fill whole waves of two blocks an SM); the last block to arrive at a tile sums the
    tile's partial columns in split order, applies the per-column scale
    and the epilogue (the residual, rounded at a bf16 layer's end, and the
    tile's sum of squares); the next GEMV forms its RMSNorm from those
    per-tile sums in tile order.  Attention splits the cache rows of each
    KV head into position chunks (at least 16 rows each), split 0 takes
    the appended column, and the last split to arrive merges the splits'
    (max, sum, P.V) in a fixed order.  Positions sit at the split
    boundaries (0, 1, 15, 16, 17, M-1), in all four modes, with a small SM
    count so that tiles and splits are many at these widths.
(b) The int8/bf16 mode's plain version against the JAX streamed decode
    kernel (int8 scale blocks, bf16 rounding points) in interpret mode, on
    int8-grid weights, whose per-(block, column) and per-column scales
    dequantize to the same weights.

The model lives here, not in the package: the kernel is its
implementation on the card.

Tolerances: fp32 and int8 rtol 2e-4 / atol 1e-4 (sums in another order);
bf16 activations rtol = atol = 3e-2 (tests/test_torch_bf16.py's DECODE_TOL:
1-ulp bf16 flips at many rounding points over the layers).
"""

import math

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu.ops.core import rope_tables as j_rope_tables
from llama3np_tpu.ops.kernels.decode_step import decode_layers as j_decode_layers
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BF16 = torch.bfloat16

TILE_BYTES, STAGE_ROWS, MAX_SPLIT = 512, 32, 32   # csrc/decode_step.cu
SMALL_GEMV_BYTES, SMALL_SPLIT = 2 << 20, 12
ATTN_MAX_SPLIT, ATTN_MIN_ROWS, ATTN_STAGE_BYTES = 128, 16, 64 * 1024
MODES = {"fp32": (False, torch.float32), "int8": (True, torch.float32),
         "bf16": (False, BF16), "int8-bf16": (True, BF16)}


# ---------------------------------------------------------------------------
# (a) the kernel's schedule
# ---------------------------------------------------------------------------

def plan_gemv(K, N, itemsize, slots):
    """(columns a tile, tiles, rows a split, splits) of one GEMV: the fewest
    splits within 2 % of the best fill of whole waves of `slots` blocks, at
    most 12 for a GEMV under 2 MB."""
    cols = TILE_BYTES // itemsize
    nb = -(-N // cols)
    best, best_eff = 1, -1.0
    cap = SMALL_SPLIT if K * N * itemsize < SMALL_GEMV_BYTES else MAX_SPLIT
    for s in range(1, max(1, min(cap, -(-K // STAGE_ROWS))) + 1):
        waves = -(-nb * s // slots)
        if waves > 4:
            break
        eff = nb * s / (waves * slots)
        if eff > best_eff + 0.02:
            best, best_eff = s, eff
    rps = -(-K // best)
    return cols, nb, rps, -(-K // rps)


def gemv(a, w, scale, slots):
    """a [K] f32 @ w [K, N]: each split's partial columns, summed in split
    order (the last block's reduction), the scale on the finished sum."""
    K, N = w.shape
    _, _, rps, ks = plan_gemv(K, N, w.element_size(), slots)
    out = None
    for s in range(ks):
        part = a[s * rps : (s + 1) * rps] @ w[s * rps : (s + 1) * rps].float()
        out = part if out is None else out + part
    return out if scale is None else out * scale.reshape(-1)


def tile_sums(x, cols):
    """The per-tile sums of squares the finishing blocks write."""
    return [float((x[t : t + cols] ** 2).sum()) for t in range(0, x.numel(), cols)]


def rms_from(x, ss, w, eps):
    rs = 1.0 / math.sqrt(sum(ss) / x.numel() + eps)  # tile order
    return x * rs * w.float().reshape(-1)


def attn_schedule(pos, kvh, sms, hd, itemsize):
    """(splits, rows a split) of attention at `pos`: ~2 blocks an SM, at
    least 16 rows a split, at most 64 KB of staged K and V rows."""
    rows = ATTN_STAGE_BYTES // (2 * (hd * itemsize + 16))
    S = min(-(-pos // ATTN_MIN_ROWS), -(-2 * sms // kvh))
    S = max(1, min(max(S, -(-pos // rows)), ATTN_MAX_SPLIT))
    return S, pos if S == 1 else -(-pos // S)


def attend(q, ks, vs, k_new, v_new, pos, S, chunk, scale):
    """One KV head's G heads: each split's (max, sum, P.V) over its rows,
    split 0 with the appended column, then the merge."""
    parts = []
    for s in range(S):
        j0 = s * chunk
        n = max(0, min(pos, j0 + chunk) - j0)
        sc = (q @ ks[j0 : j0 + n].T) * scale                 # [G, n]
        vv = vs[j0 : j0 + n]
        if s == 0:
            sc = torch.cat([sc, (q @ k_new[:, None]) * scale], dim=1)
            vv = torch.cat([vv, v_new[None]], dim=0)
        if sc.shape[1] == 0:
            parts.append((torch.full((q.shape[0], 1), -math.inf),
                          torch.zeros(q.shape[0], 1), torch.zeros_like(q)))
            continue
        m = sc.amax(dim=1, keepdim=True)
        p = torch.exp(sc - m)
        parts.append((m, p.sum(dim=1, keepdim=True), p @ vv))
    if S == 1:
        m, l, acc = parts[0]
        return acc / l
    mx = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = acc = 0.0
    for m, ls, a in parts:
        w = torch.exp(m - mx)
        l = l + ls * w
        acc = acc + a * w
    return acc / l


def scheduled_decode_layers(layers, x, pos, kc, vc, cos, sin, *, n_heads, kv_heads,
                            head_dim, norm_eps, sms):
    """`decode_layers` as the kernel schedules it, in plain PyTorch."""
    nh, kvh, hd, eps = n_heads, kv_heads, head_dim, norm_eps
    g, half = nh // kvh, hd // 2
    qd, kvd = nh * hd, kvh * hd
    bf16 = x.dtype == BF16
    act = (lambda t: t.to(BF16).float()) if bf16 else (lambda t: t)
    cos, sin = cos.float().reshape(-1), sin.float().reshape(-1)

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)

    def proj(a, name, layer):
        s = layers.get(name + "_scale")
        return gemv(act(a), layers[name][layer], None if s is None else s[layer],
                    2 * sms)  # two blocks an SM

    cols = TILE_BYTES // layers["wo"].element_size()
    S, chunk = attn_schedule(pos, kvh, sms, hd, kc.element_size())
    h = x.float().reshape(-1)
    ss = [float((h * h).sum())]  # layer 0: the norm's own sum
    for layer in range(layers["wqkv"].shape[0]):
        qkv = proj(rms_from(h, ss, layers["attn_norm"][layer], eps), "wqkv", layer)
        q = rope(qkv[:qd].reshape(kvh, g, hd))
        k_new = rope(qkv[qd : qd + kvd].reshape(kvh, hd))
        v_new = qkv[qd + kvd :].reshape(kvh, hd)
        attn = torch.stack([
            attend(q[k], kc[layer, k].float(), vc[layer, k].float(), k_new[k], v_new[k],
                   pos, S, chunk, 1.0 / math.sqrt(hd)) for k in range(kvh)])
        kc[layer, :, pos] = k_new.to(kc.dtype)
        vc[layer, :, pos] = v_new.to(vc.dtype)
        hb = h + proj(attn.reshape(-1), "wo", layer)
        gu = proj(rms_from(hb, tile_sums(hb, cols), layers["ffn_norm"][layer], eps),
                  "wgu", layer)
        fd = gu.numel() // 2
        gate = gu[:fd]
        h = hb + proj(gate * (1.0 / (1.0 + torch.exp(-gate))) * gu[fd:], "w_down", layer)
        h = act(h)  # bf16: the layer's end
        ss = tile_sums(h, cols)
    return h.reshape(1, -1).to(x.dtype)


def _tree(rng, mode, nl=2, d=128, nh=4, kvh=2, fd=384):
    """A fused whole-layer tree of seeded random weights in `mode`."""
    int8, dt = MODES[mode]
    hd = d // nh
    tree = {n: torch.from_numpy(1 + 0.05 * rng.standard_normal((nl, 1, d))).float().to(dt)
            for n in ("attn_norm", "ffn_norm")}
    for name, (k, n) in {"wqkv": (d, (nh + 2 * kvh) * hd), "wo": (nh * hd, d),
                         "wgu": (d, 2 * fd), "w_down": (fd, d)}.items():
        if int8:
            tree[name] = torch.from_numpy(rng.integers(-127, 128, (nl, k, n)).astype(np.int8))
            tree[name + "_scale"] = torch.from_numpy(
                (0.05 / 127) * (0.5 + rng.random((nl, 1, n)))).float()
        else:
            tree[name] = torch.from_numpy(0.05 * rng.standard_normal((nl, k, n))).float().to(dt)
    return tree


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("pos", [0, 1, 15, 16, 17, 63])
def test_scheduled_decode_matches_plain(rng, mode, pos):
    """The split-K schedule (last-arriving tiles in split order, norms from
    per-tile sums) and attention's position splits with their merge agree
    with decode_layers_plain; the cache rows at `pos` too, the others
    untouched."""
    nl, d, nh, kvh, M, sms = 2, 128, 4, 2, 64, 4
    hd = d // nh
    dt = MODES[mode][1]
    layers = _tree(rng, mode)
    kc = torch.from_numpy(rng.standard_normal((nl, kvh, M, hd))).float().to(dt)
    vc = torch.from_numpy(rng.standard_normal((nl, kvh, M, hd))).float().to(dt)
    x = torch.from_numpy(rng.standard_normal((1, d))).float().to(dt)
    ang = torch.from_numpy(rng.random((1, hd // 2))).float() * pos
    kw = dict(n_heads=nh, kv_heads=kvh, head_dim=hd, norm_eps=1e-5)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = scheduled_decode_layers(layers, x, pos, k1, v1, ang.cos(), ang.sin(), sms=sms, **kw)
    want = decode_layers_plain(layers, x, pos, k2, v2, ang.cos(), ang.sin(), **kw)[0]
    tol = BF16_TOL if dt == BF16 else F32_TOL
    assert got.dtype == want.dtype == dt
    assert_allclose(got.float().numpy(), want.float().numpy(), **tol)
    assert_allclose(k1.float().numpy(), k2.float().numpy(), **tol)
    assert_allclose(v1.float().numpy(), v2.float().numpy(), **tol)
    others = torch.arange(M) != pos
    assert torch.equal(k1[:, :, others], kc[:, :, others])


def test_schedule_splits_at_these_widths():
    """The test widths do exercise the schedule: several tiles or splits
    per GEMV in every weight width, and 1, 2 and 4 attention splits at the
    boundary positions."""
    for itemsize in (4, 2, 1):
        for K, N in ((128, 256), (128, 128), (128, 768), (384, 128)):
            cols, nb, rps, ks = plan_gemv(K, N, itemsize, 8)
            assert nb * ks > 1 and rps * ks >= K > rps * (ks - 1)
    assert [attn_schedule(p, 2, 4, 32, 4)[0] for p in (0, 1, 15, 16, 17, 63)] == [1, 1, 1, 1,
                                                                                 2, 4]
    # llama3-8b at its last row: 69 splits of 119 rows (at most 120 padded
    # K and V rows in 64 KB), not 33 of 249; at row 511, 32 splits of 16.
    assert attn_schedule(8191, 8, 132, 128, 2) == (69, 119)
    assert attn_schedule(511, 8, 132, 128, 2) == (32, 16)


# ---------------------------------------------------------------------------
# (b) the int8/bf16 mode against the JAX streamed kernel
# ---------------------------------------------------------------------------

STREAM = {"test-tiny": (32, 16, 32, 32), "test-tiny-mha": (24, 16, 24, 48)}


def grid_weights(args, seed):
    """Synthetic weights snapped per output channel onto an int8 grid (the
    rule of tests/test_quant.py), so that quantization round-trips."""
    from llama3np_tpu import synthetic_weights as jsynth

    out = {}
    for k, v in jsynth(args, seed).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 2:
            s = np.maximum(np.max(np.abs(v), axis=-1, keepdims=True) / 127.0, 1e-12)
            v = (np.clip(np.rint(v / s), -127, 127) * s).astype(np.float32)
        out[k] = v
    return out


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_layers_int8_bf16_matches_jax_streamed(rng, name, where):
    """int8 weights under bf16 activations: the port's decode step (CPU:
    its plain version) against the JAX streamed kernel in interpret mode
    (`_wdot`: bf16 activation, int8 widened to bf16, f32 sums, the scale
    post-multiplied), with its KV-head-grouped, FFN-blocked int8 tree of
    the same grid weights."""
    args = jpreset(name, dtype="bfloat16", quant="int8")
    plan = STREAM[name]
    w = grid_weights(args, seed=13)
    jtree = jckpt.fuse_param_tree(
        jckpt.permute_rope_layout(jckpt.build_param_tree(w, args), args), plan[3],
        attn_group=True, n_heads=args.n_heads, kv_heads=args.kv_heads,
        head_dim=args.head_dim)
    jlayers = jckpt.quantize_param_tree(jtree)["layers"]
    jlayers = {k: jnp.asarray(v, jnp.bfloat16 if np.asarray(v).dtype == np.float32
                              and not k.endswith("_scale") else None)
               for k, v in jlayers.items()}
    targs = tpreset(name, dtype="bfloat16", quant="int8")
    ttree = tckpt.quantize_param_tree(tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(w, targs), targs)))
    tlayers = tckpt.params_to_device(ttree, "cpu", "bfloat16")["layers"]
    assert tlayers["wqkv"].dtype == torch.int8 and tlayers["attn_norm"].dtype == BF16

    M = args.max_seq_len
    pos = {"first": 0, "mid": M // 2 - 3, "last": M - 1}[where]
    shape = (args.n_layers, args.kv_heads, M, args.head_dim)

    def pair(a):
        return torch.from_numpy(a).to(BF16), jnp.asarray(a, jnp.bfloat16)

    tk, jk = pair(rng.standard_normal(shape).astype(np.float32))
    tv, jv = pair(rng.standard_normal(shape).astype(np.float32))
    tx, jx = pair(rng.standard_normal((1, args.dim)).astype(np.float32))
    cos, sin = j_rope_tables(args.head_dim, M, args.rope_theta)
    cos_row, sin_row = np.array(cos)[pos : pos + 1], np.array(sin)[pos : pos + 1]
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads, head_dim=args.head_dim,
              norm_eps=args.norm_eps)
    jx_out, jk2, jv2 = j_decode_layers(
        jlayers, jx, jnp.int32(pos), jk, jv, jnp.asarray(cos_row), jnp.asarray(sin_row),
        interpret=True, stream_plan=plan, **kw)
    k0 = tk.clone()
    before = decode_layers.launches
    x_out, _, _ = decode_layers(tlayers, tx, pos, tk, tv, torch.from_numpy(cos_row),
                                torch.from_numpy(sin_row), **kw)
    assert decode_layers.launches == before  # CPU: the plain version
    assert x_out.dtype == BF16
    f32 = lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    assert_allclose(f32(x_out), f32(jx_out), **BF16_TOL)
    assert_allclose(f32(tk[:, :, pos]), f32(jk2)[:, :, pos], **BF16_TOL)
    assert_allclose(f32(tv[:, :, pos]), f32(jv2)[:, :, pos], **BF16_TOL)
    others = torch.arange(M) != pos
    assert torch.equal(tk[:, :, others], k0[:, :, others])
