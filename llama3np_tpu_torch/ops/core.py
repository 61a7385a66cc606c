"""Plain PyTorch ops: RMSNorm, SwiGLU, fused projections, RoPE, causal and
cache attention, and the serving path's ragged and paged decode attention
and cache commits.

The counterparts of `llama3np_tpu.ops.core`, with the same arguments,
layouts and numerics: f32 accumulation under low-precision weights, GQA as a
grouped einsum (KV heads are never repeated), masks instead of
data-dependent slicing.  They run wherever no kernel does: on the CPU, under
`attn_impl="xla"`, and for the chunked prefill against the cache, which
stays plain in both packages.  The dense projections (`_dot`) are left to
the library, as the JAX package left them to XLA: on the card a 16-bit
activation times a 16-bit weight is one tensor-core GEMM with f32 sums and
an f32 result (`jnp.dot(..., preferred_element_type=jnp.float32)`); every
other product is `torch.matmul` on operands widened to f32.

Positions (`pos`) of the dense path are host integers: the port's loops
know them on the host.  The serving ops take per-row positions as [B]
integer tensors on the device, and update caches and pools in place (the
JAX package returns new arrays); each commit is one advanced-index
assignment into the pool.

int8 and int4 weights (`checkpoint.quantize_param_tree`) enter the
projections as per-output scales that post-multiply the f32 product
(`scale`, `scale_gu`, `scale_down`, `s_gate`/`s_up`/`s_down`); the product
itself is `torch.matmul` on the weight widened to f32 (an int4 weight,
packed two a byte, unpacked first), as XLA computed it outside any Pallas
kernel.  int8 KV (`quantize_kv_rows`) carries a scale
per (token, KV head): K scales post-multiply the score columns, V scales
fold into the probabilities, and no dequantized row is kept.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


_INT4_PAIRS: Dict = {}  # (device, dtype) -> the [256, 2] byte -> (lo, hi) table


def unpack_int4(p: torch.Tensor, n: Optional[int] = None,
                dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Packed int4 (torch.uint8 [..., m], two values a byte along the last
    axis, the even one in the low nibble) -> its values [..., n] (n
    defaults to 2m) as `dtype`, each nibble sign-extended: one lookup of
    every byte in a 256-row table of its two values."""
    key = (p.device, dtype)
    if key not in _INT4_PAIRS:
        b = torch.arange(256)
        pairs = torch.stack([((b & 15) ^ 8) - 8, ((b >> 4) ^ 8) - 8], dim=-1)
        _INT4_PAIRS[key] = pairs.to(device=p.device, dtype=dtype)
    out = _INT4_PAIRS[key][p.int()].reshape(*p.shape[:-1], -1)
    return out if n is None or n == out.shape[-1] else out[..., :n]


# Calls of `_dot` on each path, counted like the kernels' `launches`, so a
# run can show which path its products took.
dot_calls = {"tensor_core": 0, "widened": 0}


def dot_path(device_type: str, a_dtype: torch.dtype, b_dtype: torch.dtype,
             b_dim: int, grad: bool) -> str:
    """Which product `_dot` computes, from what it can observe:
    "tensor_core" for a bf16 x bf16 or fp16 x fp16 product with a 2-D
    weight on the card outside autograd, else "widened".  An f32
    activation under a 16-bit weight stays widened (rounding it would lose
    precision), and so do integer weights, the 3-D per-row LoRA factors,
    the CPU (the tests' parity path) and anything autograd records."""
    if (device_type == "cuda" and a_dtype == b_dtype
            and a_dtype in (torch.bfloat16, torch.float16) and b_dim == 2 and not grad):
        return "tensor_core"
    return "widened"


def _dot(a: torch.Tensor, b: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """a @ b accumulated and returned in float32 (the JAX package's
    `preferred_element_type=jnp.float32`).  On the card a 16-bit product
    (`dot_path`) is one GEMM on its 16-bit operands with f32 sums and an
    f32 result, `a` flattened to 2-D: a product of two bf16 or two fp16
    values is exact in f32, so only the order of the sums differs from the
    widened product, and no f32 copy of either operand is made.  Every
    other product widens both operands to f32 (`_widened_dot`).  Under
    autograd, a frozen 16-bit or integer `b` goes through `_FrozenDot`,
    which keeps `b` itself for the backward instead of its float32 copy."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    path = dot_path(a.device.type, a.dtype, b.dtype, b.dim(), grad)
    dot_calls[path] += 1
    if path == "tensor_core":
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if grad and a.requires_grad and not b.requires_grad and b.dtype != torch.float32:
        return _FrozenDot.apply(a, b, n)
    return _widened_dot(a, b, n)


def _widened_dot(a: torch.Tensor, b: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """`torch.matmul` on a and b widened to f32; a packed int4 `b`
    (torch.uint8, `checkpoint.pack_int4`, n output columns) is unpacked
    straight to f32 first (exact), as XLA computed the int4 product."""
    if b.dtype == torch.uint8:
        b = unpack_int4(b, n, torch.float32)
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float())


class _FrozenDot(torch.autograd.Function):
    """`_dot` of a trained input and a frozen weight (LoRA's base): the
    weight is widened again in the backward, so a 16-bit base keeps no
    float32 copy of itself alive between the passes (~32 GB at 8B)."""

    @staticmethod
    def forward(ctx, a, b, n):
        ctx.save_for_backward(b)
        ctx.n, ctx.a_dtype = n, a.dtype
        with torch.no_grad():
            return _widened_dot(a, b, n)

    @staticmethod
    def backward(ctx, g):
        (b,) = ctx.saved_tensors
        w = unpack_int4(b, ctx.n, torch.float32) if b.dtype == torch.uint8 else b.float()
        return torch.matmul(g, w.transpose(-1, -2)).to(ctx.a_dtype), None, None


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b ([N, M, K] x [N, K, P]) accumulated and returned in
    float32, as `_dot`: on the card two 16-bit operands of one dtype make
    one batched tensor-core GEMM with an f32 result, every other product
    widens both to f32."""
    if (a.device.type == "cuda" and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16)):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def grouped_dot(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Expert-grouped product: rows offs[e-1]:offs[e] of a [N, K] (sorted
    by expert) times expert e's weight w[e] ([E, out, K], the row-major
    nn.Linear layout, so that its transposed view is the column-major
    operand the grouped GEMM reads) -> [N, out] in a's dtype.  `offs` [E]
    int32: each expert's cumulative row end, on the device, so no expert
    count reaches the host.  One `torch._grouped_mm` for all experts: on
    the card one tensor-core launch with f32 sums, rounded once to a's
    dtype."""
    return torch._grouped_mm(a, w.transpose(1, 2), offs=offs)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w, accumulated in f32."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w


def _scaled_dot(a: torch.Tensor, w: torch.Tensor, s=None, reduce=None) -> torch.Tensor:
    """a @ w in f32, post-multiplied by the per-output scale `s` of an int8
    or packed int4 weight (None for a float weight; an int4 weight's
    columns are its scale's).  `reduce`: the sum over tensor-parallel
    ranks of a row-sharded weight's f32 partial product, taken before the
    scale (reduce, then scale: the scale is replicated)."""
    out = _dot(a, w) if s is None else _dot(a, w, s.shape[-1])
    if reduce is not None:
        out = reduce(out)
    return out if s is None else out * s


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, s_gate=None, s_up=None,
           s_down=None, lora=None, reduce=None) -> torch.Tensor:
    """SwiGLU FFN on split weights: down( silu(x@gate) * (x@up) ).  int8
    weights pass their scales; gate's applies before the SiLU.

    `lora`: optional callback (target name, input) -> f32 delta or None:
    a serving adapter's delta adds after the scale and before the SiLU or
    the cast (multi-LoRA serving, models/llama.py).  `reduce`: the sum
    over tensor-parallel ranks of the row-sharded down product, in f32
    before its scale and the cast (`_scaled_dot`)."""
    gate = _scaled_dot(x, w_gate, s_gate)
    up = _scaled_dot(x, w_up, s_up)
    if lora is not None:
        dg, du = lora("w_gate", x), lora("w_up", x)
        gate = gate if dg is None else gate + dg
        up = up if du is None else up + du
    h = (F.silu(gate) * up).to(x.dtype)
    out = _scaled_dot(h, w_down, s_down, reduce)
    if lora is not None:
        dd = lora("w_down", h)
        out = out if dd is None else out + dd
    return out.to(x.dtype)


def fused_qkv(x: torch.Tensor, wqkv: torch.Tensor, n_heads: int,
              kv_heads: int, head_dim: int, scale=None):
    """QKV projection on the fused [D, QD+2*KVD] weight (int8 with its
    [1, QD+2*KVD] `scale`); returns (q, k, v) as [B, L, NH, HD] /
    [B, L, KVH, HD]."""
    B, L, _ = x.shape
    qd = n_heads * head_dim
    kvd = kv_heads * head_dim
    qkv = _scaled_dot(x, wqkv, scale).to(x.dtype)
    q = qkv[..., :qd].reshape(B, L, n_heads, head_dim)
    k = qkv[..., qd : qd + kvd].reshape(B, L, kv_heads, head_dim)
    v = qkv[..., qd + kvd :].reshape(B, L, kv_heads, head_dim)
    return q, k, v


def fused_o_proj(attn: torch.Tensor, wo: torch.Tensor,
                 scale=None, lora=None, reduce=None) -> torch.Tensor:
    """Output projection: attn [B, L, NH, HD] with wo [QD, D] (int8 with its
    [1, D] `scale`); returns [B, L, D] in f32 (the caller casts, as in the
    JAX package).  `lora`: optional ("wo", input) -> f32 delta callback,
    added after the scale (split layout only).  `reduce`: the sum over
    tensor-parallel ranks of the row-sharded product (`_scaled_dot`)."""
    B, L = attn.shape[:2]
    flat = attn.reshape(B, L, -1)
    out = _scaled_dot(flat, wo, scale, reduce)
    d = None if lora is None else lora("wo", flat)
    return out if d is None else out + d


def fused_ffn(z: torch.Tensor, wgu: torch.Tensor, w_down: torch.Tensor,
              scale_gu=None, scale_down=None) -> torch.Tensor:
    """SwiGLU on the fused gate|up layout: wgu [D, 2F], w_down [F, D].
    int8 weights pass their scales; `scale_gu` applies before the SiLU
    (which is not linear), `scale_down` after the down-projection."""
    fd = w_down.shape[0]
    gu = _scaled_dot(z, wgu, scale_gu)
    ff = (F.silu(gu[..., :fd]) * gu[..., fd:]).to(z.dtype)
    return _scaled_dot(ff, w_down, scale_down).to(z.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def scale_rope_inv_freq(inv_freq: np.ndarray, scaling: dict) -> np.ndarray:
    """Llama-3.1 frequency remap (HF `rope_type: "llama3"` semantics), in
    numpy f64 on the host like the tables themselves."""
    factor = float(scaling["factor"])
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * np.pi / inv_freq
    smooth = (orig / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = np.where(wavelen > orig / low, inv_freq / factor, inv_freq)
    medium = (wavelen >= orig / high) & (wavelen <= orig / low)
    return np.where(medium, smoothed, out)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor 0.1 * mscale * ln(factor) + 1 (1 for a
    factor of 1 or less): DeepSeek-V2 scales its attention scores by the
    square of it at `mscale_all_dim`, and its cos/sin tables by its ratio
    at `mscale` over `mscale_all_dim`."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(head_dim: int, theta: float, scaling: dict) -> Tuple[int, int]:
    """The rotary pair indices (of head_dim / 2) between which YaRN blends
    its two frequency sets: the pair that turns `beta_fast` times over the
    original context (floored) and the one that turns `beta_slow` times
    (ceiled), clamped to [0, head_dim - 1]."""
    orig = float(scaling["original_max_position_embeddings"])

    def pair(turns):
        return head_dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = math.floor(pair(float(scaling.get("beta_fast", 32))))
    high = math.ceil(pair(float(scaling.get("beta_slow", 1))))
    return max(low, 0), min(high, head_dim - 1)


def yarn_inv_freq(inv_freq: np.ndarray, head_dim: int, theta: float,
                  scaling: dict) -> np.ndarray:
    """YaRN frequencies (HF `rope_scaling` type "yarn", as DeepSeek-V2
    computes them): below the correction range the base frequencies, above
    it the base frequencies / factor, a linear ramp between; numpy f64 on
    the host like the tables."""
    low, high = yarn_correction_range(head_dim, theta, scaling)
    span = max(high - low, 1e-3)  # equal ends: a step, as HF's 0.001
    ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / span, 0.0, 1.0)
    return inv_freq / float(scaling["factor"]) * ramp + inv_freq * (1.0 - ramp)


def rope_tables(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                dtype=torch.float32, scaling: Optional[dict] = None, *,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed cos/sin tables [M, HD//2] on `device`, computed on the
    host in f64 then cast.  `scaling`: the llama3 remap, or YaRN (`"type":
    "yarn"`), whose tables carry its mscale ratio."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64)[: head_dim // 2] / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    mag = 1.0
    if scaling is not None and scaling.get("type") == "yarn":
        inv_freq = yarn_inv_freq(inv_freq, head_dim, theta, scaling)
        factor = float(scaling["factor"])
        mag = (yarn_mscale(factor, float(scaling.get("mscale", 1.0)))
               / yarn_mscale(factor, float(scaling.get("mscale_all_dim", 0.0))))
    elif scaling is not None:
        inv_freq = scale_rope_inv_freq(inv_freq, scaling)
    angles = np.arange(max_seq_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    cos = torch.from_numpy(np.cos(angles) * mag).to(device=device, dtype=dtype)
    sin = torch.from_numpy(np.sin(angles) * mag).to(device=device, dtype=dtype)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs of the last axis.
    x: [B, L, H, HD]; cos/sin: [L, HD//2]."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    xr, xi = xp[..., 0], xp[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)
    return out.reshape(shape).to(x.dtype)


def apply_rope_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in split-halves layout: pairs are (x[..., :HD/2], x[..., HD/2:]);
    equal to `apply_rope` on columns permuted by `rope_split_permutation`."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def rope_split_permutation(n_heads: int, head_dim: int) -> np.ndarray:
    """Column permutation taking interleaved RoPE layout to split-halves:
    perm[new_index] = old_index over the flat [n_heads * head_dim] axis."""
    half = head_dim // 2
    within = np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])
    return (np.arange(n_heads)[:, None] * head_dim + within[None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention within one block (first prefill chunk, start_pos == 0).

    q: [B, L, NH, HD]; k, v: [B, L, KVH, HD].  Returns [B, L, NH, HD].
    """
    B, L, NH, HD = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, L, KVH, NH // KVH, HD).float()
    scores = torch.einsum("blkgd,bmkd->bkglm", qg, k.float()) / math.sqrt(HD)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkglm,bmkd->blkgd", probs.float(), v.float())
    return out.reshape(B, L, NH, HD).to(q.dtype)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Attention of q against the whole static-shape cache, masked to the
    causally visible prefix `kv_idx <= pos + l`.

    q: [B, L, NH, HD] at absolute positions pos..pos+L-1, whose K/V are
    already written into the cache; k_cache, v_cache: [B, KVH, M, HD].
    """
    B, L, NH, HD = q.shape
    KVH, M = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, L, KVH, NH // KVH, HD).float()
    scores = torch.einsum("blkgd,bkmd->bkglm", qg, k_cache.float()) / math.sqrt(HD)
    q_pos = pos + torch.arange(L, device=q.device)[:, None]
    kv_idx = torch.arange(M, device=q.device)[None, :]
    scores = scores.masked_fill(~(kv_idx <= q_pos), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkglm,bkmd->blkgd", probs.float(), v_cache.float())
    return out.reshape(B, L, NH, HD).to(q.dtype)


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos: int,
                               kv_block: int = 512) -> torch.Tensor:
    """Flash-semantics causal attention: online-softmax accumulation over KV
    blocks, so peak memory is O(L * kv_block) instead of O(L * T).

    q: [B, L, NH, HD] at absolute positions pos..pos+L-1; k, v:
    [B, T, KVH, HD], the visible key range from absolute position 0.  T must
    be a multiple of kv_block.
    """
    B, L, NH, HD = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = NH // KVH
    if T % kv_block:
        raise ValueError(f"key length {T} is not a multiple of kv_block {kv_block}")
    qg = q.reshape(B, L, KVH, G, HD).float()
    q_pos = pos + torch.arange(L, device=q.device)[:, None]
    acc = torch.zeros(B, KVH, G, L, HD, device=q.device)
    m = torch.full((B, KVH, G, L, 1), float("-inf"), device=q.device)
    l = torch.zeros(B, KVH, G, L, 1, device=q.device)
    for j in range(T // kv_block):
        kj = k[:, j * kv_block : (j + 1) * kv_block].float()
        vj = v[:, j * kv_block : (j + 1) * kv_block]
        s = torch.einsum("blkgd,bckd->bkglc", qg, kj) / math.sqrt(HD)
        kv_idx = j * kv_block + torch.arange(kv_block, device=q.device)[None, :]
        s = s.masked_fill(~(kv_idx <= q_pos), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # exp(-inf - -inf) is nan; a fully-masked running max stays -inf, so
        # guard the rescale factor.
        dead = torch.isneginf(m_new)
        alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
        p = torch.where(dead, 0.0, torch.exp(s - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkglc,bckd->bkgld", p.to(vj.dtype).float(), vj.float())
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    # [B, KVH, G, L, HD] -> [B, L, NH, HD]
    return out.permute(0, 3, 1, 2, 4).reshape(B, L, NH, HD).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: int):
    """Write k, v [B, L, KVH, HD] into the caches [B, KVH, M, HD] at
    positions pos..pos+L-1, in place.  Returns (k_cache, v_cache)."""
    L = k.shape[1]
    k_cache[:, :, pos : pos + L] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[:, :, pos : pos + L] = v.transpose(1, 2).to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# int8 KV quantization (serving kv_quant="int8")
# ---------------------------------------------------------------------------

def quantize_kv_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization over the last (head_dim) axis:
    x [..., HD] -> (int8 [..., HD], f32 scales [...]), s = max|x| / 127
    (1 for an all-zero row), rounded half to even as jnp.round does."""
    xf = x.float()
    m = xf.abs().amax(dim=-1)
    s = torch.where(m > 0, m / 127.0, torch.ones_like(m))
    return torch.round(xf / s[..., None]).to(torch.int8), s


# ---------------------------------------------------------------------------
# Ragged (per-row position) decode: the serving path
# ---------------------------------------------------------------------------

def ragged_update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor):
    """Per-row single-token cache write: row b lands at its own pos[b].

    k, v: [B, 1, KVH, HD]; pos: [B]; caches [B, KVH, M, HD], updated in
    place and returned.  A position past the cache clamps to its last row,
    as the JAX package's `dynamic_update_slice` does."""
    B, M = k_cache.shape[0], k_cache.shape[2]
    rows = torch.arange(B, device=k_cache.device)
    p = pos.long().clamp(0, M - 1)
    k_cache[rows, :, p] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, :, p] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def ragged_update_scales(scales: torch.Tensor, s: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """The int8 companion of `ragged_update_kv_cache`: scales [B, KVH, M]
    <- s [B, KVH] at (b, :, pos[b]), in place (past M clamps to M-1)."""
    B, M = scales.shape[0], scales.shape[2]
    scales[torch.arange(B, device=scales.device), :, pos.long().clamp(0, M - 1)] = s
    return scales


def paged_update_kv_cache(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          page_ids: torch.Tensor, offsets: torch.Tensor):
    """Scatter one token's K/V per row into one layer's page pool
    [P, KVH, page, HD], in place: row b's token lands at (page_ids[b], :,
    offsets[b]).  k, v: [B, 1, KVH, HD]."""
    k_pages[page_ids.long(), :, offsets.long()] = k[:, 0].to(k_pages.dtype)
    v_pages[page_ids.long(), :, offsets.long()] = v[:, 0].to(v_pages.dtype)
    return k_pages, v_pages


def paged_update_scales(pool: torch.Tensor, s: torch.Tensor,
                        page_ids: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """The int8 companion of `paged_update_kv_cache`: scale pool [P, KVH,
    page] <- s [B, KVH] at (page_ids[b], :, offsets[b]), in place."""
    pool[page_ids.long(), :, offsets.long()] = s
    return pool


def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """One layer's pool [P, KVH, page, HD] gathered by the block table
    [B, maxp] into per-row dense rows [B, KVH, maxp*page, HD]."""
    B, maxp = block_table.shape
    kvh, page, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    g = pool[block_table.long()]  # [B, maxp, KVH, page, HD]
    return g.transpose(1, 2).reshape(B, kvh, maxp * page, hd)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor, k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention over one layer's page pool (gather form).

    q: [B, 1, NH, HD]; pools [P, KVH, page, HD]; block_table [B, maxp]
    (unused entries -> null page 0); pos [B]: row b attends kv_idx <=
    pos[b].  int8 pools pass their scale pools k_scale/v_scale [P, KVH,
    page].  Gathers each row's pages into a dense view and applies the
    ragged mask: the numerics oracle of the paged-attention kernel
    (`ops.kernels.paged_attention`), which follows the block table instead
    of materializing the gather.  Returns [B, 1, NH, HD]."""
    ks = vs = None
    if k_scale is not None:
        ks = gather_page_scales(k_scale, block_table)
        vs = gather_page_scales(v_scale, block_table)
    return ragged_cache_attention(q, _gather_pages(k_pages, block_table),
                                  _gather_pages(v_pages, block_table), pos,
                                  k_scale=ks, v_scale=vs)


def gather_page_scales(scale_pool: torch.Tensor,
                       block_table: torch.Tensor) -> torch.Tensor:
    """[P, KVH, page] scale pool -> per-row dense scales [B, KVH,
    maxp*page] following the block table (the plain path's gather; the
    kernel reads the scale pools through the table itself)."""
    B, maxp = block_table.shape
    kvh, page = scale_pool.shape[1], scale_pool.shape[2]
    g = scale_pool[block_table.long()]  # [B, maxp, KVH, page]
    return g.transpose(1, 2).reshape(B, kvh, maxp * page)


def gather_page_scales_stacked(scale_pools: torch.Tensor, li: int,
                               block_table: torch.Tensor) -> torch.Tensor:
    """Layer `li` of stacked scale pools [NL, P, KVH, page] -> [B, KVH,
    maxp*page]."""
    return gather_page_scales(scale_pools[li], block_table)


def gather_page_scales_all(scale_pools: torch.Tensor,
                           block_table: torch.Tensor) -> torch.Tensor:
    """Every layer of stacked scale pools [NL, P, KVH, page] -> dense rows
    [NL, B, KVH, maxp*page] in one gather: the plain quantum loop's hoist
    (the pools are frozen for a quantum)."""
    nl, _, kvh, page = scale_pools.shape
    B, maxp = block_table.shape
    g = scale_pools[:, block_table.long()]  # [NL, B, maxp, KVH, page]
    return g.transpose(2, 3).reshape(nl, B, kvh, maxp * page)


def ragged_cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           cur_k: Optional[torch.Tensor] = None,
                           cur_v: Optional[torch.Tensor] = None,
                           win_k: Optional[torch.Tensor] = None,
                           win_v: Optional[torch.Tensor] = None,
                           win_count: Optional[int] = None,
                           k_scale=None, v_scale=None, cur_ks=None,
                           cur_vs=None, win_ks=None,
                           win_vs=None) -> torch.Tensor:
    """Single-token attention with per-row visible lengths.

    q: [B, 1, NH, HD]; caches [B, KVH, M, HD]; pos: [B].  Returns
    [B, 1, NH, HD].

    int8 caches pass k_scale/v_scale [B, KVH, M] (and int8 appended rows
    cur_ks/cur_vs [B, KVH], int8 windows win_ks/win_vs [B, KVH, Q]): K
    scales post-multiply the score columns and V scales fold into the
    probabilities, so the appended rows match a read-back of the written
    slot exactly.

    Plain mode: row b attends kv_idx <= pos[b].

    Appended-current mode (cur_k/cur_v [B, KVH, HD], cache dtype): the
    cache is read-only and holds tokens 0..pos[b]-1 (the mask is strict,
    kv_idx < pos), and the current token's K/V are one explicit appended
    column, so a layer loop never writes the cache it reads and all layers'
    rows commit once after it.

    In-flight window mode (win_k/win_v [B, KVH, Q, HD], cache dtype, with
    host int win_count; needs appended-current mode): the quantum loop's
    deferred-commit form.  `pos` is the quantum's start position (the cache
    holds tokens < pos[b] for the whole quantum), window column s holds the
    K/V of the token decoded at quantum step s, and only columns s <
    win_count are visible.
    """
    B, L, NH, HD = q.shape
    if L != 1:
        raise ValueError("ragged attention is a decode (single-token) op")
    KVH, M = k_cache.shape[1], k_cache.shape[2]
    G = NH // KVH
    append = cur_k is not None
    if win_k is not None and not append:
        raise ValueError("window mode requires appended-current mode")
    qg = q.reshape(B, KVH, G, HD).float()
    sq = math.sqrt(HD)

    def score(keys, eq, s):  # q . keys, post-scaled by the int8 scales s
        out = torch.einsum(eq, qg, keys.float())
        return out if s is None else out * s

    scores = score(k_cache, "bkgd,bkmd->bkgm",
                   None if k_scale is None else k_scale[:, :, None, :]) / sq
    kv_idx = torch.arange(M, device=q.device)[None, None, None, :]
    lim = pos.to(q.device)[:, None, None, None]
    nwin = 0
    if append:
        scores = scores.masked_fill(~(kv_idx < lim), float("-inf"))
        parts = [scores]
        if win_k is not None:
            nwin = win_k.shape[2]
            s_win = score(win_k, "bkgd,bkqd->bkgq",
                          None if win_ks is None else win_ks[:, :, None, :]) / sq
            col = torch.arange(nwin, device=q.device)
            parts.append(s_win.masked_fill(~(col < win_count), float("-inf")))
        s_cur = score(cur_k, "bkgd,bkd->bkg",
                      None if cur_ks is None else cur_ks[:, :, None]) / sq
        parts.append(s_cur[..., None])
        scores = torch.cat(parts, dim=-1)
    else:
        scores = scores.masked_fill(~(kv_idx <= lim), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    p_win = probs[..., M : M + nwin] if nwin else None
    p_cur = probs[..., M + nwin :] if append else None  # [B, KVH, G, 1]
    probs = probs[..., :M]
    if v_scale is not None:
        # Rounded to q's dtype before P.V, as the window part below and the
        # JAX op (a no-op in fp32).
        probs = (probs * v_scale[:, :, None, :]).to(q.dtype).float()
    else:
        probs = probs.to(v_cache.dtype).float()
    out = torch.einsum("bkgm,bkmd->bkgd", probs, v_cache.float())
    if nwin:
        # Masked columns carry probs exactly 0 (softmax of -inf), so the
        # stale rows in unwritten window columns contribute nothing.
        if win_vs is not None:
            p_win = p_win * win_vs[:, :, None, :]
        out = out + torch.einsum("bkgq,bkqd->bkgd",
                                 p_win.to(q.dtype).float(), win_v.float())
    if append:
        if cur_vs is not None:
            p_cur = p_cur * cur_vs[:, :, None, None]
        out = out + p_cur * cur_v.float()[:, :, None, :]
    return out.reshape(B, 1, NH, HD).to(q.dtype)


def paged_attention_stacked(q: torch.Tensor, k_pools: torch.Tensor,
                            v_pools: torch.Tensor, li: int,
                            block_table: torch.Tensor, pos: torch.Tensor,
                            cur_k: Optional[torch.Tensor] = None,
                            cur_v: Optional[torch.Tensor] = None,
                            win_k: Optional[torch.Tensor] = None,
                            win_v: Optional[torch.Tensor] = None,
                            win_count: Optional[int] = None,
                            k_scale_pool=None, v_scale_pool=None,
                            cur_ks=None, cur_vs=None, win_ks=None,
                            win_vs=None, k_scale_rows=None,
                            v_scale_rows=None) -> torch.Tensor:
    """Paged decode attention reading layer `li` of the stacked pools
    [NL, P, KVH, page, HD]: gathers layer li's block-table pages and
    attends with the current token appended (and the in-flight window,
    when given), as `ragged_cache_attention` sets out.  int8 pools pass
    their scale pools [NL, P, KVH, page], or layer li's scale rows already
    gathered (`k_scale_rows`/`v_scale_rows` [B, KVH, maxp*page], the
    quantum loop's hoist)."""
    ks, vs = k_scale_rows, v_scale_rows
    if k_scale_pool is not None and ks is None:
        ks = gather_page_scales_stacked(k_scale_pool, li, block_table)
        vs = gather_page_scales_stacked(v_scale_pool, li, block_table)
    return ragged_cache_attention(
        q, _gather_pages(k_pools[li], block_table),
        _gather_pages(v_pools[li], block_table), pos, cur_k=cur_k,
        cur_v=cur_v, win_k=win_k, win_v=win_v, win_count=win_count,
        k_scale=ks, v_scale=vs, cur_ks=cur_ks, cur_vs=cur_vs,
        win_ks=win_ks, win_vs=win_vs)


# The commits below write every layer's new rows into the cache in one
# in-place advanced-index assignment.  Where two targets coincide (quantum
# overrun positions clamp into a row's last page; parked and idle rows all
# write the null page) the order in which they land is undefined, as in
# the JAX package's scatter; those slots are never attended before they are
# written again.  Indexing dims 1 and 3 of a 5-d cache puts the index dims
# first: `cache[:, i, :, j]` is [*i.shape, NL, KVH, HD].

def commit_decode_rows_paged(cache: Dict, k_rows: torch.Tensor,
                             v_rows: torch.Tensor, page_ids: torch.Tensor,
                             offsets: torch.Tensor, ks_rows=None,
                             vs_rows=None) -> Dict:
    """Commit every layer's new decode K/V rows [NL, B, KVH, HD] to the
    paged pool in place: row b lands at (layer, page_ids[b], :,
    offsets[b]).  int8 pools also commit the scale rows [NL, B, KVH].
    Returns the cache."""
    pid, off = page_ids.long(), offsets.long()
    cache["k"][:, pid, :, off] = k_rows.transpose(0, 1).to(cache["k"].dtype)
    cache["v"][:, pid, :, off] = v_rows.transpose(0, 1).to(cache["v"].dtype)
    if ks_rows is not None:
        cache["k_s"][:, pid, :, off] = ks_rows.transpose(0, 1)
        cache["v_s"][:, pid, :, off] = vs_rows.transpose(0, 1)
    return cache


def _window_slots(pos0: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Positions pos0[b] + s of a quantum's window columns, [B, Q]."""
    return (pos0.long()[:, None]
            + torch.arange(num_steps, device=pos0.device)[None, :])


def commit_window_paged(cache: Dict, win: Dict, pos0: torch.Tensor,
                        block_table: torch.Tensor, num_steps: int) -> Dict:
    """Commit a whole quantum's in-flight window to the paged pool in place:
    win["k"/"v"] [NL, B, KVH, Q, HD] (int8 windows also "k_s"/"v_s" [NL, B,
    KVH, Q]); column s of row b lands at the (page, offset) of position
    pos0[b] + s through the block table.  Positions past the table clamp
    into the row's last block-table entry."""
    page = cache["k"].shape[3]
    maxp = block_table.shape[1]
    steps = _window_slots(pos0, num_steps)
    pidx = torch.gather(block_table.long(), 1,
                        torch.clamp(steps // page, max=maxp - 1))
    offs = steps % page
    for name in ("k", "v"):  # [NL, B, KVH, Q, HD] -> [B, Q, NL, KVH, HD]
        cache[name][:, pidx, :, offs] = win[name].permute(1, 3, 0, 2, 4).to(
            cache[name].dtype)
    for name in ("k_s", "v_s") if "k_s" in win else ():
        cache[name][:, pidx, :, offs] = win[name].permute(1, 3, 0, 2)
    return cache


def commit_window_dense(cache: Dict, win: Dict, pos0: torch.Tensor,
                        num_steps: int) -> Dict:
    """Dense-cache counterpart of `commit_window_paged`: window column s of
    row b lands at (layer, b, :, pos0[b] + s) of the [NL, B, KVH, M, HD]
    cache; overrun positions past M are dropped, as the JAX scatter drops
    them.  (Selecting the in-range slots synchronises with the host.)"""
    B, M = cache["k"].shape[1], cache["k"].shape[3]
    steps = _window_slots(pos0, num_steps)
    rows = torch.arange(B, device=steps.device)[:, None].expand_as(steps)
    ok = steps < M
    for name in ("k", "v", "k_s", "v_s") if "k_s" in win else ("k", "v"):
        w = win[name]  # [NL, B, KVH, Q, *tail] -> [N, NL, KVH, *tail]
        vals = w.permute(1, 3, 0, 2, *range(4, w.dim()))[ok]
        cache[name][:, rows[ok], :, steps[ok]] = vals.to(cache[name].dtype)
    return cache


def commit_decode_rows_dense(cache: Dict, k_rows: torch.Tensor,
                             v_rows: torch.Tensor, pos: torch.Tensor,
                             ks_rows=None, vs_rows=None) -> Dict:
    """Dense-cache counterpart of `commit_decode_rows_paged`: rows
    [NL, B, KVH, HD] (and int8 scale rows [NL, B, KVH]) land at (layer, b,
    :, pos[b]) of the [NL, B, KVH, M, HD] cache in place; positions past M
    are dropped."""
    B, M = cache["k"].shape[1], cache["k"].shape[3]
    p = pos.long()
    ok = p < M
    rows = torch.arange(B, device=p.device)[ok]
    new = {"k": k_rows, "v": v_rows}
    if ks_rows is not None:
        new.update(k_s=ks_rows, v_s=vs_rows)
    for name, r in new.items():
        cache[name][:, rows, :, p[ok]] = r.transpose(0, 1)[ok].to(cache[name].dtype)
    return cache
