"""Fused batch-1 decode step: all transformer layers of one token, as a
hand-written CUDA kernel sequence (`csrc/decode_step.cu`) beside its plain
PyTorch version.

Counterpart of `llama3np_tpu.ops.kernels.decode_step.decode_layers` with
the same signature and return.  Per layer: RMSNorm -> fused QKV ->
split-halves RoPE -> attention over the cache masked to `kv_idx < pos`, with
the current token's (k_rot, v_new) appended as an explicit column -> o-proj
+ residual -> RMSNorm -> SwiGLU + residual.  Row `pos` of the cache is never
read, which is what keeps padded prefill tails and stale slots out of the
softmax; because of that mask the new rows are written into the caches at
`pos` in place (the JAX kernel emitted them and scattered afterwards), and
the caches passed in are the ones returned.

Six modes, chosen by the tree and x: float32 weights; int8 weights with
per-output-column f32 scales ("wqkv_scale" [NL, 1, QD+2KVD] and so on,
`checkpoint.quantize_param_tree`) under float32 activations, the
counterpart of the TPU's streamed layout with its scale blocks
(`_streamed_decode_layers`), where products are (x . w8) * s with x in f32
and the scale applied to the finished sum; bf16 weights, norms, x and
caches (the llama3-8b preset), with the streamed layout's rounding points:
the activation is rounded to bf16 before each weight product (`_wdot`),
sums, RMSNorm, RoPE and attention are f32 (bf16 cache rows widened), the
new K/V rows are stored in bf16, and the residual is rounded to bf16 once,
at the end of each layer; and int8 weights with f32 scales under bf16
norms, x and caches (the JAX engine's llama3-8b `quant="int8"`), with the
bf16 mode's rounding points and `_wdot`'s int8 products: the bf16-rounded
activation times the int8 weight, f32 sums, the scale post-multiplied.
The float16 counterparts of the last two (the JAX engine's
`dtype="float16"`, with and without `quant="int8"`) keep the same rounding
points in float16, except that `_wdot` rounds the activation to bf16 before
any int8 weight, so int8 under float16 activations is the int8/bf16
product with float16 norms, caches, residual and output.

`decode_layers` launches the kernels for CUDA tensors and runs
`decode_layers_plain` for CPU tensors; there is no fallback from one to the
other.  `decode_layers.launches` counts launches (one per call: one call
runs every layer of one token).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import _scaled_dot
from . import _build

_WEIGHTS = ("wqkv", "wo", "wgu", "w_down")
# The C entry of each (weight dtype, activation dtype) mode.
_ENTRIES = {
    torch.float32: {torch.float32: "l3t_decode_layers_f32"},
    torch.bfloat16: {torch.bfloat16: "l3t_decode_layers_bf16"},
    torch.float16: {torch.float16: "l3t_decode_layers_f16"},
    torch.int8: {torch.float32: "l3t_decode_layers_i8",
                 torch.bfloat16: "l3t_decode_layers_i8_bf16",
                 torch.float16: "l3t_decode_layers_i8_f16"},
}


def _rms_scale(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of an f32 row, the scale multiplied in before the weight."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


_HALF = (torch.bfloat16, torch.float16)


def _weight_input(a: torch.Tensor, w: torch.Tensor, act_dtype) -> torch.Tensor:
    """The activation a weight product sees (the TPU kernel's `_wdot`
    casts): rounded to the weight's dtype before a bf16 or float16 weight,
    to bf16 before an int8 weight under 16-bit activations; f32
    otherwise."""
    if w.dtype in _HALF:
        return a.to(w.dtype).float()
    if w.dtype == torch.int8 and act_dtype in _HALF:
        return a.to(torch.bfloat16).float()
    return a


def decode_layers_plain(layers: Dict, x: torch.Tensor, pos: int,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        cos_row: torch.Tensor, sin_row: torch.Tensor,
                        *, n_heads: int, kv_heads: int, head_dim: int,
                        norm_eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, with the appended-column math of
    the TPU kernel's `_attend_head` written out (int8 weights post-scale
    each product; 16-bit activations round where the kernel does: each
    product's activation, the stored rows, the residual at each layer's
    end).
    Updates the caches at `pos` in place and returns (x_out, k_cache,
    v_cache)."""
    nh, kvh, hd = n_heads, kv_heads, head_dim
    g, half = nh // kvh, hd // 2
    qd, kvd = nh * hd, kvh * hd
    inv_sqrt_hd = 1.0 / math.sqrt(hd)
    cos, sin = cos_row.float(), sin_row.float()  # [1, HD/2]

    def rope(t):  # split-halves RoPE on [..., HD]
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)

    def proj(a, name, layer):  # a @ w of `layer`, int8 post-scaled
        s, w = layers.get(name + "_scale"), layers[name][layer]
        return _scaled_dot(_weight_input(a, w, x.dtype), w, None if s is None else s[layer])

    m = k_cache.shape[2]
    visible = torch.arange(m, device=x.device) < pos  # never row pos
    h = x.float()
    for layer in range(layers["wqkv"].shape[0]):
        xn = _rms_scale(h, layers["attn_norm"][layer].reshape(-1), norm_eps)
        qkv = proj(xn, "wqkv", layer)                         # [1, QD+2KVD]
        q = rope(qkv[0, :qd].reshape(kvh, g, hd))             # [KVH, G, HD]
        k_rot = rope(qkv[0, qd : qd + kvd].reshape(kvh, 1, hd))
        v_new = qkv[0, qd + kvd :].reshape(kvh, 1, hd)
        ks = k_cache[layer].float()                           # [KVH, M, HD]
        vs = v_cache[layer].float()
        scores = torch.einsum("kgd,kmd->kgm", q, ks) * inv_sqrt_hd
        scores = scores.masked_fill(~visible, float("-inf"))
        s_new = torch.sum(q * k_rot, dim=-1, keepdim=True) * inv_sqrt_hd
        smax = torch.maximum(scores.amax(dim=-1, keepdim=True), s_new)
        sexp = torch.exp(scores - smax)
        e_new = torch.exp(s_new - smax)
        denom = sexp.sum(dim=-1, keepdim=True) + e_new
        attn = (torch.einsum("kgm,kmd->kgd", sexp, vs) + e_new * v_new) / denom
        k_cache[layer, :, pos] = k_rot[:, 0].to(k_cache.dtype)
        v_cache[layer, :, pos] = v_new[:, 0].to(v_cache.dtype)
        h = h + proj(attn.reshape(1, qd), "wo", layer)
        zn = _rms_scale(h, layers["ffn_norm"][layer].reshape(-1), norm_eps)
        gu = proj(zn, "wgu", layer)  # the gate/up scale applies before SiLU
        fd = layers["w_down"].shape[1]
        gate = gu[:, :fd]
        ff = gate * (1.0 / (1.0 + torch.exp(-gate))) * gu[:, fd:]
        h = (h + proj(ff, "w_down", layer)).to(x.dtype).float()  # 16-bit: the layer's end
    return h.to(x.dtype), k_cache, v_cache


def _check_args(layers, x, pos, k_cache, v_cache, cos_row, sin_row,
                n_heads, kv_heads, head_dim):
    nl, d, qkvd = layers["wqkv"].shape
    fd = layers["w_down"].shape[1]
    qd = n_heads * head_dim
    want = {
        "wqkv": (nl, d, qd + 2 * kv_heads * head_dim),
        "wo": (nl, qd, d),
        "wgu": (nl, d, 2 * fd),
        "w_down": (nl, fd, d),
    }
    for name, shape in want.items():
        if tuple(layers[name].shape) != shape:
            raise ValueError(f"decode_layers: {name} is {tuple(layers[name].shape)}, "
                             f"expected {shape} (fused whole-layer layout)")
    for name in ("attn_norm", "ffn_norm"):
        if layers[name].numel() != nl * d:
            raise ValueError(f"decode_layers: {name} must hold [NL, D] values")
    if "wqkv_scale" in layers:
        for name, shape in want.items():
            s = layers.get(name + "_scale")
            if s is None or tuple(s.shape) != (nl, 1, shape[2]):
                raise ValueError(f"decode_layers: int8 weights need {name}_scale "
                                 f"[{nl}, 1, {shape[2]}]")
    if tuple(x.shape) != (1, d):
        raise ValueError(f"decode_layers: x must be [1, {d}], got {tuple(x.shape)}")
    if k_cache.dim() != 4 or tuple(k_cache.shape[:2]) != (nl, kv_heads) \
            or k_cache.shape[3] != head_dim or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_layers: caches must be [NL, KVH, M, HD] = "
                         f"[{nl}, {kv_heads}, M, {head_dim}], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if tuple(cos_row.shape) != (1, head_dim // 2) or sin_row.shape != cos_row.shape:
        raise ValueError("decode_layers: cos_row/sin_row must be [1, HD/2]")
    if not 0 <= pos < k_cache.shape[2]:
        raise ValueError(f"decode_layers: pos {pos} outside the cache "
                         f"[0, {k_cache.shape[2]})")


_COUNTERS: Dict = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The kernel's arrival counters for calls on `stream`: zeroed once,
    and left zero by every call (each finishing block resets its own), so
    no call pays for clearing them; a larger width gets a new zeroed
    buffer."""
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < n:
        c = _COUNTERS[(device, stream)] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


def decode_layers(layers: Dict, x: torch.Tensor, pos: int,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  cos_row: torch.Tensor, sin_row: torch.Tensor,
                  *, n_heads: int, kv_heads: int, head_dim: int,
                  norm_eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run all layers of one batch-1 decode step.

    layers: fused whole-layer tree in rope-split layout ("wqkv"
    [NL,D,QD+2KVD], "wo" [NL,QD,D], "wgu" [NL,D,2FD], "w_down" [NL,FD,D],
    "attn_norm"/"ffn_norm" [NL,1,D]); for int8 weights also "wqkv_scale"
    [NL,1,QD+2KVD], "wo_scale", "wgu_scale", "w_down_scale".  x: [1, D]
    embedded token.  pos: host int, the token's position.
    k_cache/v_cache: [NL, KVH, M, HD] (one batch row), read at rows < pos
    and written at row pos in place.  On the card: float32 weights, norms,
    x and caches; int8 weights with f32 scales and float32 the rest; bf16
    (or float16) weights, norms, x and caches; or int8 weights with f32
    scales and bf16 (or float16) norms, x and caches; cos/sin rows
    float32.
    cos_row/sin_row: [1, HD//2] RoPE rows for `pos`.

    Returns (x_out [1, D], k_cache, v_cache).
    """
    pos = int(pos)
    _check_args(layers, x, pos, k_cache, v_cache, cos_row, sin_row,
                n_heads, kv_heads, head_dim)
    kw = dict(n_heads=n_heads, kv_heads=kv_heads, head_dim=head_dim,
              norm_eps=norm_eps)
    if x.device.type == "cpu":
        return decode_layers_plain(layers, x, pos, k_cache, v_cache,
                                   cos_row, sin_row, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"decode_layers runs on CUDA or CPU tensors, not {x.device}")
    quant = "wqkv_scale" in layers
    weights = [layers[n] for n in _WEIGHTS]
    scales = [layers[n + "_scale"] for n in _WEIGHTS] if quant else []
    acts = [layers["attn_norm"], layers["ffn_norm"], x, k_cache, v_cache]
    f32 = [cos_row, sin_row] + scales
    tensors = weights + acts + f32
    w_dtype, a_dtype = weights[0].dtype, x.dtype
    if a_dtype not in _ENTRIES.get(w_dtype, {}) or (w_dtype == torch.int8) != quant \
            or any(t.dtype != w_dtype for t in weights) \
            or any(t.dtype != a_dtype for t in acts) \
            or any(t.dtype != torch.float32 for t in f32):
        raise NotImplementedError(
            "the decode_layers kernel takes float32, bf16 or float16 weights "
            "with norms, x and caches of the same dtype, or int8 weights with "
            "f32 scales under float32, bf16 or float16 norms, x and caches "
            f"(cos/sin rows float32); got {w_dtype} weights and {x.dtype} x, "
            f"{k_cache.dtype} caches")
    if any(t.device != x.device for t in tensors):
        raise ValueError("decode_layers: every tensor must lie on x's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_layers takes contiguous tensors")
    nl, d, qkvd = layers["wqkv"].shape
    fd = layers["w_down"].shape[1]
    if head_dim % 4 or head_dim > 128 or d % 4 or fd % 2:
        raise ValueError(f"decode_layers kernel takes head_dim % 4 == 0 and <= 128, "
                         f"dim % 4 == 0, even hidden_dim; got {head_dim}, {d}, {fd}")
    vec = 16 // w_dtype.itemsize
    if vec > 4 and (qkvd % vec or d % vec or (2 * fd) % vec):
        # One lane reads 16 int8 or 8 16-bit weights as a 16-byte vector:
        # each output width must be a multiple of that for whole, aligned
        # vectors.
        raise ValueError(f"the {w_dtype} decode_layers kernel takes output "
                         f"widths that are multiples of {vec}; got {qkvd}, "
                         f"{d}, {2 * fd}")
    lib = _build.KernelLibrary.get()
    widths = (d, n_heads, kv_heads, head_dim, fd)
    scratch = torch.empty(lib.l3t_decode_scratch_floats(*widths),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _counters(x.device, stream, lib.l3t_decode_counters(*widths))
    x_out = torch.empty_like(x)
    rest = (layers["attn_norm"].data_ptr(), layers["ffn_norm"].data_ptr(),
            x.data_ptr(), x_out.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(), nl, d, n_heads, kv_heads,
            head_dim, fd, k_cache.shape[2], pos, float(norm_eps), x.device.index,
            stream)
    entry = getattr(lib, _ENTRIES[w_dtype][a_dtype])
    rc = entry(*(t.data_ptr() for t in weights + scales), *rest)
    _build.check(rc, "decode_layers")
    decode_layers.launches += 1
    return x_out, k_cache, v_cache


decode_layers.launches = 0
