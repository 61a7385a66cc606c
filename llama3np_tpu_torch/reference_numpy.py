"""Pure-NumPy oracle for parity testing.

A copy of `llama3np_tpu.reference_numpy.NumpyLlama`, kept in the port so
that `chip_smoke.py` can hold the CUDA path against it without importing the
JAX package.  It is a vectorized NumPy forward/generate over the *stacked*
parameter tree (checkpoint.build_param_tree), faithful to the reference
implementation's math with the functional variant's contiguous KV positions
(quirk Q1 resolved) and GQA.

Results of the port's paths are held to this oracle at the reference's own
tolerance envelope (rtol 2e-4 / atol 1e-4) plus greedy token-stream
identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import ModelArgs


def softmax_np(x: np.ndarray) -> np.ndarray:
    m = np.max(x, axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=-1, keepdims=True)


def silu_np(x: np.ndarray) -> np.ndarray:
    return x * (1.0 / (1.0 + np.exp(-x)))


def rmsnorm_np(x: np.ndarray, w: np.ndarray, eps: float) -> np.ndarray:
    ms = (x * x).mean(-1, keepdims=True) + eps
    return x / np.sqrt(ms) * w


def rope_tables_np(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                   dtype=np.float32,
                   scaling: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [M, HD//2]; matches reference llama3.py:31-38 math.

    `scaling` applies the llama3.1 frequency remap (the host-side f64
    helper in ops.core)."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64)[: head_dim // 2] / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling is not None:
        from .ops.core import scale_rope_inv_freq  # lazy: keeps default path numpy-only

        inv_freq = scale_rope_inv_freq(inv_freq, scaling)
    angles = np.arange(max_seq_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    return np.cos(angles).astype(dtype), np.sin(angles).astype(dtype)


def apply_rope_np(x: np.ndarray, cos: np.ndarray, sin: np.ndarray) -> np.ndarray:
    """Rotate interleaved (even, odd) pairs of the last axis.

    x: [B, L, H, HD]; cos/sin: [L, HD//2] (broadcast over batch and heads).
    Pairing matches the reference's complex-as-real layout
    (llama3.py:48-76 / llama3_simple.py:50-55).
    """
    xr = x[..., 0::2]
    xi = x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out_r = xr * c - xi * s
    out_i = xr * s + xi * c
    return np.stack([out_r, out_i], axis=-1).reshape(x.shape)


class NumpyLlama:
    """Stateful convenience wrapper: params + per-layer dense KV caches."""

    def __init__(self, params: Dict, args: ModelArgs, dtype=np.float32):
        self.args = args
        self.dtype = np.dtype(dtype)
        self.params = {  # cast a copy; leave caller's tree untouched
            "tok_embedding": params["tok_embedding"].astype(self.dtype),
            "layers": {k: v.astype(self.dtype) for k, v in params["layers"].items()},
            "norm": params["norm"].astype(self.dtype),
            "lm_head": params["lm_head"].astype(self.dtype),
        }
        self.cos, self.sin = rope_tables_np(
            args.head_dim, args.max_seq_len, args.rope_theta, self.dtype,
            scaling=getattr(args, "rope_scaling", None),
        )
        self.reset_cache()

    def reset_cache(self):
        a = self.args
        shape = (a.n_layers, a.max_batch_size, a.max_seq_len, a.kv_heads, a.head_dim)
        self.cache_k = np.zeros(shape, self.dtype)
        self.cache_v = np.zeros(shape, self.dtype)

    # -- forward ------------------------------------------------------------

    def __call__(self, input_ids: np.ndarray, start_pos: int) -> np.ndarray:
        """Forward `input_ids` [B, L] at `start_pos`; returns last-position
        logits [B, 1, VS] (reference behavior, quirk Q8) and updates caches."""
        a = self.args
        p = self.params
        B, L = input_ids.shape
        h = p["tok_embedding"][input_ids]
        cos = self.cos[start_pos : start_pos + L]
        sin = self.sin[start_pos : start_pos + L]

        mask = None
        if L > 1:
            # Rectangular [L, start_pos+L] additive causal mask
            # (reference llama3.py:293-297, quirk Q7).
            tri = np.triu(np.full((L, L), -np.inf, self.dtype), k=1)
            mask = np.concatenate([np.zeros((L, start_pos), self.dtype), tri], axis=1)

        ly = p["layers"]
        for i in range(a.n_layers):
            h = self._block(
                h, i, start_pos, mask, cos, sin,
                ly["wq"][i], ly["wk"][i], ly["wv"][i], ly["wo"][i],
                ly["w_gate"][i], ly["w_up"][i], ly["w_down"][i],
                ly["attn_norm"][i], ly["ffn_norm"][i],
            )
        h = rmsnorm_np(h, p["norm"], a.norm_eps)
        return h[:, [-1], :] @ p["lm_head"]

    def _block(self, x, layer, start_pos, mask, cos, sin,
               wq, wk, wv, wo, w_gate, w_up, w_down, attn_norm, ffn_norm):
        a = self.args
        h = x + self._attention(
            rmsnorm_np(x, attn_norm, a.norm_eps),
            layer, start_pos, mask, cos, sin, wq, wk, wv, wo,
        )
        z = rmsnorm_np(h, ffn_norm, a.norm_eps)
        return h + silu_np(z @ w_gate) * (z @ w_up) @ w_down

    def _attention(self, x, layer, start_pos, mask, cos, sin, wq, wk, wv, wo):
        a = self.args
        B, L, _ = x.shape
        hd, nh, kvh = a.head_dim, a.n_heads, a.kv_heads

        q = (x @ wq).reshape(B, L, nh, hd)
        k = (x @ wk).reshape(B, L, kvh, hd)
        v = (x @ wv).reshape(B, L, kvh, hd)
        q = apply_rope_np(q, cos, sin)
        k = apply_rope_np(k, cos, sin)

        self.cache_k[layer, :B, start_pos : start_pos + L] = k
        self.cache_v[layer, :B, start_pos : start_pos + L] = v
        ks = self.cache_k[layer, :B, : start_pos + L]
        vs = self.cache_v[layer, :B, : start_pos + L]
        if a.n_rep > 1:  # GQA: expand KV heads to match Q heads
            ks = np.repeat(ks, a.n_rep, axis=2)
            vs = np.repeat(vs, a.n_rep, axis=2)

        q = q.transpose(0, 2, 1, 3)                     # [B, NH, L, HD]
        ks = ks.transpose(0, 2, 1, 3)                   # [B, NH, T, HD]
        vs = vs.transpose(0, 2, 1, 3)
        scores = q @ ks.transpose(0, 1, 3, 2) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask[None, None, :, :]
        out = softmax_np(scores) @ vs                   # [B, NH, L, HD]
        return out.transpose(0, 2, 1, 3).reshape(B, L, -1) @ wo

    # -- generation ---------------------------------------------------------

    def generate(self, input_ids: np.ndarray, max_new_tokens: int):
        """Greedy generator yielding [B, 1] int arrays; contiguous cache
        positions (llama3_simple semantics, quirk Q1 resolved), capped at
        max_seq_len (reference llama3_simple.py:284-285)."""
        B, L = input_ids.shape
        total = L
        nxt: Optional[np.ndarray] = None
        for i in range(max_new_tokens):
            if i == 0:
                logits = self(input_ids, 0)
            else:
                logits = self(nxt, L + i - 1)
            nxt = logits[:, -1, :].argmax(-1, keepdims=True).astype(np.int64)
            yield nxt
            total += 1
            if total >= self.args.max_seq_len:
                break

    def greedy_tokens(self, input_ids: np.ndarray, max_new_tokens: int,
                      stop_ids: Tuple[int, ...] = ()) -> List[int]:
        """Collect the greedy stream for batch row 0 (test convenience)."""
        out: List[int] = []
        for t in self.generate(input_ids, max_new_tokens):
            tid = int(t[0, -1])
            if tid in stop_ids:
                break
            out.append(tid)
        return out
