"""Greedy generation: one bucket-padded prefill, then a decode loop that
keeps each token on the device.

Counterpart of `llama3np_tpu.generate`.  The JAX package ran the decode
loop as one `lax.scan`; here it is a Python loop whose position `pos` is a
host integer and whose token never leaves the device, so the loop has no
host sync per token: the tokens come back in one transfer at the end, as
the scan's did.  On the card, batch-1 greedy decode runs the fused decode
kernel and the greedy head (`kernel_decode_steps`); elsewhere the plain
forward (`decode_steps`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .models.llama import (StaticConfig, embed_tokens, forward,
                           forward_hidden, lm_logits)
from .ops import core as ops
from .ops.kernels.decode_step import decode_layers
from .ops.kernels.greedy_head import argmax_head


def _last_logits(params, h, true_len: int, cfg: StaticConfig):
    """Logits at the last real prompt position (true_len - 1)."""
    h_last = ops.rms_norm(h[:, true_len - 1 : true_len], params["norm"],
                          cfg.norm_eps)
    return lm_logits(params, h_last)


def prefill_logits(params, ids_padded: torch.Tensor, true_len: int, cache,
                   cos, sin, cfg: StaticConfig):
    """Prefill a (padded) prompt at position 0; returns (next-token logits
    [B, VS], cache).  The padded tail's K/V land in cache rows >= true_len
    and are never attended: decode masks them off and overwrites them one
    per step."""
    h, cache = forward_hidden(params, ids_padded, 0, cache, cos, sin, cfg,
                              first_chunk=True)
    return _last_logits(params, h, true_len, cfg)[:, -1, :], cache


def prefill_step(params, ids_padded: torch.Tensor, true_len: int, cache,
                 cos, sin, cfg: StaticConfig):
    """`prefill_logits` reduced to the first greedy token ([B], cache)."""
    logits, cache = prefill_logits(params, ids_padded, true_len, cache,
                                   cos, sin, cfg)
    return torch.argmax(logits, dim=-1), cache


def decode_steps(params, tok: torch.Tensor, pos: int, cache, cos, sin,
                 cfg: StaticConfig, num_steps: int):
    """Greedy-decode `num_steps` tokens starting from `tok` [B] at `pos`.

    Returns (tokens [B, num_steps], cache).  tokens[:, 0] is the argmax
    successor of `tok`; `tok`'s own K/V is written at row `pos`."""
    toks = []
    for i in range(num_steps):
        logits, cache = forward(params, tok[:, None], pos + i, cache, cos,
                                sin, cfg, first_chunk=False)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def kernel_decode_steps(params, tok: torch.Tensor, pos: int, cache, cos, sin,
                        cfg: StaticConfig, num_steps: int):
    """`decode_steps` with every layer of a token in the fused decode kernel
    (`ops.kernels.decode_step.decode_layers`); the counterpart of the JAX
    package's `pallas_decode_steps`.  Batch 1 only; params in the fused,
    rope-split layout, float32, bf16, float16 or int8 (the layer tree's
    `*_scale` leaves select the kernel's int8 mode).  A float32, bf16 or
    float16 lm_head gives the token through the greedy head (`ops.kernels.greedy_head.
    argmax_head`: the same argmax of the f32 product, no logits tensor); an
    int8 head keeps the post-scaled `lm_logits` and argmax, since the TPU
    kernel has no int8 mode.  The caches are updated in place."""
    kc = cache["k"][:, 0]  # [NL, KVH, M, HD] views of the B == 1 cache
    vc = cache["v"][:, 0]
    toks = []
    for i in range(num_steps):
        p = pos + i
        x = embed_tokens(params, tok)  # [1, D]
        x, kc, vc = decode_layers(
            params["layers"], x, p, kc, vc, cos[p : p + 1], sin[p : p + 1],
            n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, norm_eps=cfg.norm_eps)
        h = ops.rms_norm(x, params["norm"], cfg.norm_eps)
        if "lm_head_scale" in params:
            tok = torch.argmax(lm_logits(params, h), dim=-1)  # [1]
        else:
            tok = argmax_head(h, params["lm_head"])  # [1]
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def pad_prompt(input_ids: np.ndarray, args) -> Tuple[np.ndarray, int]:
    """Pad a host prompt [B, L] to its prefill bucket: the smallest
    configured bucket >= L, never below L, never above max_seq_len.
    Returns (padded [B, P] int64, true length L)."""
    ids = np.asarray(input_ids)
    B, L = ids.shape
    buckets = [b for b in args.prefill_buckets if b <= args.max_seq_len] \
        or [args.max_seq_len]
    P = max(_bucket(L, buckets), L)
    padded = np.zeros((B, P), np.int64)
    padded[:, :L] = ids
    return padded, L


class Generator:
    """Prefill padding/bucketing and the choice of decode loop."""

    def __init__(self, engine):
        self.engine = engine
        self.args = engine.args
        self.cfg = engine.cfg

    def use_kernels(self, batch: int) -> bool:
        """The fused decode kernel runs batch-1 greedy decode on the card,
        float32, bf16, float16 or int8 weights alike (attn_impl
        "auto"/"pallas"; the engine refuses "pallas" elsewhere, and refuses
        on the card what no kernel takes)."""
        return self.cfg.kernels and self.cfg.rope_split and batch == 1

    def decode_fn(self, num_steps: int, batch: int = 1):
        """(params, tok, pos, cache, cos, sin) -> (tokens [B, num_steps], cache)."""
        loop = kernel_decode_steps if self.use_kernels(batch) else decode_steps

        def run(params, tok, pos, cache, cos, sin):
            return loop(params, tok, pos, cache, cos, sin, self.cfg, num_steps)
        return run

    def generate(self, params, input_ids: np.ndarray, cache: Dict,
                 num_tokens: int, sampling=None
                 ) -> Tuple[torch.Tensor, Dict]:
        """Decode `num_tokens` greedy tokens after the prompt.  `sampling`,
        a policy with a `temperature` (as the JAX package's `Sampling`),
        must be greedy: sampled decoding is still to port.

        input_ids: host int array [B, L].  Returns ([B, num_tokens] on the
        engine's device, cache).  Requires L + num_tokens <= max_seq_len.
        """
        if sampling is not None and sampling.temperature > 0.0:
            raise NotImplementedError("sampling is still to port; the port "
                                      "decodes greedily (see ROADMAP.md)")
        eng = self.engine
        B, L = input_ids.shape
        M = self.args.max_seq_len
        if L + num_tokens > M:
            raise ValueError(
                f"prompt ({L}) + num_tokens ({num_tokens}) exceeds max_seq_len ({M})")
        if num_tokens == 0:
            return torch.zeros((B, 0), dtype=torch.long, device=eng.device), cache
        padded, L = pad_prompt(input_ids, self.args)
        tok0, cache = prefill_step(params, torch.as_tensor(padded, device=eng.device),
                                   L, cache, eng.cos, eng.sin, self.cfg)
        if num_tokens == 1:
            return tok0[:, None], cache
        toks, cache = self.decode_fn(num_tokens - 1, B)(
            params, tok0, L, cache, eng.cos, eng.sin)
        return torch.cat([tok0[:, None], toks], dim=1), cache
