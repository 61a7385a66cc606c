"""Generation: one bucket-padded prefill, then a decode loop that keeps
each token on the device; greedy, or sampled under a `Sampling` policy.

Counterpart of `llama3np_tpu.generate`.  The JAX package ran the decode
loop as one `lax.scan`; here it is a Python loop whose position `pos` is a
host integer and whose token never leaves the device, so the loop has no
host sync per token: the tokens come back in one transfer at the end, as
the scan's did.  On the card, batch-1 decode runs the fused decode kernel,
then the greedy head (`kernel_decode_steps`) or the plain logits and the
sampler (`kernel_sampled_decode_steps`); elsewhere the plain forward
(`decode_steps`, `sampled_decode_steps`).

Sampled tokens are the JAX package's for the same seed: `decode_keys`
replays its key schedule (a split for the first token, then per decode
segment of `plan_decode_segments` a fold_in and a split a step) and
`sample_token` its masks and Gumbel draw (`prng`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from . import prng
from .models.llama import (StaticConfig, embed_tokens, forward,
                           forward_hidden, lm_logits, top_k_mask, top_p_mask)
from .observability import check_finite
from .ops import core as ops
from .ops.kernels.decode_step import decode_layers
from .ops.kernels.greedy_head import argmax_head


def _last_logits(params, h, true_len: int, cfg: StaticConfig):
    """Logits at the last real prompt position (true_len - 1)."""
    h_last = ops.rms_norm(h[:, true_len - 1 : true_len], params["norm"],
                          cfg.norm_eps)
    return lm_logits(params, h_last, cfg.mesh)


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


def _kernel_hidden(params, tok: torch.Tensor, p: int, kc, vc, cos, sin,
                   cfg: StaticConfig):
    """One batch-1 token through every layer in the fused decode kernel,
    then the final norm: h [1, D]; the caches kc/vc are written at row p."""
    x = embed_tokens(params, tok)  # [1, D]
    x, kc, vc = decode_layers(
        params["layers"], x, p, kc, vc, cos[p : p + 1], sin[p : p + 1],
        n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, norm_eps=cfg.norm_eps)
    return ops.rms_norm(x, params["norm"], cfg.norm_eps)


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
        h = _kernel_hidden(params, tok, pos + i, kc, vc, cos, sin, cfg)
        if "lm_head_scale" in params:
            tok = torch.argmax(lm_logits(params, h), dim=-1)  # [1]
        else:
            check_finite(h, "the greedy head's input")  # no logits to check
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


DECODE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def plan_decode_segments(rest: int, L: int, M: int,
                         buckets=DECODE_BUCKETS) -> list:
    """The JAX package's decode segments for `rest` steps after an L-token
    prompt in an M-row cache: a greedy binary decomposition over the
    buckets, the last segment rounded up to 16 steps and clamped so that
    the total stays within M - L - 1 (513 -> [512, 16]).  The port's loop
    runs no segments; the sampled key schedule folds in the segment index
    (`decode_keys`)."""
    cap = M - L - 1
    if rest > cap:
        raise ValueError(f"{rest} decode steps exceed the cache's {cap} "
                         f"(prompt {L}, max_seq_len {M})")
    segments = []
    consumed = 0
    for b in sorted(buckets, reverse=True):
        while rest - consumed >= b and consumed + b <= cap:
            segments.append(b)
            consumed += b
    if consumed < rest:
        segments.append(min(-(-(rest - consumed) // 16) * 16, cap - consumed))
    return segments


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sampling:
    """Token-sampling policy, as the JAX package's.  temperature == 0 is
    greedy."""
    temperature: float = 1.0
    top_k: int = 0        # 0 = disabled
    top_p: float = 1.0    # 1.0 = disabled
    seed: int = 0


def sample_scores(logits: torch.Tensor, key: torch.Tensor,
                  sampling: Sampling) -> torch.Tensor:
    """The perturbed logits whose argmax a sampled token is: logits /
    temperature (a division, as JAX rounds it), the top-k and top-p masks,
    plus the Gumbel noise of `key` (`prng.gumbel_scores`).  Their top-2
    margin is how near a draw is to a tie."""
    scaled = logits.float() / sampling.temperature
    if sampling.top_k:
        scaled = top_k_mask(scaled, sampling.top_k)
    if sampling.top_p < 1.0:
        scaled = top_p_mask(scaled, sampling.top_p)
    return prng.gumbel_scores(key, scaled)


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 sampling: Sampling) -> torch.Tensor:
    """One token per row of f32 logits [B, VS] under one key [2] (the JAX
    package's `sample_token`); temperature 0 is the argmax."""
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(sample_scores(logits, key, sampling), dim=-1)


def _sample(cfg: StaticConfig, logits: torch.Tensor, key: torch.Tensor,
            sampling: Sampling) -> torch.Tensor:
    """`sample_token` of the whole batch's rows: under a data-parallel
    cfg.mesh the logits of every dp rank's rows are gathered first (the
    Gumbel noise of a row depends on the batch it is drawn in), and this
    rank's tokens are kept."""
    m = cfg.mesh
    if m is None or m.size("dp") == 1:
        return sample_token(logits, key, sampling)
    return m.dp_rows(sample_token(m.dp_gather_rows(logits), key, sampling))


def _host_split(key):
    """`prng.split` of a key held as two Python ints (no device work)."""
    return [prng.threefry2x32(key[0], key[1], 0, i) for i in range(2)]


def decode_keys(sampling: Sampling, rest: int, L: int, M: int) -> torch.Tensor:
    """The JAX package's generation keys for one prefill token and `rest`
    decode steps: [1 + rest, 2] int64 on the CPU.  Key 0 samples the
    first token: split(PRNGKey(seed)) -> (rng, key 0).  Decode segment i
    (`plan_decode_segments`) starts from fold_in(rng, i) and splits once a
    step, each step sampling with the second half.  Computed on the host
    in Python integers (a few microseconds a key); the caller moves the
    whole array to its device once."""
    rng, first = _host_split((0, int(sampling.seed) & prng.MASK32))
    keys, left = [first], rest
    for i, S in enumerate(plan_decode_segments(rest, L, M)):
        k = prng.threefry2x32(rng[0], rng[1], 0, i)  # fold_in(rng, i)
        for _ in range(min(S, left)):
            k, sub = _host_split(k)
            keys.append(sub)
        left -= min(S, left)
    return torch.tensor(keys, dtype=torch.int64)


def sampled_decode_steps(params, tok: torch.Tensor, pos: int, cache, cos,
                         sin, keys: torch.Tensor, cfg: StaticConfig,
                         num_steps: int, sampling: Sampling):
    """`decode_steps` with step i's token drawn by `sample_token` under
    keys[i] (keys [num_steps, 2] on the cache's device)."""
    toks = []
    for i in range(num_steps):
        logits, cache = forward(params, tok[:, None], pos + i, cache, cos,
                                sin, cfg, first_chunk=False)
        tok = _sample(cfg, logits[:, -1, :], keys[i], sampling)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def kernel_sampled_decode_steps(params, tok: torch.Tensor, pos: int, cache,
                                cos, sin, keys: torch.Tensor,
                                cfg: StaticConfig, num_steps: int,
                                sampling: Sampling):
    """`sampled_decode_steps` through the fused decode kernel: each token's
    layers in `decode_layers`, then the final norm, the plain `lm_logits`
    (post-scaled for an int8 head) and `sample_token`.  The greedy head
    gives no logits, so it stays on the greedy path.  Batch 1 only, as
    `kernel_decode_steps`; the caches are updated in place."""
    kc = cache["k"][:, 0]
    vc = cache["v"][:, 0]
    toks = []
    for i in range(num_steps):
        h = _kernel_hidden(params, tok, pos + i, kc, vc, cos, sin, cfg)
        tok = sample_token(lm_logits(params, h), keys[i], sampling)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


class Generator:
    """Prefill padding/bucketing and the choice of decode loop."""

    def __init__(self, engine):
        self.engine = engine
        self.args = engine.args
        self.cfg = engine.cfg

    def use_kernels(self, batch: int) -> bool:
        """The fused decode kernel runs batch-1 decode on the card, greedy
        or sampled, float32, bf16, float16 or int8 weights alike (attn_impl
        "auto"/"pallas"; the engine refuses "pallas" elsewhere), over a
        cache of any float dtype or int8.  It reads the fused tree only: a
        split tree (int4 among them) decodes on the plain path, as in the
        JAX package."""
        return (self.cfg.kernels and self.cfg.fused and self.cfg.rope_split
                and batch == 1)

    def decode_fn(self, num_steps: int, batch: int = 1):
        """(params, tok, pos, cache, cos, sin) -> (tokens [B, num_steps], cache)."""
        loop = kernel_decode_steps if self.use_kernels(batch) else decode_steps

        def run(params, tok, pos, cache, cos, sin):
            return loop(params, tok, pos, cache, cos, sin, self.cfg, num_steps)
        return run

    def sampled_decode_fn(self, num_steps: int, sampling: Sampling,
                          batch: int = 1):
        """(params, tok, pos, cache, cos, sin, keys) -> (tokens, cache)."""
        loop = (kernel_sampled_decode_steps if self.use_kernels(batch)
                else sampled_decode_steps)

        def run(params, tok, pos, cache, cos, sin, keys):
            return loop(params, tok, pos, cache, cos, sin, keys, self.cfg,
                        num_steps, sampling)
        return run

    def generate(self, params, input_ids: np.ndarray, cache: Dict,
                 num_tokens: int, sampling: "Sampling | None" = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """Decode `num_tokens` tokens after the prompt: greedy by default,
        drawn under a `Sampling` policy with a temperature above 0 (the
        JAX package's tokens for the same seed).

        input_ids: host int array [B, L].  Returns ([B, num_tokens] on the
        engine's device, cache).  Requires L + num_tokens <= max_seq_len.
        """
        eng = self.engine
        B, L = input_ids.shape
        M = self.args.max_seq_len
        if L + num_tokens > M:
            raise ValueError(
                f"prompt ({L}) + num_tokens ({num_tokens}) exceeds max_seq_len ({M})")
        if num_tokens == 0:
            return torch.zeros((B, 0), dtype=torch.long, device=eng.device), cache
        padded, L = pad_prompt(input_ids, self.args)
        ids = torch.as_tensor(padded, device=eng.device)
        stochastic = sampling is not None and sampling.temperature > 0.0
        if stochastic:
            keys = decode_keys(sampling, num_tokens - 1, L, M).to(eng.device)
            logits0, cache = prefill_logits(params, ids, L, cache, eng.cos,
                                            eng.sin, self.cfg)
            tok0 = _sample(self.cfg, logits0, keys[0], sampling)
        else:
            tok0, cache = prefill_step(params, ids, L, cache, eng.cos, eng.sin,
                                       self.cfg)
        if num_tokens == 1:
            return tok0[:, None], cache
        if stochastic:
            toks, cache = self.sampled_decode_fn(num_tokens - 1, sampling, B)(
                params, tok0, L, cache, eng.cos, eng.sin, keys[1:])
        else:
            toks, cache = self.decode_fn(num_tokens - 1, B)(
                params, tok0, L, cache, eng.cos, eng.sin)
        return torch.cat([tok0[:, None], toks], dim=1), cache
