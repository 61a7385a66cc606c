"""Speculative decoding: a cheap draft model proposes k tokens, the target
verifies all of them in one forward, and every accepted token costs the
target a fraction of a decode step's weight traffic.

Counterpart of `llama3np_tpu.speculative`, greedy and batch 1.  Every
emitted token is the target's own argmax, so the stream is the target-only
greedy stream whatever the draft proposes.  The verify pass computes its
logits with (k+1)-row products where the target's own decode path runs
one-row products (on the card, the decode kernel's GEMVs), so in 16-bit
models the two can resolve a near-tie argmax differently; on the CPU in
float32 the streams are equal.

One generation:

  * prefill both caches over the prompt's padded bucket (the target
    through `forward`, the draft through `forward_hidden`, both
    `first_chunk=True`, so flash prefill runs on the card), then replay the
    target's last real prompt token at L-1 for its exact logits;
  * each round, k+1 draft steps from the current token `cur` at `pos`
    propose d_0..d_{k-1} (the extra step writes d_{k-1}'s own K/V so the
    draft cache has no hole on full acceptance).  The draft's steps are
    its engine's greedy decode loop (`Generator.decode_fn`): on the card
    the fused decode kernel then the draft's head, elsewhere the plain
    forward at L=1 (the JAX package's draft step);
  * the target runs one `forward_hidden` over [cur, d_0..d_{k-1}] at `pos`
    (first_chunk=False: query offset i attends kv_idx <= pos + i), then
    the final norm and `lm_logits` at all k+1 offsets and an argmax, g;
  * a = the length of the matching prefix of d and g; the round emits
    d_0..d_{a-1} and the bonus token g_a, and `pos` advances by a+1.
    There is no rollback: rejected slots of both caches hold stale K/V
    that no query reaches before it is written again (write before
    attend).

The JAX package runs the rounds in one `lax.while_loop`; here it is a
Python loop whose one host read a round (the proposals and g, from which
the host finds a) is counted in `last_stats["host_reads"]`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .generate import Generator, pad_prompt
from .models.llama import Llama, forward, forward_hidden, lm_logits
from .ops import core as ops


def quantized_draft(weights: Dict, args, device="cuda") -> Llama:
    """int8 self-draft: the target's own weights, weight-only quantized."""
    return Llama(weights, dataclasses.replace(args, quant="int8"), device=device)


class SpeculativeGenerator:
    """Greedy speculative decode of `target` guided by `draft`.

    target, draft: Llama engines over the same vocabulary, on one device.
    k: draft tokens proposed per verify pass.

    After each generate_tokens call, `last_stats` holds {"tokens":
    emitted, "rounds": verify rounds, "accept_rate": mean accepted per
    round / k, "host_reads": device-to-host reads}.
    """

    def __init__(self, target: Llama, draft: Llama, k: int = 4):
        if target.args.vocab_size != draft.args.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        if k < 1:
            raise ValueError("k must be >= 1")
        if target.device != draft.device:
            raise ValueError(f"target and draft must be on one device, not "
                             f"{target.device} and {draft.device}")
        self.target = target
        self.draft = draft
        self.k = k
        self.last_stats = None
        self._draft_steps = Generator(draft).decode_fn(k + 1, 1)

    def prefill(self, padded: torch.Tensor, L: int):
        """Both caches over the padded prompt, then the target's replay of
        token L-1.  Returns (cur [1], target cache, draft cache)."""
        t, d = self.target, self.draft
        _, t_cache = forward(t.params, padded, 0, t.init_cache(1), t.cos,
                             t.sin, t.cfg, first_chunk=True)
        _, d_cache = forward_hidden(d.params, padded, 0, d.init_cache(1),
                                    d.cos, d.sin, d.cfg, first_chunk=True)
        lg, t_cache = forward(t.params, padded[:, L - 1 : L], L - 1, t_cache,
                              t.cos, t.sin, t.cfg, first_chunk=False)
        return torch.argmax(lg[:, -1, :], dim=-1), t_cache, d_cache

    def propose(self, cur: torch.Tensor, pos: int, d_cache: Dict) -> torch.Tensor:
        """The draft's k+1 steps from `cur` [1] at `pos`: proposals [k] on
        the device (the draft cache is written in place)."""
        props, _ = self._draft_steps(self.draft.params, cur, pos, d_cache,
                                     self.draft.cos, self.draft.sin)
        return props[0, : self.k]

    def verify(self, cur: torch.Tensor, props: torch.Tensor, pos: int,
               t_cache: Dict) -> torch.Tensor:
        """The target over [cur, props] at `pos` in one forward: its argmax
        g [k+1] at every offset, on the device (the target cache is
        written in place)."""
        t = self.target
        window = torch.cat([cur, props])[None, :]  # [1, k+1]
        h, _ = forward_hidden(t.params, window, pos, t_cache, t.cos, t.sin,
                              t.cfg, first_chunk=False)
        h = ops.rms_norm(h, t.params["norm"], t.cfg.norm_eps)
        return torch.argmax(lm_logits(t.params, h, t.cfg.mesh)[0], dim=-1)

    def generate_tokens(self, input_ids, num_tokens: int) -> np.ndarray:
        """Greedy tokens [1, num_tokens] (a host int32 array), the
        target-only greedy stream."""
        ids = np.asarray(input_ids)
        if ids.ndim != 2 or ids.shape[0] != 1:
            raise ValueError("speculative decode is single-stream (B=1)")
        t, d, k = self.target, self.draft, self.k
        padded, L = pad_prompt(ids, t.args)
        if L + num_tokens + k + 1 > t.args.max_seq_len or \
                L + num_tokens + k + 1 > d.args.max_seq_len:
            raise ValueError("prompt + num_tokens + k exceeds max_seq_len")
        cur, t_cache, d_cache = self.prefill(
            torch.as_tensor(padded, device=t.device), L)
        out, count, rounds, reads, pos = [], 1, 0, 0, L
        while count < num_tokens:
            props = self.propose(cur, pos, d_cache)
            g = self.verify(cur, props, pos, t_cache)
            vals = torch.cat([cur, props, g]).tolist()  # the round's one read
            reads += 1
            p, gg = vals[1 : k + 1], vals[k + 1 :]
            a = next((i for i in range(k) if p[i] != gg[i]), k)
            if not out:
                out.append(vals[0])
            out += p[:a] + [gg[a]]
            count, rounds, pos = count + a + 1, rounds + 1, pos + a + 1
            cur = g[a : a + 1]
        if not out:
            out.append(int(cur.item()))
            reads += 1
        self.last_stats = {
            "tokens": count, "rounds": rounds,
            "accept_rate": ((count - 1) / rounds - 1) / k if rounds else 1.0,
            "host_reads": reads,
        }
        return np.asarray(out[:num_tokens], np.int32)[None, :]
