"""Perplexity and sequence scoring.

Counterpart of `llama3np_tpu.eval`: teacher-forced scoring of token
sequences through the engine's own prefill forward (`forward_hidden`,
first chunk: the flash-prefill kernel on the card), so it measures any
deployment the engine runs (float32 or 16-bit, fused or split, int8 or
int4 weights).  ppl(int8) - ppl(fp32) on held-out text is the accuracy
envelope of quantization that tolerance tests cannot express.

  * Sequences are scored in length buckets, powers of two from 8 capped at
    max_len: ragged documents pad to their bucket, and causal attention
    keeps the padding from touching real positions.  The tail batch pads
    with copies of its last row.
  * Only [B, L-1] log-probabilities come back to the host.  The vocab axis
    is reduced in chunks of positions (CHUNK_BYTES of f32 logits a chunk):
    at 128K vocab [8, 1023, VS] f32 logits would take 4.2 GB, and their
    log_softmax as much again.  Each position's numbers do not depend on
    the chunking.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .kvcache import init_cache
from .models.llama import forward_hidden, lm_logits
from .ops import core as ops

CHUNK_BYTES = 1 << 30  # f32 logits reduced at a time


class Scorer:
    """Bucketed teacher-forced scorer over a `Llama` engine, on its
    device.  Over a sharded engine (`Llama(mesh=)`) every rank scores the
    whole batch on its heads and vocabulary columns, and returns the same
    numbers."""

    def __init__(self, engine, batch_size: int = 8, max_len: Optional[int] = None):
        self.engine = engine
        self.args = engine.args
        self.batch_size = batch_size
        self.max_len = max_len or self.args.max_seq_len

    def _score_impl(self, ids: torch.Tensor) -> torch.Tensor:
        """Per-position next-token log-probs of one padded batch: ids
        [B, L] on the engine's device -> lp [B, L-1] f32, lp[b, t] = log
        P(ids[b, t+1] | ids[b, :t+1])."""
        eng, cfg = self.engine, self.engine.cfg
        B, L = ids.shape
        row = init_cache(self.args, batch_size=B, max_seq_len=L, device=eng.device,
                         kv_heads=cfg.kv_heads)  # a tensor-parallel rank's own
        with torch.inference_mode():
            h, _ = forward_hidden(eng.params, ids, 0, row, eng.cos, eng.sin, cfg,
                                  first_chunk=True)
            h = ops.rms_norm(h[:, :-1], eng.params["norm"], cfg.norm_eps).reshape(B * (L - 1), -1)
            labels = ids[:, 1:].reshape(-1)
            step = max(1, CHUNK_BYTES // (4 * self.args.vocab_size))
            out = torch.empty(B * (L - 1), dtype=torch.float32, device=ids.device)
            for s in range(0, out.shape[0], step):
                lps = torch.log_softmax(lm_logits(eng.params, h[s : s + step],
                                                  cfg.mesh).float(), dim=-1)
                out[s : s + step] = torch.gather(lps, 1, labels[s : s + step, None])[:, 0]
        return out.reshape(B, L - 1)

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)  # rope tables only cover max_seq_len

    def score(self, seqs: List[List[int]]):
        """Per-sequence total negative log-likelihood and scored-token
        counts, aligned with `seqs`: sequence b contributes len(seqs[b]) - 1
        tokens (the first is conditioned on, never scored).  Sequences
        longer than max_len are truncated."""
        nll = np.zeros(len(seqs))
        cnt = np.zeros(len(seqs), np.int64)
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            rows = [seqs[i][: self.max_len] for i in idxs]
            L = self._bucket(max(len(r) for r in rows))
            ids = np.zeros((len(rows), L), np.int64)
            for j, r in enumerate(rows):
                ids[j, : len(r)] = r
            # Batch-size buckets too: the tail batch pads with row copies.
            if len(rows) < self.batch_size:
                ids = np.vstack([ids] + [ids[-1:]] * (self.batch_size - len(rows)))
            lp = self._score_impl(torch.from_numpy(ids).to(self.engine.device)).cpu().numpy()
            for j, (i, r) in enumerate(zip(idxs, rows)):
                n = len(r) - 1
                nll[i] = -lp[j, :n].sum()
                cnt[i] = n
        return nll, cnt

    def perplexity(self, seqs: List[List[int]]) -> Dict:
        """Corpus perplexity: exp(total NLL / total scored tokens)."""
        nll, cnt = self.score(seqs)
        total, n = float(nll.sum()), int(cnt.sum())
        if n == 0:
            raise ValueError("no scorable tokens (all sequences length < 2)")
        return {"nll_per_token": total / n, "ppl": float(np.exp(total / n)),
                "tokens": n, "sequences": len(seqs)}


def perplexity_of_texts(engine, tokenizer, texts: Iterable[str],
                        batch_size: int = 8) -> Dict:
    """Tokenize and score raw strings (BOS-prefixed, the reference's
    encoding)."""
    seqs = [tokenizer.encode(t, add_bos=True) for t in texts]
    return Scorer(engine, batch_size=batch_size).perplexity(seqs)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="llama3np_tpu_torch.eval",
        description="perplexity over a text file (one document per line)")
    p.add_argument("path", help="text file; blank lines skipped")
    p.add_argument("--preset", default="stories15M")
    p.add_argument("--model", default="./stories15M.model.npz")
    p.add_argument("--tokenizer", default="./tokenizer.model.np")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--quant", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if there is no card)")
    args = p.parse_args(argv)

    from . import Tokenizer, preset, synthetic_weights
    from .models.llama import Llama

    margs = preset(args.preset, **({"quant": args.quant} if args.quant else {}))
    source = synthetic_weights(margs, seed=0) if args.synthetic else args.model
    engine = Llama(source, margs, device=args.device)
    tok = Tokenizer(args.tokenizer)
    with open(args.path) as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    print(json.dumps(perplexity_of_texts(engine, tok, texts, batch_size=args.batch_size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
