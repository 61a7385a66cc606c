"""Phase timing for generation: prefill ms and decode tokens/s.

Counterpart of `llama3np_tpu.observability.GenerationStats` and
`timed_generate`.  On the card each phase ends in
`torch.cuda.synchronize()`, so the host clock measures the device's work and
not the enqueue.  Profiler traces and the debug tensor-stats trace wait for
a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def prefill_ms(self) -> float:
        return self.prefill_s * 1e3

    @property
    def decode_tok_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "prefill_ms": round(self.prefill_ms, 3),
            "decode_tok_s": round(self.decode_tok_s, 1),
        }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_generate(engine, input_ids, num_tokens: int, sampling=None) -> tuple:
    """Run prefill and decode separately, each fenced by a device sync;
    returns (tokens [B, num_tokens], GenerationStats).  As in the JAX
    package, decode_s covers the num_tokens - 1 tokens after the first.
    A `generate.Sampling` policy with a temperature above 0 draws the
    tokens as `Generator.generate` does (its keys are made before the
    clock starts)."""
    from .generate import (Generator, decode_keys, pad_prompt, prefill_logits,
                           prefill_step, sample_token)

    ids = np.asarray(input_ids)
    B, L = ids.shape
    gen = engine._gen
    if gen is None:
        gen = engine._gen = Generator(engine)
    cache = engine.init_cache(B)
    _sync(engine.device)
    stats = GenerationStats(prompt_tokens=L, generated_tokens=num_tokens)
    if num_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.long, device=engine.device), stats

    padded, L = pad_prompt(ids, engine.args)
    ids_t = torch.as_tensor(padded, device=engine.device)
    stochastic = sampling is not None and sampling.temperature > 0.0
    if stochastic:
        keys = decode_keys(sampling, num_tokens - 1, L,
                           engine.args.max_seq_len).to(engine.device)
    t0 = time.perf_counter()
    if stochastic:
        logits0, cache = prefill_logits(engine.params, ids_t, L, cache,
                                        engine.cos, engine.sin, gen.cfg)
        tok0 = sample_token(logits0, keys[0], sampling)
    else:
        tok0, cache = prefill_step(engine.params, ids_t, L, cache, engine.cos,
                                   engine.sin, gen.cfg)
    _sync(engine.device)
    stats.prefill_s = time.perf_counter() - t0

    if num_tokens == 1:
        return tok0[:, None], stats
    t0 = time.perf_counter()
    if stochastic:
        toks, cache = gen.sampled_decode_fn(num_tokens - 1, sampling, B)(
            engine.params, tok0, L, cache, engine.cos, engine.sin, keys[1:])
    else:
        toks, cache = gen.decode_fn(num_tokens - 1, B)(
            engine.params, tok0, L, cache, engine.cos, engine.sin)
    _sync(engine.device)
    stats.decode_s = time.perf_counter() - t0
    engine.cache = cache
    return torch.cat([tok0[:, None], toks], dim=1), stats
