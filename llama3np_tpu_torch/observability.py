"""Phase timing for generation (prefill ms and decode tokens/s), the
profiler trace, the numerics checks, the run log and the debug tensor-stats
trace.

Counterpart of `llama3np_tpu.observability`.  On the card each timed phase
ends in `torch.cuda.synchronize()`, so the host clock measures the device's
work and not the enqueue.  `trace` records a torch.profiler Chrome trace
(host ops and, on the card, every kernel) where the JAX package records a
jax.profiler one; `debug_mode` checks each forward's logits for NaN/Inf
where the JAX package sets `jax_debug_nans`; `debug_trace_forward` /
`debug_trace_generate` replay a forward eagerly through the port's plain
ops, emitting the reference debug build's tensor-stats lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import logging.handlers
import os
import tempfile
import time
from typing import Callable, Dict, Optional

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


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler context over the enclosed work: host ops and, on the
    card, every CUDA kernel (the hand-written ones by their names).  On
    exit it writes a Chrome trace (`trace_<time>.json`, open it in
    Perfetto or chrome://tracing) into `logdir` (default: a directory
    under the temporary directory) and keeps its path in `trace.last`."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "llama3np_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    trace.last = path


trace.last = None


# ---------------------------------------------------------------------------
# Numerics checks
# ---------------------------------------------------------------------------

_DEBUG = {"nans": False, "checks": False}


def check_finite(t: torch.Tensor, what: str, kind: str = "nans"):
    """Raise FloatingPointError if `t` holds a NaN or an Inf while a
    `debug_mode` context with `kind` on is active (a host read, so only
    then)."""
    if _DEBUG[kind] and not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"non-finite values in {what} (debug_mode)")


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = True):
    """Numerics-sanitizer context, the counterpart of the JAX package's
    `jax_debug_nans` / `jax_enable_checks`: with `nans`, each forward's
    logits (on the greedy kernel path, which forms none, the head's input)
    are checked for NaN/Inf; with `checks`, the KV cache a generation
    leaves; either raises FloatingPointError.  Each check reads the device,
    so they run only inside this context."""
    prev = dict(_DEBUG)
    try:
        _DEBUG["nans"] = _DEBUG["nans"] or nans
        _DEBUG["checks"] = _DEBUG["checks"] or checks
        yield
    finally:
        _DEBUG.update(prev)


# ---------------------------------------------------------------------------
# Run log (JSONL)
# ---------------------------------------------------------------------------

class RunLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, record: Dict):
        record = {"ts": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


# ---------------------------------------------------------------------------
# Debug tensor-stats trace
# ---------------------------------------------------------------------------

def make_debug_logger(log_dir: str = "output/debug",
                      max_bytes: int = 10 * 1024 * 1024,
                      backups: int = 5) -> logging.Logger:
    """Rotating-file debug logger (the reference debug build's sink shape:
    10 MB x 5 rotation).  One logger per directory; repeat calls for the
    same directory reuse the same file.  Fed by `debug_trace_forward` via
    the CLI's ``--debug-log-dir``."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"llama3np_tpu_torch.debug.{os.path.abspath(log_dir)}")
    if not logger.handlers:
        handler = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"llama3np_tpu_debug_{int(time.time())}.log"),
            maxBytes=max_bytes, backupCount=backups,
        )
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
    return logger


def _stat_line(name: str, t) -> str:
    """The JAX package's stats line: dtype, shape, min, max, mean (of the
    values widened to float64)."""
    if isinstance(t, torch.Tensor):
        dtype = str(t.dtype).replace("torch.", "")
        t = t.detach().cpu()
        a = (t.double() if t.is_floating_point() else t).numpy()
    else:
        a = np.asarray(t)
        dtype = a.dtype
    if a.size == 0:
        return f"{name}: empty"
    af = a.astype(np.float64) if a.dtype.kind == "f" else a
    return (f"{name}: dtype={dtype}, shape={tuple(a.shape)}, "
            f"min={af.min():.6f}, max={af.max():.6f}, mean={af.mean():.6f}")


def _traced_forward(engine, ids: np.ndarray, start_pos: int, layer_kv, emit):
    """One eager forward through the port's plain ops with a stats line at
    each checkpoint of the JAX package's `_traced_forward` (the same names
    in the same order; layer 0's checkpoints, then the logits), threading
    the per-layer caches.  layer_kv: list of (ck, cv) per layer ([B, KVH,
    M, HD]), updated in place.  Returns logits [B, 1, VS] in the
    activations' dtype."""
    from .models.llama import _qkv, _ffn, embed_tokens
    from .ops import core as ops

    cfg, params = engine.cfg, engine.params
    B, L = ids.shape
    emit(_stat_line("input_ids", ids))
    h = embed_tokens(params, torch.as_tensor(ids, dtype=torch.long, device=engine.device))
    emit(_stat_line("embedding", h))
    cos = engine.cos[start_pos : start_pos + L]
    sin = engine.sin[start_pos : start_pos + L]
    ly = params["layers"]
    for i in range(engine.args.n_layers):
        first = i == 0
        lp = {name: w[i] for name, w in ly.items()}
        x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        if first:
            emit(_stat_line("attn_norm_out", x))
        q, k, v = _qkv(x, lp, cfg)
        if first:
            emit(_stat_line("xq", q))
            emit(_stat_line("xk", k))
            emit(_stat_line("xv", v))
        rope = ops.apply_rope_split if cfg.rope_split else ops.apply_rope
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        if first:
            emit(_stat_line("rope_xq", q))
            emit(_stat_line("rope_xk", k))
        ck, cv = layer_kv[i]
        ops.update_kv_cache(ck, cv, k, v, start_pos)
        if first:
            emit(_stat_line("k_cache", ck))
            emit(_stat_line("v_cache", cv))
        if start_pos == 0 and L > 1:
            attn = ops.causal_attention(q, k, v)
        else:
            attn = ops.cache_attention(q, ck, cv, start_pos)
        if first:
            emit(_stat_line("attn_out", attn))
        h = h + ops.fused_o_proj(attn, lp["wo"], lp.get("wo_scale")).to(h.dtype)
        z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + _ffn(z, lp, cfg)
        if first:
            emit(_stat_line("block_out", h))
    h = ops.rms_norm(h, params["norm"], cfg.norm_eps)
    logits = ops._scaled_dot(h[:, -1:, :], params["lm_head"],
                             params.get("lm_head_scale")).to(h.dtype)
    emit(_stat_line("logits", logits))
    return logits


def _init_layer_kv(engine, B):
    cache = engine.init_cache(B)
    return [(cache["k"][i], cache["v"][i]) for i in range(engine.args.n_layers)]


def debug_trace_forward(engine, input_ids, start_pos: int = 0,
                        emit: Optional[Callable[[str], None]] = None) -> np.ndarray:
    """Eagerly replay one forward through the layer-0 checkpoints, emitting
    a tensor-stats line per checkpoint (the reference debug build's
    one-shot trace).  Returns the logits [B, 1, VS] as a float32 array.

    A diagnostic, not the main path: it replays the port's plain ops op by
    op on the engine's device (as the JAX package's replay runs jnp ops
    outside jit rather than its kernels), so the stats are those of the
    plain computation of the same weights."""
    emit = emit or print
    ids = np.asarray(input_ids).astype(np.int32)
    with torch.no_grad():
        logits = _traced_forward(engine, ids, start_pos,
                                 _init_layer_kv(engine, ids.shape[0]), emit)
    return logits.float().cpu().numpy()


def debug_trace_generate(engine, input_ids, num_tokens: int,
                         emit: Optional[Callable[[str], None]] = None) -> np.ndarray:
    """Per-token eager-replay trace of a short greedy generation: prefill,
    then each decode token, each forward emitting the full checkpoint set
    (the reference debug build logs every op of the whole generation).
    Returns the greedy tokens [B, num_tokens], the engine's stream for the
    same prompt (the plain ops, replayed eagerly; a diagnostic, as
    `debug_trace_forward`)."""
    emit = emit or print
    ids = np.asarray(input_ids).astype(np.int32)
    B, L = ids.shape
    with torch.no_grad():
        layer_kv = _init_layer_kv(engine, B)
        emit(f"=== prefill: {L} prompt tokens ===")
        logits = _traced_forward(engine, ids, 0, layer_kv, emit)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        toks = [tok]
        for j in range(1, num_tokens):
            emit(f"=== decode token {j} (pos={L + j - 1}) ===")
            logits = _traced_forward(engine, tok[:, None].cpu().numpy().astype(np.int32),
                                     L + j - 1, layer_kv, emit)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            toks.append(tok)
    return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
