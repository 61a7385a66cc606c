#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`llama3np_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from `llama3np_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card at the shapes the
main path gives it (stories15M and tinyllama-1.1b widths), drives greedy
generation end to end through the port's entry points (stories15M against
the port's NumPy oracle; tinyllama-1.1b at full width and depth against the
plain path on the same card), traces each model's prefill and a few
decode tokens with torch.profiler (device time by kernel, device busy
share), runs the CLI, and prints one JSON
line per phase.  Any failure raises and exits non-zero; the last line,
`{"ok": true, "device": {...}}`, is printed only when every phase passed.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.

Times are CUDA-event times on the card, after warm-up, averaged over many
launches; bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s fp32
(TF32 stays off).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
PROMPT = [1, 76, 505, 263, 12561]  # "I have a dream" (reference tokenizer)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    """Least time in ms for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean CUDA-event time of `fn` over `reps` launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, got, want, rtol, atol, what):
    """Max abs error, and max abs error over max |want|; raises past
    |got - want| <= atol + rtol * |want|."""
    err = (got.float() - want.float()).abs()
    max_abs = err.max().item()
    max_rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements past "
                             f"rtol {rtol} / atol {atol} (max abs err {max_abs})")
    return max_abs, max_rel


class Smoke:
    def __init__(self, torch, card: str):
        self.torch = torch
        self.card = card
        self.g = torch.Generator().manual_seed(0)

    def randn(self, *shape, scale=1.0):
        return (self.torch.randn(*shape, generator=self.g) * scale).to("cuda")

    # -- kernel phases ------------------------------------------------------

    def flash_phase(self, model: str, B, L, NH, KVH, HD):
        torch = self.torch
        import torch.nn.functional as F
        from llama3np_tpu_torch.ops.kernels.flash_prefill import (
            flash_prefill, flash_prefill_plain)

        q = self.randn(B, L, NH, HD)
        k = self.randn(B, L, KVH, HD)
        v = self.randn(B, L, KVH, HD)
        launches = flash_prefill.launches
        got = flash_prefill(q, k, v)
        torch.cuda.synchronize()
        want = flash_prefill_plain(q, k, v)
        rtol, atol = 1e-4, 1e-5
        max_abs, max_rel = compare(torch, got, want, rtol, atol,
                                   f"flash_prefill {model} L={L}")
        reps = 200 if L <= 128 else 50
        ms = time_ms(torch, lambda: flash_prefill(q, k, v), reps)
        plain_ms = time_ms(torch, lambda: flash_prefill_plain(q, k, v), reps)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        compare(torch, lib_out.transpose(1, 2), want, 1e-3, 1e-4,
                "scaled_dot_product_attention yardstick")
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        flash_prefill.launches = launches  # comparison launches do not count
        flops = 4.0 * B * NH * HD * L * (L + 1) / 2
        nbytes = 4.0 * (2 * B * L * NH * HD + 2 * B * L * KVH * HD)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"phase": "kernel", "kernel": "flash_prefill", "model": model,
               "shape": {"B": B, "L": L, "NH": NH, "KVH": KVH, "HD": HD},
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": {"rtol": rtol, "atol": atol}, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "card": self.card}
        emit(row)
        return row

    def decode_phase(self, model: str, layers, args, pos: int):
        torch = self.torch
        from llama3np_tpu_torch.ops.kernels.decode_step import (
            decode_layers, decode_layers_plain)

        nl, kvh, M, hd = args.n_layers, args.kv_heads, args.max_seq_len, args.head_dim
        kc = self.randn(nl, kvh, M, hd)
        vc = self.randn(nl, kvh, M, hd)
        x = self.randn(1, args.dim, scale=0.5)
        ang = torch.rand(1, hd // 2, generator=self.g).to("cuda") * pos
        cos, sin = ang.cos(), ang.sin()
        kw = dict(n_heads=args.n_heads, kv_heads=kvh, head_dim=hd,
                  norm_eps=args.norm_eps)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        launches = decode_layers.launches
        got, _, _ = decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)
        torch.cuda.synchronize()
        want, _, _ = decode_layers_plain(layers, x, pos, k2, v2, cos, sin, **kw)
        rtol, atol = 1e-4, 1e-4
        max_abs, max_rel = compare(torch, got, want, rtol, atol,
                                   f"decode_layers {model} pos={pos}")
        compare(torch, k1[:, :, pos], k2[:, :, pos], rtol, atol, "new K rows")
        compare(torch, v1[:, :, pos], v2[:, :, pos], rtol, atol, "new V rows")
        others = torch.ones(M, dtype=torch.bool, device="cuda")
        others[pos] = False
        if not (torch.equal(k1[:, :, others], kc[:, :, others])
                and torch.equal(v1[:, :, others], vc[:, :, others])):
            raise AssertionError("decode_layers changed cache rows other than pos")
        reps = 200 if nl * args.dim < 10000 else 20
        ms = time_ms(torch, lambda: decode_layers(layers, x, pos, k1, v1, cos, sin, **kw), reps)
        plain_ms = time_ms(torch, lambda: decode_layers_plain(
            layers, x, pos, k2, v2, cos, sin, **kw), reps)
        decode_layers.launches = launches  # comparison launches do not count
        w_elems = sum(layers[n].numel() for n in
                      ("wqkv", "wo", "wgu", "w_down", "attn_norm", "ffn_norm"))
        nbytes = 4.0 * (w_elems + 2 * args.dim + hd
                        + 2 * nl * kvh * hd * (pos + 1))
        flops = 2.0 * w_elems + 4.0 * nl * args.n_heads * hd * (pos + 1)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"phase": "kernel", "kernel": "decode_layers", "model": model,
               "shape": {"NL": nl, "D": args.dim, "NH": args.n_heads,
                         "KVH": kvh, "HD": hd, "FD": args.hidden_dim, "M": M,
                         "pos": pos},
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": {"rtol": rtol, "atol": atol}, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None, "card": self.card}
        emit(row)
        return row


def profile_phase(torch, model: str, engine, prompt, card: str):
    """Trace the prefill and 8 decode tokens (kernel path) with
    torch.profiler: device time by kernel (top 6) and the device's busy
    share of each traced window.  Only device-side events count.  The
    profiler's own host overhead lengthens the windows, so a busy share is
    a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama3np_tpu_torch.generate import pad_prompt, prefill_step

    def trace(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), key=lambda r: -r[1])
        device_ms = sum(r[1] for r in rows)
        return out, {"wall_ms": wall_ms,
                     "device_ms": device_ms if rows else "not measured",
                     "device_busy_share": device_ms / wall_ms if rows else "not measured",
                     "top": [{"name": k[:80], "device_ms": ms, "count": n}
                             for k, ms, n in rows[:6]]}

    gen = engine._gen
    padded, L = pad_prompt(prompt, engine.args)
    ids = torch.as_tensor(padded, device=engine.device)

    def prefill(cache):
        return prefill_step(engine.params, ids, L, cache, engine.cos,
                            engine.sin, gen.cfg)

    prefill(engine.init_cache(1))  # warm
    cache = engine.init_cache(1)  # allocated outside the traced window
    (tok0, cache), pre = trace(lambda: prefill(cache))
    gen.decode_fn(2)(engine.params, tok0, L, cache, engine.cos, engine.sin)  # warm
    _, dec = trace(lambda: gen.decode_fn(8)(engine.params, tok0, L, cache,
                                            engine.cos, engine.sin))
    return {"phase": "profile", "model": model, "path": "kernels",
            "prefill": {"bucket": int(ids.shape[1]), **pre},
            "decode": {"tokens": 8, "from_pos": L, **dec}, "card": card}


def counters():
    from llama3np_tpu_torch.ops.kernels.decode_step import decode_layers
    from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill
    return {"flash_prefill": flash_prefill.launches,
            "decode_layers": decode_layers.launches}


def reset_counters():
    from llama3np_tpu_torch.ops.kernels.decode_step import decode_layers
    from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill
    flash_prefill.launches = 0
    decode_layers.launches = 0


def synthetic_vocab(path: str, size: int, seed: int = 0):
    """A tokenizer model of `size` entries made from a seed: the markers,
    printable ASCII, then random merges of letters and spaces."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    seen = set(tokens)
    letters = list("abcdefghijklmnopqrstuvwxyz      ")
    while len(tokens) < size:
        t = "".join(rng.choice(letters, size=int(rng.integers(2, 6))))
        if t not in seen:
            seen.add(t)
            tokens.append(t)
    scores = [0.0, 0.0, 0.0] + (-rng.random(size - 3) * 10).tolist()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"tokens": tokens, "scores": scores}, f)
    return path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    import llama3np_tpu_torch
    from llama3np_tpu_torch import (NumpyLlama, build_param_tree, preset,
                                    synthetic_weights)
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import timed_generate
    from llama3np_tpu_torch.ops.kernels import _build

    pkg = os.path.dirname(os.path.abspath(llama3np_tpu_torch.__file__))
    if pkg != os.path.join(REPO, "llama3np_tpu_torch"):
        raise RuntimeError(f"the port must come from this checkout, not {pkg}")

    # fp32 parity: matmuls in full f32, as the JAX reference accumulates.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.KernelLibrary.get()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.KernelLibrary.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": _build.KernelLibrary.build_seconds,
          "library": os.path.relpath(_build.KernelLibrary.path, REPO),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card,
          "ptxas": ptxas})
    smoke = Smoke(torch, card)

    # ---- stories15M: kernels at its shapes, then the greedy path ----------
    s_args = preset("stories15M", max_seq_len=1024)
    s_weights = synthetic_weights(s_args, seed=0)
    s_eng = Llama(s_weights, s_args, device="cuda")
    hd = s_args.head_dim
    for L in (16, 100):
        smoke.flash_phase("stories15M", 1, L, s_args.n_heads, s_args.kv_heads, hd)
    for pos in (0, 5, 1023):
        smoke.decode_phase("stories15M", s_eng.params["layers"], s_args, pos)

    ids = np.array([PROMPT], np.int64)
    oracle = NumpyLlama(build_param_tree(s_weights, s_args), s_args)
    n_check = 32
    want = []
    for t in oracle.generate(ids, n_check + ids.shape[1]):
        want.append(int(t[0, -1]))
        if len(want) == n_check:
            break
    reset_counters()
    got = s_eng.generate_tokens(ids, n_check).cpu()[0].tolist()
    s_counts = counters()
    if got != want:
        at = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"stories15M greedy stream diverges from NumpyLlama "
                             f"at token {at}: {got[:8]} vs {want[:8]}")
    if s_counts != {"flash_prefill": s_args.n_layers, "decode_layers": n_check - 1}:
        raise AssertionError(f"stories15M launch counts {s_counts}")
    toks, stats = timed_generate(s_eng, ids, 1000)
    if toks.shape != (1, 1000) or toks.cpu()[0, :n_check].tolist() != want:
        raise AssertionError("stories15M timed stream disagrees with the oracle")
    emit({"phase": "e2e", "model": "stories15M", "greedy_tokens_equal_oracle": n_check,
          "launches": s_counts, "timed_tokens": 1000,
          "prefill_ms": stats.prefill_ms, "decode_tok_s": stats.decode_tok_s,
          "card": card})
    emit(profile_phase(torch, "stories15M", s_eng, ids, card))
    del s_eng

    # ---- tinyllama-1.1b at full width and depth ---------------------------
    t_args = preset("tinyllama-1.1b")
    t_weights = synthetic_weights(t_args, seed=0)
    t_eng = Llama(t_weights, t_args, device="cuda")
    flash_row = smoke.flash_phase("tinyllama-1.1b", 1, 512, t_args.n_heads,
                                  t_args.kv_heads, t_args.head_dim)
    smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 0)
    decode_row = smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 511)

    prompt = np.random.default_rng(0).integers(3, t_args.vocab_size, size=(1, 500))
    n_tok = 32
    reset_counters()  # the main path: greedy generation through the kernels
    toks_k = t_eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    main_counts = counters()
    if main_counts != {"flash_prefill": t_args.n_layers, "decode_layers": n_tok - 1}:
        raise AssertionError(f"tinyllama launch counts {main_counts}")
    logits_k = torch.from_numpy(t_eng(prompt, 0))  # ragged L=500 prefill
    k_stats = timed_generate(t_eng, prompt, 64)[1]
    emit(profile_phase(torch, "tinyllama-1.1b", t_eng, prompt, card))
    del t_eng
    torch.cuda.empty_cache()

    x_eng = Llama(t_weights, t_args.replace(attn_impl="xla"), device="cuda")
    toks_x = x_eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    logits_x = torch.from_numpy(x_eng(prompt, 0))
    x_stats = timed_generate(x_eng, prompt, 64)[1]
    del x_eng
    if toks_k != toks_x:
        at = next(i for i, (a, b) in enumerate(zip(toks_k, toks_x)) if a != b)
        raise AssertionError(f"tinyllama kernel stream diverges from the plain "
                             f"path at token {at}")
    l_abs, l_rel = compare(torch, logits_k, logits_x, 1e-3, 1e-3,
                           "tinyllama last-prompt logits")
    if not torch.isfinite(logits_k).all():
        raise AssertionError("non-finite logits")
    emit({"phase": "e2e", "model": "tinyllama-1.1b", "prompt_tokens": 500,
          "greedy_tokens_equal_plain": n_tok, "launches": main_counts,
          "logits_max_abs_err": l_abs, "logits_max_rel_err": l_rel,
          "logits_tol": {"rtol": 1e-3, "atol": 1e-3},
          "kernels": {"prefill_ms": k_stats.prefill_ms,
                      "decode_tok_s": k_stats.decode_tok_s},
          "plain": {"prefill_ms": x_stats.prefill_ms,
                    "decode_tok_s": x_stats.decode_tok_s},
          "timed_tokens": 64, "card": card})

    # ---- the CLI ------------------------------------------------------------
    vocab = synthetic_vocab(os.path.join(REPO, "build", "smoke", "vocab.json"),
                            preset("stories15M").vocab_size)
    cli = subprocess.run(
        [sys.executable, "-m", "llama3np_tpu_torch.cli", "--synthetic",
         "--preset", "stories15M", "--tokenizer", vocab, "I have a dream"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    last = cli.stdout.rstrip().splitlines()[-1] if cli.stdout.strip() else ""
    if cli.returncode != 0 or not last.startswith("Token count:"):
        raise AssertionError(f"CLI failed (rc {cli.returncode}):\n"
                             f"{cli.stdout[-2000:]}\n{cli.stderr[-2000:]}")
    emit({"phase": "cli", "last_line": last,
          "stats": cli.stderr.strip().splitlines()[-1]})

    # ---- summary --------------------------------------------------------------
    sources = {"flash_prefill": ("llama3np_tpu_torch/csrc/flash_prefill.cu",
                                 "llama3np_tpu/ops/kernels/flash_prefill.py:76"),
               "decode_layers": ("llama3np_tpu_torch/csrc/decode_step.cu",
                                 "llama3np_tpu/ops/kernels/decode_step.py:917")}
    kernels = []
    for row in (flash_row, decode_row):
        src, replaces = sources[row["kernel"]]
        kernels.append({
            "name": row["kernel"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_counts[row["kernel"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "model": row["model"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
