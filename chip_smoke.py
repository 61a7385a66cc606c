#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`llama3np_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from `llama3np_tpu_torch/csrc/`,
times the plain products (`ops.core._dot`) at the benchmark cells' shapes
on both paths, the bf16 tensor-core GEMM against the widened f32 one
(`DOT_SHAPES`), holds each kernel against its plain PyTorch version on the
card at the shapes the main path gives it (stories15M, tinyllama-1.1b and
llama3-8b widths; the decode kernel in its float32, int8, bf16, fp16,
int8/bf16 and int8/fp16 modes, the paged-attention kernel over float32, bf16, fp16 and int8 pools,
int8 under a float32, bf16 or fp16 q, flash prefill and the greedy head in
float32, bf16 and fp16, and the kv_dtype override's modes), drives greedy
generation end to end through the port's entry points (stories15M against
the port's NumPy oracle; tinyllama-1.1b at full width and 8 of its 22
layers (`TINY_LAYERS`, for the time limit) against
the plain path on the same card), traces each model's prefill and a few decode tokens with
torch.profiler (device time by kernel, device busy share), runs the CLI in
float32 and bfloat16, then drives continuous-batching serving of
tinyllama-1.1b at full width over the paged KV cache (12
staggered requests at quanta 1 and 4 and with chunked admission, every
served stream against its solo stream, exact launch counts, no leaked
pages; the plain path's rate; a traced window of serving steps).  Then
tinyllama-1.1b with int8 weights: greedy generation through the decode
kernel's int8 mode (on grid-snapped weights against the fp32 kernel
stream, on the synthetic weights against the int8 plain path), and serving
with int8 weights and int8 KV through the paged kernel's int8 mode (every
stream against its capacity-1 stream), each traced.  Then tinyllama-1.1b in
float16 (generation against the plain path within the fp16 envelope,
serving over fp16 pools and over int8 pools against capacity-1 streams)
and with int8 weights under float16 activations (generation).  Then
llama3-8b in bf16 at full width and depth: the engine's own loader over
weights made on the card, the bf16 kernels (and the paged kernel's
int8-under-bf16 mode) at its shapes, greedy generation through flash
prefill, the decode step and the greedy head against the plain path, and
paged serving at quanta 1 and 4 against capacity-1 streams, over bf16
pools and over int8 pools (the pools' bytes a token and the 8,192-token
rows that fit beside the weights), each traced (16-bit streams may part at
a near-tie: the first differing token must be one), sampled generation
(T 0.8, top-p 0.9, seed 0; tinyllama-1.1b too) through the decode kernel
against the plain path (equal, or parted at a near-tie of the perturbed
logits), the prefix cache (8 requests sharing a 2,048-token prefix and a
second turn, over bf16 and int8 pools, against the same traffic admitted
cold) and the HTTP server (`llama3np_tpu_torch.server` on 127.0.0.1:
concurrent streamed completions against capacity-1 streams, a streamed
against a whole response, a two-turn chat that hits the prefix cache,
sampled requests, /stats and /metrics); then llama3-8b with
int8 weights under bf16 activations at full width and depth (the decode
kernel's int8/bf16 mode against its twin, greedy generation against the
plain path by the same rules, a trace with the plain int8 head's share,
serving with int8 KV), and greedy speculative decoding of the loaded
bf16 llama3-8b with that int8 engine as its self-draft (k = 4: the
draft's steps through the decode kernel's int8/bf16 mode, one plain
verify forward a round; the stream against the target's own kernel
stream by the near-tie rule, exact launch counts, tokens / rounds /
accept rate, a round split into draft steps, verify and the host read,
and traced); last, the fp16 kernel modes alone at llama3-8b's shapes.
Before the CLI, tinyllama-1.1b at full width also runs
speculation (fp32 target, int8 self-draft, the same checks), the split
layout in fp32 (its stream against the fused kernel stream), int4 weights
on int4-grid weights (stream and logits against the fp32 split engine,
weight bytes, prefill ms and decode tok/s, a trace), int4 serving over
int8 pools at quanta 1 and 4 against capacity-1 streams, a quantized
checkpoint's round trip and a mixed-bit tree (int4 layers, int8 head),
then the host tooling on checkpoints the script writes from seeded
weights: stories15M as a llama2.c `.bin` and tinyllama-1.1b as a bf16
safetensors HuggingFace directory, each converted and booted on the card
against the same weights handed over directly, a generation saved and
resumed over a bf16 cache, a profiler trace naming the kernels and the
debug tensor-stats replay against the kernel stream.  After tinyllama
serving, the kv_dtype override: for every (activation, cache) pair of
different float dtypes the decode kernel (float and int8 weights) and the
paged kernel against their twins at tinyllama shapes, then fp32
activations over a bf16 cache at full width (generation against the plain
path, serving at quanta 1 and 4 against capacity-1 streams).
Then (ROADMAP A7, A8) tinyllama-1.1b full-model training in float32 from
a token shard the script packs (`prefetch_to_device`, 8 AdamW steps:
step 0's loss against `next_token_loss`, the loss falling, finite
gradients) and stories15M's steps on the card against the CPU; and, on
the loaded bf16 llama3-8b before the int8 engine loads, multi-LoRA
serving over its split view (3 adapters, the 12 requests round-robin
over no adapter and adapters 0-2, quanta 1 and 4, against capacity-1
streams through the same adapter and the plain path, beside the same
workload without a bank; the HTTP server with adapter names), LoRA
fine-tuning over the frozen base (8 steps with remat: the loss falls,
the base's bits unchanged) and perplexity (`eval.Scorer`: per-token
log-probabilities against the plain twin and unpadded scoring).
After the int8 8B phases, parallelism (ROADMAP A9, `parallel_phase`):
llama3-70b at its published widths and 2 of its 80 layers in bf16, its
split tree made on the card; two ranks on the one card (gloo) take their
shards of it through CUDA IPC; tp=2 greedy generation and paged serving
(quanta 1 and 4, bf16 and int8 pools) and pp=2 generation in both
schedules, each against the single-rank engine by the near-tie rule,
with the kernels' launches on each rank and the kernels at a rank's
shapes against their twins.
The greedy head is also re-timed against torch.matmul +
torch.argmax in alternation (tinyllama-1.1b fp32 and fp16, llama3-8b bf16),
and fp32 flash prefill against scaled_dot_product_attention (stories15M
L=16 and 100, tinyllama-1.1b L=512).  It prints one JSON line
per phase (each with `t_s`, the seconds since start), then the `kernels`
line.  Any failure raises and exits non-zero; the last line, `{"ok": true,
"device": {...}}`, is printed only when every phase passed.  Without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.

    python3 chip_smoke.py --decode-ab PARENT_DIR [MODEL:MODE[@POS,...] ...]
    python3 chip_smoke.py --paged-ab PARENT_DIR
    python3 chip_smoke.py --kernel-ab PARENT_DIR
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --dot

run only the A9 phase (`--parallel`), the plain products (`--dot`) or an
A/B of the decode kernel (or of the paged kernel, or of the greedy head and fp32 flash prefill): the
one of the checkout unpacked at
PARENT_DIR (e.g. `git archive` of the parent commit) against this one's, in
one process, parent, change, change, parent at every shape of the decode
phases, with each one's step breakdown from torch.profiler (the paged
kernel: at llama3-8b's paged shapes, int8 pools under a bf16 and an fp16 q,
and bf16 pools; the head and flash: at the shapes of `AB_HEADS` and
`AB_FLASH`, with the library call in the same turns).

Times are CUDA-event times on the card, after warm-up, averaged over many
launches (flash prefill, the paged kernel, the greedy head and their
library yardsticks queued behind a spin kernel, so the host's enqueue of
each call does not bound them);
bounds use the H100 SXM's published 3.35 TB/s, 67 TFLOP/s fp32 (TF32 stays
off) and 989 TFLOP/s bf16 and fp16.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12  # bf16 and fp16 tensor cores alike
PROMPT = [1, 76, 505, 263, 12561]  # "I have a dream" (reference tokenizer)

# The plain products of the benchmark's cells (`Smoke.dot_phase`): M rows of
# the activation, K x N the weight.
DOT_SHAPES = (("mistral-7b D x FD, chat step", 64, 4096, 14336),
              ("deepseek-7b wqkv, longdoc step", 16, 4096, 12288),
              ("mistral-7b D x FD, 512-row prefill", 512, 4096, 14336),
              ("deepseek-7b lm_head, longdoc step", 16, 4096, 102400),
              ("mistral-7b w_down, chat step", 64, 14336, 4096))


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase rows carry `t_s`, the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_s: float = FP32_FLOP_S):
    """Least time in ms for the work, and what bounds it: float32 work at
    the 67 TFLOP/s fp32 peak, bf16 and fp16 work at the 989 TFLOP/s 16-bit
    tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
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


def queued_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls of a short kernel whose
    host enqueue takes longer than the kernel (which bounds `time_ms`):
    the calls are enqueued behind a spin kernel, so the card runs them back
    to back between the two events.  The spin doubles until the card is
    still spinning when the last call has been enqueued."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise AssertionError("the card drained the queue before every call was enqueued")


HALF_NAMES = {"torch.bfloat16": "bf16", "torch.float16": "fp16"}


def dtype_name(dtype) -> str:
    """fp32, bf16 or fp16."""
    return HALF_NAMES.get(str(dtype), "fp32")


def half_tol(dtype):
    """(rtol, atol) of one rounding of an f32 result to `dtype`: two ulps
    of bf16 (2^-8) or fp16 (2^-11); float32 kernels 1e-4 / 1e-5."""
    return {"bf16": (1e-2, 1e-2), "fp16": (2e-3, 2e-3)}.get(dtype_name(dtype), (1e-4, 1e-5))


def decode_mode(layers, cache_dtype=None) -> str:
    """The decode kernel's mode for a layer tree: fp32, int8 (under f32
    activations), bf16 or fp16, int8-bf16 or int8-fp16 (int8 weights under
    16-bit ones); over a cache of another dtype (the kv_dtype override)
    with "-kv-<cache>" after it."""
    act = dtype_name(layers["attn_norm"].dtype)
    if "wqkv_scale" in layers:
        mode = "int8" if act == "fp32" else f"int8-{act}"
    else:
        mode = act
    kv = dtype_name(cache_dtype or layers["attn_norm"].dtype)
    return mode if kv == act else f"{mode}-kv-{kv}"


def queue_reps(reps: int, launches_per_call: int, queue: int = 900) -> int:
    """Calls `queued_ms` may queue behind its spin kernel: the card holds a
    bounded number of pending launches (thousands), and the host blocks in
    a launch while the queue is full, so a call of many launches takes
    fewer repetitions."""
    return max(2, min(reps, queue // launches_per_call))


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

    def randn(self, *shape, scale=1.0, dtype=None):
        """Seeded normals on the card: float32 ones made on the host (the
        earlier phases' inputs), bf16 ones made on the card from a card
        generator (llama3-8b sizes: a pool is half a billion values)."""
        torch = self.torch
        if dtype in (None, torch.float32):
            return (torch.randn(*shape, generator=self.g) * scale).to("cuda")
        if not hasattr(self, "gc"):
            self.gc = torch.Generator("cuda").manual_seed(0)
        return (torch.randn(*shape, generator=self.gc, device="cuda") * scale).to(dtype)

    # -- kernel phases ------------------------------------------------------

    def flash_phase(self, model: str, B, L, NH, KVH, HD, dtype=None):
        """The flash kernel against its twin; bf16 and fp16 outputs are
        compared in f32 within two ulps (bf16 1e-2, fp16 2e-3: the one
        rounding of an f32 result whose sums ran in another order may land
        the other way).  `ms` and
        `library_ms` (SDPA) are device times per call (`queued_ms`: the bf16
        kernel is shorter than the host's enqueue); `event_ms` the
        CUDA-event time of back-to-back calls."""
        torch = self.torch
        import torch.nn.functional as F
        from llama3np_tpu_torch.ops.kernels.flash_prefill import (
            flash_prefill, flash_prefill_plain)

        dtype = dtype or torch.float32
        half = dtype != torch.float32
        q = self.randn(B, L, NH, HD, dtype=dtype)
        k = self.randn(B, L, KVH, HD, dtype=dtype)
        v = self.randn(B, L, KVH, HD, dtype=dtype)
        launches = flash_prefill.launches
        got = flash_prefill(q, k, v)
        torch.cuda.synchronize()
        want = flash_prefill_plain(q, k, v)
        rtol, atol = half_tol(dtype)
        max_abs, max_rel = compare(torch, got, want, rtol, atol,
                                   f"flash_prefill {model} L={L}")
        reps = 200 if L <= 128 else 50
        ms = queued_ms(torch, lambda: flash_prefill(q, k, v), reps)
        event_ms = time_ms(torch, lambda: flash_prefill(q, k, v), reps)
        plain_ms = time_ms(torch, lambda: flash_prefill_plain(q, k, v), reps)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        compare(torch, lib_out.transpose(1, 2), want, *(
            (2 * rtol, 2 * atol) if half else (1e-3, 1e-4)),
                "scaled_dot_product_attention yardstick")
        library_ms = queued_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        flash_prefill.launches = launches  # comparison launches do not count
        flops = 4.0 * B * NH * HD * L * (L + 1) / 2
        nbytes = q.element_size() * (2 * B * L * NH * HD + 2 * B * L * KVH * HD)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_S if half else FP32_FLOP_S)
        row = {"phase": "kernel", "kernel": "flash_prefill",
               "mode": dtype_name(dtype), "model": model,
               "shape": {"B": B, "L": L, "NH": NH, "KVH": KVH, "HD": HD},
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": {"rtol": rtol, "atol": atol}, "ms": ms, "event_ms": event_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms,
               "library_ms": library_ms, "card": self.card}
        emit(row)
        return row

    def decode_phase(self, model: str, layers, args, pos: int, cache_dtype=None,
                     reps: int = None):
        """The decode kernel against its plain twin; `layers` holds float32,
        bf16 or fp16 weights, or int8 weights with their scales (the int8
        mode under float32 norms, the int8/bf16 or int8/fp16 mode under
        16-bit norms); `cache_dtype` another float dtype for the caches (the
        kv_dtype override, held normwise as the 16-bit modes: an element of
        q or P may round to the other side of the twin's where the f32
        values it rounds differ by an ulp).  `ms` is the device time per
        call queued behind a spin kernel
        (`queued_ms`: where the host's enqueue of a call's launches takes
        longer than the card, back-to-back events time the host);
        `event_ms` the CUDA-event time of back-to-back calls."""
        torch = self.torch
        from llama3np_tpu_torch.ops.kernels.decode_step import (
            decode_layers, decode_layers_plain)

        nl, kvh, M, hd = args.n_layers, args.kv_heads, args.max_seq_len, args.head_dim
        dt = layers["attn_norm"].dtype  # the activations' dtype
        ct = cache_dtype or dt
        half = dt != torch.float32
        kc = self.randn(nl, kvh, M, hd, dtype=ct)
        vc = self.randn(nl, kvh, M, hd, dtype=ct)
        x = self.randn(1, args.dim, scale=0.5, dtype=dt)
        ang = torch.rand(1, hd // 2, generator=self.g).to("cuda") * pos
        cos, sin = ang.cos(), ang.sin()
        kw = dict(n_heads=args.n_heads, kv_heads=kvh, head_dim=hd,
                  norm_eps=args.norm_eps)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        launches = decode_layers.launches
        got, _, _ = decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)
        torch.cuda.synchronize()
        want, _, _ = decode_layers_plain(layers, x, pos, k2, v2, cos, sin, **kw)
        if half or ct != dt:
            # The twin rounds at the same points, but an f32 sum taken in
            # another order may round the other way at any of them, and the
            # 1-ulp flips compound through the layers (`by_depth` prints the
            # kernel-vs-twin error over the first 1 and 8 layers).  So 16-bit
            # modes are held normwise: kernel vs twin within 5e-2, and the kernel
            # no farther (within 25 %) from the f32 function of the same
            # weights and inputs (no bf16 rounding inside; int8 weights
            # dequantized by their scales) than the twin.  float32
            # activations over a 16-bit cache round only q and P in
            # attention: within 1e-2.
            rtol, atol = None, None
            tol = {"normwise": 5e-2 if half else 1e-2, "vs_f32_ratio": 1.25}
            ref = decode_layers_plain({n: t.float() for n, t in layers.items()},
                                      x.float(), pos, kc.float(), vc.float(), cos, sin,
                                      **kw)[0]

            def rel(a, b):
                return ((a.float() - b.float()).norm() / b.float().norm()).item()

            norm_err = {"kernel_vs_twin": rel(got, want), "kernel_vs_f32": rel(got, ref),
                        "twin_vs_f32": rel(want, ref),
                        "k_rows": rel(k1[:, :, pos], k2[:, :, pos]),
                        "v_rows": rel(v1[:, :, pos], v2[:, :, pos])}
            del ref
            norm_err["by_depth"] = {}
            for depth in (1, 8):
                if depth < nl:
                    sub = {n: t[:depth] for n, t in layers.items()}
                    a = decode_layers(sub, x, pos, kc[:depth].clone(), vc[:depth].clone(),
                                      cos, sin, **kw)[0]
                    b = decode_layers_plain(sub, x, pos, kc[:depth].clone(),
                                            vc[:depth].clone(), cos, sin, **kw)[0]
                    norm_err["by_depth"][depth] = rel(a, b)
            norm_err["by_depth"][nl] = norm_err["kernel_vs_twin"]
            if not (max(norm_err["kernel_vs_twin"], norm_err["k_rows"], norm_err["v_rows"])
                    <= tol["normwise"] and norm_err["kernel_vs_f32"]
                    <= tol["vs_f32_ratio"] * norm_err["twin_vs_f32"] + 1e-3):
                raise AssertionError(f"decode_layers {model} pos={pos}: normwise errors "
                                     f"{norm_err} past {tol}")
            max_abs = (got.float() - want.float()).abs().max().item()
            max_rel = max_abs / want.float().abs().max().item()
        else:
            rtol, atol, norm_err = 1e-4, 1e-4, None
            tol = {"rtol": rtol, "atol": atol}
            max_abs, max_rel = compare(torch, got, want, rtol, atol,
                                       f"decode_layers {model} pos={pos}")
            compare(torch, k1[:, :, pos], k2[:, :, pos], rtol, atol, "new K rows")
            compare(torch, v1[:, :, pos], v2[:, :, pos], rtol, atol, "new V rows")
        others = torch.ones(M, dtype=torch.bool, device="cuda")
        others[pos] = False
        if not (torch.equal(k1[:, :, others], kc[:, :, others])
                and torch.equal(v1[:, :, others], vc[:, :, others])):
            raise AssertionError("decode_layers changed cache rows other than pos")
        reps = reps or (200 if nl * args.dim < 10000 else 20)

        def call():
            return decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)

        # 5 launches a layer, 6 with the max pass of the override
        ms = queued_ms(torch, call, queue_reps(reps, (5 if ct == dt else 6) * nl + 1))
        event_ms = time_ms(torch, call, reps)
        plain_ms = time_ms(torch, lambda: decode_layers_plain(
            layers, x, pos, k2, v2, cos, sin, **kw), min(reps, 20))
        decode_layers.launches = launches  # comparison launches do not count
        mode = decode_mode(layers, ct)
        w_elems = sum(layers[n].numel() for n in ("wqkv", "wo", "wgu", "w_down"))
        # weights, x in and out, the cache rows < pos read and row pos
        # written (in the cache's dtype), the cos/sin rows
        nbytes = (sum(t.numel() * t.element_size() for t in layers.values())
                  + x.element_size() * 2 * args.dim
                  + kc.element_size() * 2 * nl * kvh * hd * (pos + 1) + 4.0 * hd)
        flops = 2.0 * w_elems + 4.0 * nl * args.n_heads * hd * (pos + 1)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_S if half else FP32_FLOP_S)
        row = {"phase": "kernel", "kernel": "decode_layers", "mode": mode, "model": model,
               "shape": {"NL": nl, "D": args.dim, "NH": args.n_heads,
                         "KVH": kvh, "HD": hd, "FD": args.hidden_dim, "M": M,
                         "pos": pos},
               "max_abs_err": max_abs, "max_rel_err": max_rel, "normwise_err": norm_err,
               "tol": tol, "ms": ms, "event_ms": event_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms,
               "library_ms": None, "card": self.card}
        emit(row)
        return row

    def paged_phase(self, model: str, B, NH, KVH, HD, page, maxp, pos_list,
                    Q: int = 4, NL: int = 8, layer: int = 1, over_row: int = 3,
                    quant: bool = False, dtype=None, case: str = "skewed",
                    kv_dtype=None):
        """The paged-attention kernel against its plain twin in its three
        modes (plain, stacked with the current column, window at win_count
        0, 1 and Q), on shuffled block tables with null-page padding, and
        an overrun row; `quant` runs the int8-pool mode (pools, rows and
        window quantized per token and KV head, with their scales) and
        also fills the scale slots no row may read with NaN/inf; `dtype`
        is q's (bf16 or fp16: the 16-bit modes, q, pools and rows in that
        dtype, or with `quant` int8 pools under that q), compared in f32
        within two ulps of the output (bf16 1e-2, fp16 2e-3).  Timing
        rotates over NL layers of pools (more than the 50 MB L2), as a
        decode step's layers find their pools cold.  `ms` is the device
        time per call (the attention kernel and the merge, `queued_ms`);
        `event_ms` the CUDA-event time of back-to-back wrapper calls, which
        the host's enqueue bounds; `bound_share` bound_ms over ms;
        `profiled_us_per_call` the traced device time of the chunk walk and
        of the merge in stacked mode.  `case` names the row lengths (skewed,
        or equal: imbalance apart from staging).  `kv_dtype`: float pools
        and rows of another dtype than q's (the kv_dtype override),
        compared at the tolerance of q's dtype."""
        torch = self.torch
        from llama3np_tpu_torch.ops.core import quantize_kv_rows
        from llama3np_tpu_torch.ops.kernels.paged_attention import (
            paged_attention, paged_attention_plain)

        P = 1 + B * maxp
        bt = (torch.randperm(P - 1, generator=self.g)[: B * maxp] + 1).reshape(B, maxp)
        bt = bt.to(torch.int32)
        for b, p in enumerate(pos_list):  # unused entries -> null page 0
            bt[b, min(p // page + 1, maxp):] = 0
        bt = bt.to("cuda")
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        dt = dtype or torch.float32
        pt = kv_dtype or dt  # the pools' and rows' dtype
        q = self.randn(B, 1, NH, HD, dtype=dt)
        kp = self.randn(NL, P, KVH, page, HD, dtype=pt)
        vp = self.randn(NL, P, KVH, page, HD, dtype=pt)
        ck, cv = self.randn(B, KVH, HD, dtype=pt), self.randn(B, KVH, HD, dtype=pt)
        wk, wv = self.randn(B, KVH, Q, HD, dtype=pt), self.randn(B, KVH, Q, HD, dtype=pt)
        sc = {}
        if quant:
            (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
            (ck, cks), (cv, cvs) = quantize_kv_rows(ck), quantize_kv_rows(cv)
            (wk, wks), (wv, wvs) = quantize_kv_rows(wk), quantize_kv_rows(wv)
            sc = dict(k_scale=ks, v_scale=vs, cur_ks=cks, cur_vs=cvs,
                      win_ks=wks, win_vs=wvs)

        def call(mode, li, p=pos, sc=sc, kp=kp, vp=vp):
            if mode == "plain":
                kw = dict(k_scale=sc["k_scale"][li], v_scale=sc["v_scale"][li]) if sc else {}
                return (q, kp[li], vp[li], bt, p), kw
            kw = dict(layer=li, cur_k=ck, cur_v=cv)
            if sc:
                kw.update(k_scale=sc["k_scale"], v_scale=sc["v_scale"],
                          cur_ks=sc["cur_ks"], cur_vs=sc["cur_vs"])
            if mode.startswith("window"):
                kw.update(win_k=wk, win_v=wv, win_count=int(mode[6:]))
                if sc:
                    kw.update(win_ks=sc["win_ks"], win_vs=sc["win_vs"])
            return (q, kp, vp, bt, p), kw

        def rotate(fn, mode):
            it = itertools.count()

            def run():
                a, kw = call(mode, next(it) % NL)
                return fn(*a, **kw)
            return run

        rtol, atol = half_tol(dt)
        launches = paged_attention.launches
        modes = {}
        for mode in ("plain", "stacked", "window0", "window1", f"window{Q}"):
            a, kw = call(mode, layer)
            got = paged_attention(*a, **kw)
            torch.cuda.synchronize()
            want = paged_attention_plain(*a, **kw)
            max_abs, max_rel = compare(torch, got, want, rtol, atol,
                                       f"paged_attention {model} {mode}")
            held = [min(p if mode != "plain" else p + 1, maxp * page) for p in pos_list]
            extra = 0 if mode == "plain" else 1 + kw.get("win_count", 0)
            cols = sum(held) + B * extra
            pages = sum(-(-h // page) for h in held)
            # K, V (+ scales) a token; q and out; table entries and pos.
            per_token = 2 * KVH * (HD + 4) if quant else 2 * KVH * HD * kp.element_size()
            nbytes = per_token * cols + q.element_size() * 2 * B * NH * HD + 4.0 * (pages + B)
            bound_ms, bound_by = bound(nbytes, 4.0 * NH * HD * cols)
            ms = queued_ms(torch, rotate(paged_attention, mode), 50)
            modes[mode] = {
                "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": ms,
                "event_ms": time_ms(torch, rotate(paged_attention, mode), 50),
                "plain_ms": time_ms(torch, rotate(paged_attention_plain, mode), 5, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                "visible_kv_mb": per_token * cols / 1e6}
        # Device time a call of the chunk walk and of the merge (stacked mode,
        # torch.profiler over 24 calls rotating over the layers, as timed).
        split_us, run = {}, rotate(paged_attention, "stacked")
        for k, ms, n in trace(torch, lambda: [run() for _ in range(24)], top=8)[2]:
            if "paged_attn" in k:
                split_us["merge" if "merge" in k else "walk"] = ms * 1e3 / 24
        # An overrun row (pos past its table) stays in bounds and finite,
        # and leaves the other rows' outputs bit for bit as they were.
        over = pos.clone()
        over[over_row] = maxp * page + 40
        a, kw = call("stacked", layer)
        base = paged_attention(*a, **kw)
        a, kw = call("stacked", layer, over)
        got = paged_attention(*a, **kw)
        torch.cuda.synchronize()
        others = torch.arange(B, device="cuda") != over_row
        if not torch.equal(got[others], base[others]) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"paged_attention {model}: the overrun row changed "
                                 "other rows or is not finite")
        compare(torch, got, paged_attention_plain(*a, **kw), rtol, atol,
                f"paged_attention {model} overrun row")
        if quant:  # slots behind the mask hold NaN/inf scales and garbage values
            wc = Q // 2
            a, kw = call(f"window{wc}", layer)
            clean = paged_attention(*a, **kw)
            bad = {k: v.clone() for k, v in sc.items()}
            kp2, vp2 = kp.clone(), vp.clone()
            bad["k_scale"][:, 0], bad["v_scale"][:, 0] = float("nan"), float("inf")
            kp2[:, 0], vp2[:, 0] = 127, -128
            for b, p in enumerate(pos_list):  # the tail of each row's last page
                for t in range(p, min(-(-p // page) * page, maxp * page)):
                    pid = int(bt[b, t // page])
                    bad["k_scale"][:, pid, :, t % page] = float("nan")
                    bad["v_scale"][:, pid, :, t % page] = float("inf")
                    vp2[:, pid, :, t % page] = 99
            bad["win_ks"][:, :, wc:], bad["win_vs"][:, :, wc:] = float("nan"), float("inf")
            a, kw = call(f"window{wc}", layer, sc=bad, kp=kp2, vp=vp2)
            got = paged_attention(*a, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, clean):
                raise AssertionError(f"paged_attention int8 {model}: masked scale "
                                     "slots changed the output")
        paged_attention.launches = launches  # comparison launches do not count
        mode = dtype_name(dt)
        if quant:
            mode = "int8" if mode == "fp32" else f"int8-{mode}"
        elif pt != dt:
            mode = f"{dtype_name(pt)}-q-{mode}"
        row = {"phase": "kernel", "kernel": "paged_attention", "mode": mode, "model": model,
               "case": case,
               "shape": {"B": B, "NH": NH, "KVH": KVH, "HD": HD, "page": page,
                         "maxp": maxp, "P": P, "pos": pos_list, "Q": Q, "NL": NL},
               "tol": {"rtol": rtol, "atol": atol}, "modes": modes,
               "profiled_us_per_call": split_us,
               "overrun_row_ok": True, "masked_scales_ignored": quant or None,
               "library_ms": None, "card": self.card}
        emit(row)
        return row

    def argmax_phase(self, model: str, w, n_x: int = 16):
        """The greedy head against its plain twin on the model's lm_head w
        [D, VS]: the same token for `n_x` random rows, and for rows whose
        two top columns tie across a strip boundary (the last column of
        strip 0 and the first of strip 1) and, where D is split, across the
        split boundary (the lower column's sum from split 1, the higher's
        from split 0), each summing to exactly 32: the lower one must win.
        `ms` is the device time per call (one launch, `queued_ms`);
        `library_ms` one torch.matmul + torch.argmax (in w's dtype: bf16 or
        fp16 rounds the logits), a yardstick the port never calls."""
        torch = self.torch
        from llama3np_tpu_torch.ops.kernels.greedy_head import (
            argmax_head, argmax_head_plain, head_plan)

        D, VS = w.shape
        launches = argmax_head.launches
        xs = [self.randn(1, D, dtype=torch.bfloat16).to(w.dtype) for _ in range(n_x)]
        got = [int(argmax_head(x, w)[0]) for x in xs]
        want = [int(argmax_head_plain(x, w)[0]) for x in xs]
        if got != want:
            raise AssertionError(f"argmax_head {model}: tokens {got} vs plain {want}")
        cols, _, rows, splits = head_plan(D, VS, w.element_size(),
                                          torch.cuda.get_device_properties(0).multi_processor_count)
        ties = {"strip": (0, 0, cols - 1, cols)}  # rows of the lower and higher 8, columns
        if splits > 1:
            ties["split"] = (rows, 0, 3, 40)
        for what, (r_lo, r_hi, lo, hi) in ties.items():
            tied = w.clone()
            tied[:, [lo, hi]] = 0
            tied[r_lo, lo] = tied[r_hi, hi] = 8.0
            x = xs[0].clone()
            x[0, r_lo] = x[0, r_hi] = 4.0
            tie = (int(argmax_head(x, tied)[0]), int(argmax_head_plain(x, tied)[0]))
            if tie != (lo, lo):
                raise AssertionError(f"argmax_head {model}: tie across a {what} boundary "
                                     f"gave {tie}, expected {lo}")
            del tied
        x = xs[1]
        ms = queued_ms(torch, lambda: argmax_head(x, w), 50)
        event_ms = time_ms(torch, lambda: argmax_head(x, w), 50)
        plain_ms = time_ms(torch, lambda: argmax_head_plain(x, w), 10, warmup=1)
        library_ms = queued_ms(torch, lambda: torch.argmax(torch.matmul(x, w), dim=-1), 50)
        argmax_head.launches = launches  # comparison launches do not count
        half = w.dtype != torch.float32
        nbytes = w.element_size() * (D * VS + D) + 8.0
        bound_ms, bound_by = bound(nbytes, 2.0 * D * VS, BF16_FLOP_S if half else FP32_FLOP_S)
        row = {"phase": "kernel", "kernel": "argmax_head", "mode": dtype_name(w.dtype),
               "model": model, "shape": {"D": D, "VS": VS}, "rows_equal": n_x,
               "grid": {"strips": -(-VS // cols), "splits": splits, "rows": rows},
               "ties_ok": sorted(ties), "max_abs_err": 0.0, "tol": "exact token",
               "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "library_ms": library_ms, "vs_library": ms / library_ms,
               "weights_mb": w.numel() * w.element_size() / 1e6, "card": self.card}
        emit(row)
        return row

    def dot_phase(self, what: str, M: int, K: int, N: int):
        """One plain product (`ops.core._dot`) of a bf16 activation [M, K]
        and weight [K, N] on both of its paths: the tensor-core GEMM
        (16-bit operands, f32 sums, f32 result) against the widened one
        (both operands to f32, an f32 GEMM), within 1e-4 of max |widened|
        (only the order of the f32 sums differs; a 16-bit rounding of the
        sum would show as ~4e-3).  `ms` / `widened_ms`: device time per
        call (`queued_ms`); the bound is the same function's, 16-bit
        operands read once and the f32 result written once, at 3.35 TB/s
        or 989 TFLOP/s; `kernels`: each path's device kernels by name
        (torch.profiler)."""
        torch = self.torch
        from llama3np_tpu_torch.ops import core

        a = self.randn(M, K, dtype=torch.bfloat16)
        b = self.randn(K, N, scale=0.02, dtype=torch.bfloat16)
        calls = dict(core.dot_calls)
        got = core._dot(a, b)
        if core.dot_calls["tensor_core"] != calls["tensor_core"] + 1 or got.dtype != torch.float32:
            raise AssertionError(f"_dot {what}: bf16 x bf16 did not take the "
                                 f"tensor-core path to an f32 result ({got.dtype})")
        want = core._widened_dot(a, b)
        max_abs, max_rel = compare(torch, got, want, 0.0,
                                   1e-4 * want.abs().max().item(), f"_dot {what}")
        _, tc, _ = trace(torch, lambda: core._dot(a, b), top=3)
        _, wide, _ = trace(torch, lambda: core._widened_dot(a, b), top=3)
        reps = 20 if M * N * K < 1e12 else 10
        ms = queued_ms(torch, lambda: core._dot(a, b), reps)
        widened_ms = queued_ms(torch, lambda: core._widened_dot(a, b), reps)
        core.dot_calls.update(calls)  # the timing calls do not count
        nbytes = a.element_size() * (M * K + K * N) + 4.0 * M * N
        bound_ms, bound_by = bound(nbytes, 2.0 * M * N * K, BF16_FLOP_S)
        row = {"phase": "kernel", "kernel": "_dot", "mode": "bf16", "model": what,
               "shape": {"M": M, "K": K, "N": N}, "max_abs_err": max_abs,
               "max_rel_err": max_rel, "tol": "1e-4 of max |widened|",
               "ms": ms, "widened_ms": widened_ms, "speedup": widened_ms / ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "widened_bound_share": bound_ms / widened_ms,
               "kernels": [r["name"] for r in tc["top"]],
               "widened_kernels": [r["name"] for r in wide["top"]], "card": self.card}
        emit(row)
        return row


def trace(torch, fn, top: int = 6):
    """Run `fn` under torch.profiler: device time by kernel (the `top`
    largest) and the device's busy share of the traced window.  Only
    device-side events count.  The profiler's own host overhead lengthens
    the window, so a busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
                         for k, ms, n in rows[:top]]}, rows


def kind(name: str) -> str:
    """The class of a device kernel, for the time splits of the traces: the
    port's kernels by name, GEMMs (cuBLAS, whose Hopper kernels are named
    `nvjet_*`, and CUTLASS), copies and casts (an
    int8 or bf16 weight's conversion to f32 before its matmul is one), and
    the other torch ops."""
    n = name.lower()
    if "paged_attn" in n:
        return "paged_attention"
    if "argmax_head" in n:
        return "argmax_head"
    if "flash_prefill" in n:
        return "flash_prefill"
    if any(k in n for k in ("residual_rmsnorm", "gemv_kernel", "attn_split",
                            "attn_combine", "decode_attn")):  # the fused decode step's kernels
        return "decode_layers"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "sm90", "nvjet")):
        return "gemm"
    if "copy" in n:
        return "copy_cast"
    return "other"


def by_kind(rows) -> dict:
    out = {}
    for name, ms, _ in rows:
        out[kind(name)] = out.get(kind(name), 0.0) + ms
    return out


def profile_phase(torch, model: str, engine, prompt, card: str):
    """Trace the prefill and 8 decode tokens (kernel path) with
    torch.profiler (`trace`), with the device time by kind of kernel."""
    from llama3np_tpu_torch.generate import pad_prompt, prefill_step

    gen = engine._gen
    padded, L = pad_prompt(prompt, engine.args)
    ids = torch.as_tensor(padded, device=engine.device)

    def prefill(cache):
        return prefill_step(engine.params, ids, L, cache, engine.cos,
                            engine.sin, gen.cfg)

    prefill(engine.init_cache(1))  # warm
    cache = engine.init_cache(1)  # allocated outside the traced window
    (tok0, cache), pre, pre_rows = trace(torch, lambda: prefill(cache))
    gen.decode_fn(2)(engine.params, tok0, L, cache, engine.cos, engine.sin)  # warm
    _, dec, dec_rows = trace(torch, lambda: gen.decode_fn(8)(
        engine.params, tok0, L, cache, engine.cos, engine.sin))
    return {"phase": "profile", "model": model, "path": "kernels",
            "prefill": {"bucket": int(ids.shape[1]), **pre,
                        "device_ms_by_kind": by_kind(pre_rows)},
            "decode": {"tokens": 8, "from_pos": L, **dec,
                       "device_ms_by_kind": by_kind(dec_rows)}, "card": card}


def _wrappers():
    from llama3np_tpu_torch.ops.kernels.decode_step import decode_layers
    from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill
    from llama3np_tpu_torch.ops.kernels.greedy_head import argmax_head
    from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
    return {"flash_prefill": flash_prefill, "decode_layers": decode_layers,
            "paged_attention": paged_attention, "argmax_head": argmax_head}


def counters():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counters():
    for fn in _wrappers().values():
        fn.launches = 0

STOP_IDS = (1, 2)


def serve_workload(vocab_size: int, seed: int = 0):
    """12 requests: seeded prompts of 17, 64, 200, 500 and 1000 tokens in
    turn, budgets of 24-48 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = (17, 64, 200, 500, 1000)
    return [(rng.integers(3, vocab_size, size=lens[i % len(lens)]).tolist(),
             int(rng.integers(24, 49))) for i in range(12)]


def solo_streams(engine, workload):
    """Each prompt's greedy stream from `Llama.generate_tokens`, cut at the
    stop ids as the serving engine cuts it."""
    import numpy as np

    out = []
    for prompt, budget in workload:
        toks = engine.generate_tokens(np.array([prompt]), budget).cpu()[0].tolist()
        cut = next((i for i, t in enumerate(toks) if t in STOP_IDS), len(toks))
        out.append(toks[:cut])
    return out


def serve(torch, engine, workload, quantum: int, admit_chunk=None,
          kv_quant=None, adapters=None, assign=None):
    """Serve `workload` through a paged BatchEngine (capacity 8, page 16):
    6 requests at once, then 2 more after every 3 steps, so some queue;
    then drain.  Returns the streams and the run's counts and times.  The
    admission time (prefill, fenced) is kept apart from the decode time.
    With `adapters`, request i decodes through adapter assign[i] (None:
    the base model)."""
    from llama3np_tpu_torch.serving import BatchEngine

    be = BatchEngine(engine, capacity=8, paged=True, page_size=16,
                     admit_chunk=admit_chunk, kv_quant=kv_quant, adapters=adapters)
    st = {"decode_steps": 0, "step_calls": 0, "admissions": 0, "admit_s": 0.0}
    step, prefill_into = be.step, be._prefill_into

    def counted_step(quantum=1):  # chunked admission steps from inside too
        if be.num_active:
            st["decode_steps"] += quantum
            st["step_calls"] += 1
        return step(quantum)

    def timed_prefill(slot, req):
        t0 = time.perf_counter()
        prefill_into(slot, req)
        torch.cuda.synchronize()
        st["admissions"] += 1
        st["admit_s"] += time.perf_counter() - t0

    be.step, be._prefill_into = counted_step, timed_prefill

    def submit(i):
        return be.submit(*workload[i], stop_ids=STOP_IDS,
                         adapter=None if assign is None else assign[i])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(i) for i in range(6)]
    calls = 0
    while be.num_active or be._queue or len(reqs) < len(workload):
        if calls and calls % 3 == 0 and len(reqs) < len(workload):
            reqs += [submit(i) for i in range(len(reqs), min(len(reqs) + 2, len(workload)))]
        be.step(quantum)
        calls += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if be.allocator.available != be.allocator.num_pages - 1:
        raise AssertionError(f"pages leaked: {be.allocator.available} of "
                             f"{be.allocator.num_pages - 1} free")
    decode_s = wall - st["admit_s"]
    tokens = sum(len(r.generated) for r in reqs) - len(reqs)  # less admissions' first tokens
    del be
    return [r.generated for r in reqs], {
        "quantum": quantum, "admit_chunk": admit_chunk, "kv_quant": kv_quant,
        "requests": len(reqs),
        "decode_steps": st["decode_steps"], "admissions": st["admissions"],
        "decode_tokens": tokens, "wall_s": wall, "admit_s": st["admit_s"],
        "decode_s": decode_s, "served_tok_s": tokens / decode_s,
        "ms_per_step": decode_s * 1e3 / max(st["decode_steps"], 1)}


def serve_profile_phase(torch, model: str, engine, workload, card: str, steps: int = 4,
                        kv_quant=None):
    """Trace `steps` serving steps at B=8 (quantum 1) with torch.profiler,
    and split device time by kind of kernel (`kind`: GEMMs, the
    paged-attention kernel, copies and casts, the other torch ops: norms,
    RoPE, SwiGLU, residuals, embedding, argmax)."""
    from llama3np_tpu_torch.serving import BatchEngine

    be = BatchEngine(engine, capacity=8, paged=True, page_size=16, kv_quant=kv_quant)
    for p, _ in workload[:8]:
        be.submit(p, 400, stop_ids=())
    be.step()
    be.step()  # warm
    _, win, rows = trace(torch, lambda: [be.step() for _ in range(steps)], top=8)
    pos = be.pos.tolist()
    del be

    split = by_kind(rows)
    dev = sum(split.values()) or 1.0
    return {"phase": "profile", "model": model, "path": "serving", "batch": 8,
            "kv_quant": kv_quant, "steps": steps, "pos_after": pos, **win,
            "device_ms_by_kind": split,
            "device_share_by_kind": {k: v / dev for k, v in split.items()},
            "card": card}


# Every tinyllama-1.1b path runs at its full width and this many of its 22
# layers: at full depth the whole script outran its 1200 s limit on a
# slower host (1,319 s, the build 95 s of it, on an H100 80GB HBM3 at
# 700 W), where the same script took 978 s on another.
TINY_LAYERS = 8


def grid_weights(torch, weights, qmax: int = 127):
    """Weights snapped onto an int8 grid (qmax 127; int4: 7) per output
    channel (the rule of tests/test_quant.py:27-41 and
    tests/test_int4.py:27-39), computed on the card: quantization then
    round-trips, so the int8 or int4 engine computes the fp32 engine's
    numbers."""
    out = {}
    for k, v in weights.items():
        if v.ndim == 2:
            w = torch.from_numpy(v).to("cuda")
            sc = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / qmax, min=1e-12)
            v = (torch.clamp(torch.round(w / sc), -qmax, qmax) * sc).cpu().numpy()
        out[k] = v
    return out


def plain_twin(engine):
    """The engine with its kernels off (the plain path: attn_impl="xla"),
    sharing its weights on the card."""
    import copy

    twin = copy.copy(engine)
    twin.cfg = engine.cfg._replace(kernels=False)
    twin._gen = None
    twin.cache = engine.init_cache()
    return twin


def solo_serve(engine, workload, kv_quant, margins: bool = False, adapters=None,
               assign=None):
    """Each request's stream from a capacity-1 paged engine (the
    schedule-independence rule of tests/test_kv_quant.py:160-178); with
    `margins`, also each token's top-2 logit margin (the difference of the
    top two log-probabilities), for the near-tie rule.  With `adapters`,
    request i through adapter assign[i]."""
    from llama3np_tpu_torch.serving import BatchEngine

    out, gaps = [], []
    for i, (prompt, budget) in enumerate(workload):
        be = BatchEngine(engine, capacity=1, paged=True, page_size=16,
                         kv_quant=kv_quant, logprobs=2 if margins else None,
                         adapters=adapters)
        req = be.submit(prompt, budget, stop_ids=STOP_IDS,
                        logprobs=2 if margins else None,
                        adapter=None if assign is None else assign[i])
        be.run_to_completion()
        out.append(req.generated)
        gaps.append([top[0][1] - top[1][1] for top in req.top_logprobs])
    return (out, gaps) if margins else out


def first_diff(a, b) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def near_tie(got, want, margin_at, limit: float, what: str) -> dict:
    """The bf16 stream rule: `got` equals `want`, or the first token where
    they differ is a near-tie of the reference path: its top-2 logit
    margin there (`margin_at(i)`) is under `limit` (twice the measured
    logits max-abs error between the two paths).  A stream that stops
    early must be a prefix of the other at the stop."""
    i = first_diff(got, want)
    if i == len(got) == len(want):
        return {"equal_tokens": i, "first_diff": None, "margin": None}
    if i == min(len(got), len(want)):
        raise AssertionError(f"{what}: one stream stops at {i}, the other goes on")
    margin = margin_at(i)
    if not margin < limit:
        raise AssertionError(f"{what}: diverges at token {i} where the reference's top-2 "
                             f"margin is {margin}, not under {limit}")
    return {"equal_tokens": i, "first_diff": i, "margin": margin}


class CardWeights:
    """HF-schema weights of `args` made on the card, each when the loader
    asks for it and handed over as a host float32 numpy array, as a
    checkpoint's would be: normal x 0.02, norms 1 + that (as
    `synthetic_weights` draws them), each from its own seeded card
    generator, so the order of the loader's requests does not matter."""

    def __init__(self, torch, args, seed: int = 0, scale: float = 0.02):
        self.torch, self.seed, self.scale = torch, seed, scale
        d, fd, vs = args.dim, args.hidden_dim, args.vocab_size
        qd, kvd = args.n_heads * args.head_dim, args.kv_heads * args.head_dim
        self.shapes = {"model.embed_tokens.weight": (vs, d),
                       "model.norm.weight": (d,), "lm_head.weight": (vs, d)}
        for i in range(args.n_layers):
            p = f"model.layers.{i}"
            self.shapes.update({
                f"{p}.self_attn.q_proj.weight": (qd, d),
                f"{p}.self_attn.k_proj.weight": (kvd, d),
                f"{p}.self_attn.v_proj.weight": (kvd, d),
                f"{p}.self_attn.o_proj.weight": (d, qd),
                f"{p}.mlp.gate_proj.weight": (fd, d),
                f"{p}.mlp.up_proj.weight": (fd, d),
                f"{p}.mlp.down_proj.weight": (d, fd),
                f"{p}.input_layernorm.weight": (d,),
                f"{p}.post_attention_layernorm.weight": (d,)})

    def keys(self):
        return self.shapes.keys()

    def __getitem__(self, key):
        import zlib

        torch = self.torch
        g = torch.Generator("cuda").manual_seed(self.seed * 1_000_003 + zlib.crc32(key.encode()))
        w = torch.randn(self.shapes[key], generator=g, device="cuda") * self.scale
        if key.endswith("norm.weight"):
            w += 1.0
        return w.cpu().numpy()


# llama3-8b: the kernel path against the plain path, both bf16 with other
# rounding points (the kernels follow the streamed TPU layout's, the plain
# path the XLA layer scan's), whose differences compound over 32 layers:
# the repo's bf16 envelope, tests/test_dtype.py's 0.15 x max(1, max
# |logits|).
E8B_ENVELOPE = 0.15
# float16 models (tinyllama-1.1b): tests/test_dtype.py's fp16 envelope,
# 0.02 x max(1, max |logits|); int8 weights under fp16 activations round
# the activation to bf16 before each int8 product on the kernel path (the
# TPU kernel's `_wdot`) and not on the plain path, so they take the bf16
# envelope above.
F16_ENVELOPE = 0.02
# The paged kernel's skewed row mix at llama3-8b (8 rows, 16-token pages,
# tables of 512 pages).
SKEWED_8B = [0, 15, 16, 255, 500, 1023, 4000, 8191]


def pool_capacity(torch, eng, card, max_len: int = 8192):
    """The paged pool's bytes a token for the engine's float KV and for
    int8 KV, measured from allocated pools (`init_paged_cache`, 64 pages
    of 16: K, V and, in int8, their f32 scales, every layer), and how many
    `max_len`-token rows each fits in the card's free memory with the
    engine loaded (its weights and its batch-1 dense cache)."""
    from llama3np_tpu_torch.kvcache import init_paged_cache

    per_token = {}
    for kv_quant in (None, "int8"):
        pools = init_paged_cache(eng.args, 64, 16, quant=kv_quant, device="cuda")
        nbytes = sum(t.numel() * t.element_size() for t in pools.values())
        per_token[kv_quant or eng.args.kv_dtype] = nbytes / (64 * 16)
        del pools
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {"phase": "pool_capacity", "model": "llama3-8b", "pool_bytes_per_token": per_token,
            "free_gb": free / 1e9, "total_gb": total / 1e9,
            "device_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "row_tokens": max_len,
            "rows_that_fit": {k: int(free // (v * max_len)) for k, v in per_token.items()},
            "card": card}


def serve_vs_solo(torch, model: str, eng, workload, runs, limit, card, kv_quant=None,
                  timings=None, **tags):
    """Paged serving of `workload` (`serve`) at each (run, quantum) of
    `runs`, every stream against its capacity-1 stream (`solo_serve`) by
    the near-tie rule under `limit` (0: equal streams); exact launch
    counts (flash once a layer an admission, the paged kernel once a layer
    a decode step), all pages back.  Returns each run's launch counts;
    `timings`, a dict, takes each run's counts and times."""
    nl = eng.args.n_layers
    solo, gaps = solo_serve(eng, workload, kv_quant, margins=True)
    out = {}
    for run, quantum in runs:
        reset_counters()  # the main path: serving through the kernels
        streams, st = serve(torch, eng, workload, quantum, kv_quant=kv_quant)
        counts = counters()
        what = f"{model} serving {run} kv_quant={kv_quant}"
        rules = [near_tie(g, w, lambda i, m=m: m[i], limit, f"{what} request {r}")
                 for r, (g, w, m) in enumerate(zip(streams, solo, gaps))]
        expect = {"flash_prefill": nl * st["admissions"], "decode_layers": 0,
                  "paged_attention": nl * st["decode_steps"], "argmax_head": 0}
        if counts != expect or st["admissions"] != len(workload):
            raise AssertionError(f"{what} launch counts {counts}, expected {expect} "
                                 f"({st['admissions']} admissions)")
        out[run] = counts
        if timings is not None:
            timings[run] = st
        emit({"phase": "e2e", "model": model, "path": "serving", **tags, "run": run, **st,
              "launches": counts,
              "streams_equal_solo": sum(r["first_diff"] is None for r in rules),
              "near_ties": [dict(request=i, **r) for i, r in enumerate(rules)
                            if r["first_diff"] is not None],
              "near_tie_limit": limit, "pages_leaked": 0, "card": card})
    return out


def generate_vs_plain(torch, model: str, eng, prompt, n_tok: int, envelope: float,
                      card, **tags):
    """Greedy generation through the kernels against the plain path on the
    same weights: exact launch counts (flash once a layer, the decode
    kernel and, for a float lm_head, the greedy head once a token after
    the first); last-prompt logits finite, within `envelope` x max(1, max
    |logits|) of the plain path's, top-1 equal; the stream equal or parted
    at a near-tie under twice the logits' max-abs error.  Returns the
    launch counts and the near-tie limit."""
    import numpy as np

    from llama3np_tpu_torch.observability import timed_generate

    nl = eng.args.n_layers
    reset_counters()  # the main path: greedy generation through the kernels
    toks_k = eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    counts = counters()
    expect = {"flash_prefill": nl, "decode_layers": n_tok - 1, "paged_attention": 0,
              "argmax_head": 0 if "lm_head_scale" in eng.params else n_tok - 1}
    if counts != expect:
        raise AssertionError(f"{model} {tags} launch counts {counts}, expected {expect}")
    logits_k = torch.from_numpy(eng(prompt, 0))
    twin = plain_twin(eng)
    toks_x = twin.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    logits_x = torch.from_numpy(twin(prompt, 0))
    if not torch.isfinite(logits_k).all():
        raise AssertionError(f"non-finite {model} {tags} logits")
    l_abs = (logits_k - logits_x).abs().max().item()
    l_scale = max(1.0, logits_x.abs().max().item())
    if l_abs > envelope * l_scale or \
            int(logits_k[0, -1].argmax()) != int(logits_x[0, -1].argmax()):
        raise AssertionError(f"{model} {tags} kernel vs plain logits: max abs err {l_abs} "
                             f"(envelope {envelope * l_scale}) or top-1 differs")
    limit = 2 * l_abs

    def plain_margin(i):  # the plain path's top-2 margin before token i
        ctx = np.array([prompt[0].tolist() + toks_x[:i]])
        top = torch.from_numpy(twin(ctx, 0))[0, -1].float().topk(2).values
        return float(top[0] - top[1])

    rule = near_tie(toks_k, toks_x, plain_margin, limit, f"{model} {tags} greedy stream")
    k_stats = timed_generate(eng, prompt, 64)[1]
    x_stats = timed_generate(twin, prompt, 64)[1]
    emit({"phase": "e2e", "model": model, **tags, "prompt_tokens": int(prompt.shape[1]),
          "launches": counts, "stream_vs_plain": rule, "near_tie_limit": limit,
          "logits_max_abs_err": l_abs, "logits_max_abs": l_scale,
          "logits_envelope": envelope * l_scale,
          "kernels": {"prefill_ms": k_stats.prefill_ms, "decode_tok_s": k_stats.decode_tok_s},
          "plain": {"prefill_ms": x_stats.prefill_ms, "decode_tok_s": x_stats.decode_tok_s},
          "timed_tokens": 64, "card": card})
    del twin
    torch.cuda.empty_cache()
    return counts, limit


# The sampling policy the sampled phases draw with.
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=0)


def sampled_vs_plain(torch, model: str, eng, prompt, n_tok: int, card, **tags):
    """Sampled generation (T 0.8, top-p 0.9, seed 0) through the kernels
    (`kernel_sampled_decode_steps`: the decode kernel, then the plain
    logits and the sampler) against the plain path on the same card.  The
    streams must be equal, or first part at a near-tie of the perturbed
    logits (logits / T, masked, plus the Gumbel noise of that token's key:
    `generate.sample_scores`) of the plain path: their top-2 margin there
    under twice the logits' max-abs error over T.  Temperature 0 must give
    the greedy kernel stream, and the same seed twice the same stream.
    Exact launch counts: flash once a layer, the decode kernel once a token
    after the first, the greedy head never.  Returns the launch counts."""
    import numpy as np

    from llama3np_tpu_torch.generate import Sampling, decode_keys, sample_scores
    from llama3np_tpu_torch.observability import timed_generate

    nl, pol = eng.args.n_layers, Sampling(**SAMPLED)
    reset_counters()  # the main path: sampled generation through the kernels
    toks_k = eng.generate_tokens(prompt, n_tok, sampling=pol).cpu()[0].tolist()
    counts = counters()
    expect = {"flash_prefill": nl, "decode_layers": n_tok - 1, "paged_attention": 0,
              "argmax_head": 0}
    if counts != expect:
        raise AssertionError(f"{model} {tags} sampled launch counts {counts}, expected {expect}")
    again = eng.generate_tokens(prompt, n_tok, sampling=pol).cpu()[0].tolist()
    if again != toks_k:
        raise AssertionError(f"{model} {tags}: the same seed drew another stream")
    greedy = eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    t0 = eng.generate_tokens(prompt, n_tok, sampling=Sampling(temperature=0.0)).cpu()[0].tolist()
    if t0 != greedy:
        raise AssertionError(f"{model} {tags}: temperature 0 is not the greedy stream")
    twin = plain_twin(eng)
    toks_x = twin.generate_tokens(prompt, n_tok, sampling=pol).cpu()[0].tolist()
    logits_k = torch.from_numpy(eng(prompt, 0))
    logits_x = torch.from_numpy(twin(prompt, 0))
    l_abs = (logits_k - logits_x).abs().max().item()
    limit = 2 * l_abs / pol.temperature
    keys = decode_keys(pol, n_tok - 1, prompt.shape[1], eng.args.max_seq_len)

    def perturbed_margin(i):  # the plain path's perturbed top-2 margin at token i
        ctx = np.array([prompt[0].tolist() + toks_x[:i]])
        logits = torch.from_numpy(twin(ctx, 0))[:, -1].float()
        top = sample_scores(logits, keys[i], pol)[0].topk(2).values
        return float(top[0] - top[1])

    rule = near_tie(toks_k, toks_x, perturbed_margin, limit,
                    f"{model} {tags} sampled stream")
    k_stats = timed_generate(eng, prompt, 64, sampling=pol)[1]
    g_stats = timed_generate(eng, prompt, 64)[1]
    emit({"phase": "e2e", "model": model, "path": "sampled", **tags, "policy": SAMPLED,
          "prompt_tokens": int(prompt.shape[1]), "tokens": n_tok, "launches": counts,
          "stream_vs_plain": rule, "near_tie_limit": limit, "logits_max_abs_err": l_abs,
          "same_seed_same_stream": True, "temperature0_equals_greedy": True,
          "sampled": {"prefill_ms": k_stats.prefill_ms, "decode_tok_s": k_stats.decode_tok_s},
          "greedy": {"prefill_ms": g_stats.prefill_ms, "decode_tok_s": g_stats.decode_tok_s},
          "timed_tokens": 64, "card": card})
    del twin
    torch.cuda.empty_cache()
    return counts


def sampled_step_phase(torch, model: str, eng, workload, card, steps: int = 8):
    """A serving decode step at B=8 (quantum 1) with every row greedy, then
    with every row sampled (T 0.8, top-p 0.9: fold_row_keys, the Gumbel
    threefry over [8, VS] and the masks, in plain torch ops): host ms a
    step (fenced), and device kernels a step from a traced step."""
    from llama3np_tpu_torch.serving import BatchEngine

    out = {}
    for mode, temp in (("greedy", 0.0), ("sampled", SAMPLED["temperature"])):
        be = BatchEngine(eng, capacity=8, paged=True, page_size=16, top_p=SAMPLED["top_p"])
        for p, _ in workload[:8]:
            be.submit(p, 400, stop_ids=(), temperature=temp)
        be.step()
        be.step()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            be.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        _, win, rows = trace(torch, be.step)
        out[mode] = {"ms_per_step": ms, "device_kernels_per_step": sum(n for _, _, n in rows),
                     "device_ms_per_step": win["device_ms"]}
        del be
    emit({"phase": "e2e", "model": model, "path": "serving-sampled-step", "batch": 8,
          "policy": SAMPLED, **out,
          "extra_kernels_per_step": out["sampled"]["device_kernels_per_step"]
          - out["greedy"]["device_kernels_per_step"],
          "extra_ms_per_step": out["sampled"]["ms_per_step"] - out["greedy"]["ms_per_step"],
          "card": card})


def prefix_workload(vocab_size: int, seed: int = 1):
    """8 requests sharing a 2,048-token prefix, each with its own 64-token
    suffix and a budget of 16 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head = rng.integers(3, vocab_size, size=2048).tolist()
    return [(head + rng.integers(3, vocab_size, size=64).tolist(), 16) for _ in range(8)]


def prefix_run(torch, eng, workload, prefix_cache: bool, kv_quant=None, turn2=None):
    """Serve `workload` through a paged engine (capacity 8, page 16, top-2
    logprobs), then one more request: a second turn that extends request
    0's conversation by 32 tokens (`turn2`, or made here from its reply).
    Each admission is timed, fenced.  Returns (streams, top-2 margins,
    the turn-2 prompt, stats)."""
    import numpy as np

    from llama3np_tpu_torch.serving import BatchEngine

    be = BatchEngine(eng, capacity=8, paged=True, page_size=16, logprobs=2,
                     prefix_cache=prefix_cache, kv_quant=kv_quant)
    admit = []
    prefill_into = be._prefill_into

    def timed_prefill(slot, req):
        t0 = time.perf_counter()
        prefill_into(slot, req)
        torch.cuda.synchronize()
        admit.append(time.perf_counter() - t0)

    be._prefill_into = timed_prefill
    reset_counters()
    reqs = [be.submit(p, n, stop_ids=STOP_IDS, logprobs=2) for p, n in workload]
    steps = 0
    while be.num_active or be._queue:
        be.step(1)
        steps += 1
    if turn2 is None:
        rng = np.random.default_rng(2)
        turn2 = workload[0][0] + reqs[0].generated + \
            rng.integers(3, eng.args.vocab_size, size=32).tolist()
    reqs.append(be.submit(turn2, 16, stop_ids=STOP_IDS, logprobs=2))
    while be.num_active or be._queue:
        be.step(1)
        steps += 1
    counts = counters()
    stats = be.prefix_stats
    nl = eng.args.n_layers
    cold = len(reqs) - (stats["hits"] if stats else 0)
    expect = {"flash_prefill": nl * cold, "decode_layers": 0,
              "paged_attention": nl * steps, "argmax_head": 0}
    if counts != expect:
        raise AssertionError(f"prefix run (cache {prefix_cache}, kv {kv_quant}) launch "
                             f"counts {counts}, expected {expect}")
    held = len(be._registry) if prefix_cache else 0
    if be.allocator.available + held != be.allocator.num_pages - 1:
        raise AssertionError("prefix run: pages leaked before clear")
    if prefix_cache:
        be._registry.clear(be.allocator)
    if be.allocator.available != be.allocator.num_pages - 1:
        raise AssertionError("prefix run: pages not all back after clear")
    margins = [[t[0][1] - t[1][1] for t in r.top_logprobs] for r in reqs]
    del be
    return [r.generated for r in reqs], margins, turn2, {
        "prefix_stats": stats, "admissions": len(admit), "admit_s": sum(admit),
        "admit_s_first": admit[0], "admit_s_rest_mean": sum(admit[1:]) / (len(admit) - 1),
        "decode_steps": steps, "launches": counts, "cached_pages_cleared": held}


def prefix_phase(torch, eng, limit, card, kv_quant=None):
    """llama3-8b, paged, page 16: 8 requests sharing a 2,048-token prefix
    (then a second turn of request 0) with the prefix cache, against the
    same traffic admitted cold; every stream equal to its cold one or
    parted at a near-tie (the cold run's top-2 margin under `limit`),
    hits above 0, every page back after clear.  Returns the cached run's
    launch counts."""
    workload = prefix_workload(eng.args.vocab_size)
    hot, _, turn2, st_hot = prefix_run(torch, eng, workload, True, kv_quant)
    cold, gaps, _, st_cold = prefix_run(torch, eng, workload, False, kv_quant, turn2)
    if not st_hot["prefix_stats"]["hits"] > 0:
        raise AssertionError(f"prefix run (kv {kv_quant}): no hits {st_hot['prefix_stats']}")
    what = f"llama3-8b prefix kv_quant={kv_quant}"
    rules = [near_tie(h, c, lambda i, m=m: m[i], limit, f"{what} request {r}")
             for r, (h, c, m) in enumerate(zip(hot, cold, gaps))]
    emit({"phase": "e2e", "model": "llama3-8b", "path": "prefix-cache", "kv_quant": kv_quant,
          "requests": len(hot), "prefix_tokens": 2048, "suffix_tokens": 64,
          "turn2_prompt_tokens": len(turn2), "cached": st_hot, "cold": st_cold,
          "streams_equal_cold": sum(r["first_diff"] is None for r in rules),
          "near_ties": [dict(request=i, **r) for i, r in enumerate(rules)
                        if r["first_diff"] is not None],
          "near_tie_limit": limit, "pages_leaked": 0, "card": card})
    return st_hot["launches"]


def http_call(port: int, path: str, body=None, stream: bool = False):
    """One request to the server on 127.0.0.1:port: (status, JSON body)
    or, streamed, (status, SSE events, seconds to the first token event,
    seconds to the end)."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=180)
    if body is None:
        c.request("GET", path)
    else:
        c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    if not stream:
        data = r.read()
        c.close()
        return r.status, (json.loads(data) if data.startswith(b"{") else data.decode())
    events, buf, t_first = [], b"", None
    while True:
        data = r.read1(65536)
        if not data:
            break
        buf += data
        while b"\n\n" in buf:
            raw, buf = buf.split(b"\n\n", 1)
            text = raw.decode()[len("data: "):]
            if text != "[DONE]":
                ev = json.loads(text)
                if t_first is None and ev.get("choices"):
                    t_first = time.perf_counter() - t0
                events.append(ev)
    c.close()
    return r.status, events, t_first, time.perf_counter() - t0


def server_phase(torch, eng, limit, card):
    """The HTTP server (`llama3np_tpu_torch.server.serve`) around a paged,
    prefix-caching BatchEngine on the loaded llama3-8b (quantum 4), on
    127.0.0.1 with an ephemeral port, with a tokenizer over a 128,256-entry
    vocabulary made from a seed.  8 client threads stream greedy
    completions (ids) at once, then one streamed and one whole completion
    of the same prompt, a two-turn chat, and sampled requests.  The
    greedy streams must equal their capacity-1 streams (near-tie rule),
    the streamed response the whole one (the same rule, the whole one's
    margins), /stats must show prefix hits, /metrics parse, and every page
    come back.  Reports requests/s, time to first token and ms per token
    of the 8 concurrent requests, and the launch counts."""
    import threading

    import numpy as np

    from llama3np_tpu_torch import Tokenizer
    from llama3np_tpu_torch.server import serve as http_serve
    from llama3np_tpu_torch.serving import BatchEngine

    vocab = synthetic_vocab(os.path.join(REPO, "build", "smoke", "vocab128k.json"),
                            eng.args.vocab_size)
    tok = Tokenizer(vocab)
    rng = np.random.default_rng(3)
    work = [([1] + rng.integers(3, eng.args.vocab_size, size=int(n)).tolist(), 24)
            for n in (40, 300, 120, 700, 60, 250, 500, 90)]
    solo, gaps = solo_serve(eng, work, None, margins=True)  # before the server runs
    be = BatchEngine(eng, capacity=8, paged=True, page_size=16, prefix_cache=True,
                     logprobs=2)
    srv = http_serve(be, tok, "127.0.0.1", 0, quantum=4)
    port = srv.server_address[1]
    torch.cuda.synchronize()
    reset_counters()  # the main path: the server's engine thread
    try:
        results = [None] * len(work)

        def client(i):
            results[i] = http_call(port, "/v1/completions",
                                   {"prompt_ids": work[i][0], "max_tokens": work[i][1],
                                    "stream": True}, stream=True)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise AssertionError("server: a concurrent request never completed")
        streams, ttft, per_tok = [], [], []
        for status, events, t_first, t_end in results:
            if status != 200 or t_first is None:
                raise AssertionError(f"server: a streamed request failed ({status})")
            ids = [t for e in events for t in e["choices"][0]["token_ids"]]
            streams.append(ids)
            ttft.append(t_first)
            per_tok.append((t_end - t_first) * 1e3 / max(len(ids) - 1, 1))
        rules = [near_tie(g, w, lambda i, m=m: m[i], limit, f"server request {r}")
                 for r, (g, w, m) in enumerate(zip(streams, solo, gaps))]
        # One prompt streamed, then whole (it hits the prefix cache).
        body = {"prompt_ids": work[3][0], "max_tokens": 24, "logprobs": 2}
        status, events, _, _ = http_call(port, "/v1/completions", {**body, "stream": True},
                                         stream=True)
        status2, whole = http_call(port, "/v1/completions", body)
        if status != 200 or status2 != 200:
            raise AssertionError(f"server: streamed/whole request failed ({status}, {status2})")
        s_ids = [t for e in events for t in e["choices"][0]["token_ids"]]
        w_choice = whole["choices"][0]
        w_gaps = [t[0]["logprob"] - t[1]["logprob"]
                  for t in w_choice["logprobs"]["top_logprobs"]]
        stream_rule = near_tie(s_ids, w_choice["token_ids"], lambda i: w_gaps[i], limit,
                               "server streamed vs whole")
        s_text = "".join(e["choices"][0]["text"] for e in events)
        if stream_rule["first_diff"] is None and s_text != w_choice["text"]:
            raise AssertionError("server: the streamed text is not the whole text")
        # A two-turn chat: the second turn's prompt extends the first's.
        turn1 = [{"role": "user", "content": "once upon a time there was a little cat who "
                                             "lived in a house by the sea and loved fish"}]
        status, r1 = http_call(port, "/v1/chat/completions", {"messages": turn1,
                                                              "max_tokens": 16})
        turn2 = turn1 + [r1["choices"][0]["message"],
                         {"role": "user", "content": "what happened next?"}]
        hits0 = http_call(port, "/stats")[1]["prefix_cache"]["hits"]
        status2, r2 = http_call(port, "/v1/chat/completions", {"messages": turn2,
                                                               "max_tokens": 16})
        stats = http_call(port, "/stats")[1]
        if status != 200 or status2 != 200 or not stats["prefix_cache"]["hits"] > hits0:
            raise AssertionError(f"server chat: {status} {status2}, prefix stats "
                                 f"{stats['prefix_cache']} (hits before turn 2: {hits0})")
        # Sampled requests: two choices of one prompt, and a chat.
        status, sampled = http_call(port, "/v1/completions",
                                    {"prompt_ids": work[0][0], "max_tokens": 16, "n": 2,
                                     "temperature": 0.8, "stop_ids": []})
        status2, s_chat = http_call(port, "/v1/chat/completions",
                                    {"messages": turn1, "max_tokens": 8, "temperature": 0.8})
        draws = [c["token_ids"] for c in sampled["choices"]] if status == 200 else []
        if status != 200 or status2 != 200 or [len(d) for d in draws] != [16, 16] or \
                not all(0 <= t < eng.args.vocab_size for d in draws for t in d):
            raise AssertionError(f"server sampled requests: {status} {status2} {draws}")
        status, metrics = http_call(port, "/metrics")
        parsed = {}
        for line in metrics.splitlines():
            if line and not line.startswith("#"):
                k, v = line.split()
                parsed[k] = float(v)
        if status != 200 or parsed.get("llama3np_prefix_hits_total", 0) < 1:
            raise AssertionError(f"server /metrics: {status} {metrics[:400]}")
    finally:
        srv.shutdown()
        srv.loop.shutdown()
        srv.server_close()
    torch.cuda.synchronize()
    counts = counters()
    if not (counts["flash_prefill"] and counts["paged_attention"]) or \
            counts["decode_layers"] or counts["argmax_head"]:
        raise AssertionError(f"server launch counts {counts}")
    held = len(be._registry)
    if be.allocator.available + held != be.allocator.num_pages - 1:
        raise AssertionError("server: pages leaked")
    be._registry.clear(be.allocator)
    if be.allocator.available != be.allocator.num_pages - 1:
        raise AssertionError("server: pages not all back after clear")
    emit({"phase": "e2e", "model": "llama3-8b", "path": "server", "quantum": 4,
          "concurrent_requests": len(work), "prompt_tokens": [len(p) for p, _ in work],
          "max_tokens": 24, "wall_s": wall, "requests_per_s": len(work) / wall,
          "ttft_s": ttft, "ttft_s_mean": sum(ttft) / len(ttft),
          "ms_per_token": per_tok, "ms_per_token_mean": sum(per_tok) / len(per_tok),
          "streams_equal_solo": sum(r["first_diff"] is None for r in rules),
          "near_ties": [dict(request=i, **r) for i, r in enumerate(rules)
                        if r["first_diff"] is not None],
          "near_tie_limit": limit, "stream_vs_whole": stream_rule,
          "chat_turn2_prompt_tokens": r2["usage"]["prompt_tokens"],
          "prefix_stats": stats["prefix_cache"], "served_requests": stats["served_requests"],
          "engine_steps": stats["engine_steps"], "launches": counts,
          "metrics_parsed": len(parsed), "cached_pages_cleared": held, "pages_leaked": 0,
          "card": card})
    del be
    torch.cuda.empty_cache()
    return counts


def llama3_8b_phases(torch, smoke, card):
    """llama3-8b at full width in bf16: the engine's own loader over weights
    made on the card, the four kernels' bf16 modes against their twins at
    its shapes, greedy generation through them against the plain path (the
    near-tie rule), and paged serving at quanta 1 and 4 against capacity-1
    streams (the same rule).  Returns the kernel rows and the launch counts
    of each path, for the summary."""
    import resource

    import numpy as np

    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.models.llama import Llama

    args = preset("llama3-8b")
    nl, bf16 = args.n_layers, torch.bfloat16
    t0 = time.perf_counter()
    eng = Llama(CardWeights(torch, args), args, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "load", "model": "llama3-8b", "layers": nl, "dtype": args.dtype,
          "seconds": time.perf_counter() - t0,
          "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "weights_gb": sum(t.numel() * t.element_size() for t in eng.params["layers"].values()) / 1e9,
          "device_allocated_gb": torch.cuda.memory_allocated() / 1e9, "card": card})

    rows = {"argmax_head": smoke.argmax_phase("llama3-8b", eng.params["lm_head"])}
    emit(head_alternation(torch, smoke, "llama3-8b", eng.params["lm_head"]))
    shape = (args.n_heads, args.kv_heads, args.head_dim)
    rows["flash_prefill"] = smoke.flash_phase("llama3-8b", 1, 512, *shape, dtype=bf16)
    smoke.flash_phase("llama3-8b", 1, 500, *shape, dtype=bf16)
    smoke.decode_phase("llama3-8b", eng.params["layers"], args, 0)
    rows["decode_layers"] = smoke.decode_phase("llama3-8b", eng.params["layers"], args, 511)
    smoke.decode_phase("llama3-8b", eng.params["layers"], args, 8191)
    rows["paged_attention"] = smoke.paged_phase(
        "llama3-8b", 8, *shape, 16, 512, SKEWED_8B, dtype=bf16)
    smoke.paged_phase("llama3-8b", 8, *shape, 16, 512, [4096] * 8, dtype=bf16, case="equal")
    # int8 pools under a bf16 q: the 8B int8-KV serving cell's kernel mode.
    rows["paged_attention_i8"] = smoke.paged_phase(
        "llama3-8b", 8, *shape, 16, 512, SKEWED_8B, quant=True, dtype=bf16)
    smoke.paged_phase("llama3-8b", 8, *shape, 16, 512, [4096] * 8, quant=True, dtype=bf16,
                      case="equal")
    torch.cuda.empty_cache()

    # Greedy generation: the main path through the four kernels.
    prompt = np.random.default_rng(0).integers(3, args.vocab_size, size=(1, 500))
    gen_counts, limit = generate_vs_plain(torch, "llama3-8b", eng, prompt, 32, E8B_ENVELOPE,
                                          card, dtype="bfloat16")
    emit(profile_phase(torch, "llama3-8b", eng, prompt, card))
    # Sampled generation: the decode kernel, the plain logits, the sampler.
    s_counts = sampled_vs_plain(torch, "llama3-8b", eng, prompt, 32, card, dtype="bfloat16")

    # Serving: bf16 pools at quanta 1 and 4, against capacity-1 streams.
    workload = serve_workload(args.vocab_size)
    served = serve_vs_solo(torch, "llama3-8b", eng, workload, (("q1", 1), ("q4", 4)), limit,
                           card, dtype="bfloat16")
    paths = {name: {"generate": n, "sampled_generate": s_counts[name],
                    **{"serve_" + run: c[name] for run, c in served.items()}}
             for name, n in gen_counts.items()}
    emit(serve_profile_phase(torch, "llama3-8b", eng, workload, card))
    sampled_step_phase(torch, "llama3-8b", eng, workload, card)

    # The serving front end: the prefix cache (bf16 pools, then int8), and
    # the HTTP server around a prefix-caching engine.
    p_counts = prefix_phase(torch, eng, limit, card)
    p8_counts = prefix_phase(torch, eng, limit, card, kv_quant="int8")
    h_counts = server_phase(torch, eng, limit, card)
    for name in ("flash_prefill", "paged_attention"):
        paths[name].update(prefix=p_counts[name], server=h_counts[name])

    # Serving with int8 KV (int8 pools under the bf16 q) at quanta 1 and 4,
    # against capacity-1 int8-KV streams; the pools' bytes a token and the
    # 8,192-token rows that fit beside the weights.
    emit(pool_capacity(torch, eng, card))
    i8 = serve_vs_solo(torch, "llama3-8b", eng, workload, (("q1", 1), ("q4", 4)), limit,
                       card, kv_quant="int8", dtype="bfloat16", kv="int8")
    paths["paged_attention_i8"] = {"serve_q1": i8["q1"]["paged_attention"],
                                   "serve_q4": i8["q4"]["paged_attention"],
                                   "prefix": p8_counts["paged_attention"]}
    emit(serve_profile_phase(torch, "llama3-8b", eng, workload, card, kv_quant="int8"))
    torch.cuda.empty_cache()
    return rows, paths, eng, limit


def int8_phases(torch, smoke, args, weights, prompt, workload, card):
    """tinyllama-1.1b with int8 weights: the decode kernel's int8 mode at
    full width, greedy generation ((a) on grid weights against
    the fp32 kernel path, (b) on the synthetic weights against the int8
    plain path), then serving with int8 weights and int8 KV (the paged
    kernel's int8 mode).  Returns the kernel rows and the main paths'
    launch counts for the summary."""
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import timed_generate

    nl, n_tok = args.n_layers, 32
    q_args = args.replace(quant="int8")
    gen_counts = {"flash_prefill": nl, "decode_layers": n_tok - 1, "paged_attention": 0}

    def generate(eng, what):
        reset_counters()
        toks = eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
        counts = counters()
        # An int8 lm_head keeps lm_logits + argmax; a float32 one runs the head.
        want = {**gen_counts, "argmax_head": 0 if "lm_head_scale" in eng.params else n_tok - 1}
        if eng.cfg.kernels and counts != want:
            raise AssertionError(f"{what} launch counts {counts}, expected {want}")
        return toks, counts, torch.from_numpy(eng(prompt, 0))

    # (a) grid weights: the int8 kernel stream is the fp32 kernel stream.
    g_weights = grid_weights(torch, weights)
    eng = Llama(g_weights, args, device="cuda")
    toks_f, _, logits_f = generate(eng, "tinyllama fp32 (grid)")
    del eng
    torch.cuda.empty_cache()
    eng = Llama(g_weights, q_args, device="cuda")
    toks_g, _, logits_g = generate(eng, "tinyllama int8 (grid)")
    del eng, g_weights
    torch.cuda.empty_cache()
    if toks_g != toks_f:
        raise AssertionError("tinyllama int8 stream on grid weights diverges from the "
                             f"fp32 stream at token {first_diff(toks_g, toks_f)}")
    g_abs, g_rel = compare(torch, logits_g, logits_f, 1e-3, 1e-3,
                           "tinyllama int8 vs fp32 logits (grid weights)")

    # (b) the synthetic weights: the int8 kernels against the int8 plain path.
    q_eng = Llama(weights, q_args, device="cuda")
    smoke.decode_phase("tinyllama-1.1b", q_eng.params["layers"], args, 0)
    decode_row = smoke.decode_phase("tinyllama-1.1b", q_eng.params["layers"], args, 511)
    toks_q, q_counts, logits_q = generate(q_eng, "tinyllama int8")
    q_stats = timed_generate(q_eng, prompt, 64)[1]
    emit(profile_phase(torch, "tinyllama-1.1b-int8", q_eng, prompt, card))
    x_eng = plain_twin(q_eng)
    toks_x, _, logits_x = generate(x_eng, "tinyllama int8 plain")
    x_stats = timed_generate(x_eng, prompt, 64)[1]
    if toks_q != toks_x:
        raise AssertionError("tinyllama int8 kernel stream diverges from the int8 "
                             f"plain path at token {first_diff(toks_q, toks_x)}")
    q_abs, q_rel = compare(torch, logits_q, logits_x, 1e-3, 1e-3,
                           "tinyllama int8 kernel vs plain logits")
    if not torch.isfinite(logits_q).all():
        raise AssertionError("non-finite int8 logits")
    emit({"phase": "e2e", "model": "tinyllama-1.1b", "quant": "int8",
          "prompt_tokens": int(prompt.shape[1]), "launches": q_counts,
          "grid": {"greedy_tokens_equal_fp32": n_tok, "logits_max_abs_err": g_abs,
                   "logits_max_rel_err": g_rel},
          "synthetic": {"greedy_tokens_equal_plain": n_tok, "logits_max_abs_err": q_abs,
                        "logits_max_rel_err": q_rel},
          "logits_tol": {"rtol": 1e-3, "atol": 1e-3},
          "kernels": {"prefill_ms": q_stats.prefill_ms, "decode_tok_s": q_stats.decode_tok_s},
          "plain": {"prefill_ms": x_stats.prefill_ms, "decode_tok_s": x_stats.decode_tok_s},
          "timed_tokens": 64, "card": card})

    # Serving: int8 weights and int8 KV, paged, at quanta 1 and 4.
    paged_row = smoke.paged_phase(
        "tinyllama-1.1b", 8, args.n_heads, args.kv_heads, args.head_dim, 16,
        args.max_seq_len // 16, [0, 15, 16, 255, 500, 1023, 1500, 2047], NL=24,
        quant=True)
    solo = solo_serve(q_eng, workload, "int8")
    served = {}
    for run, quantum in (("q1", 1), ("q4", 4)):
        reset_counters()  # the main path: int8 serving through the kernels
        streams, st = serve(torch, q_eng, workload, quantum, kv_quant="int8")
        counts = counters()
        bad = [i for i, (g, w) in enumerate(zip(streams, solo)) if g != w]
        if bad:
            i = bad[0]
            raise AssertionError(f"int8 serving {run}: request {i} diverges from its "
                                 f"capacity-1 stream at token "
                                 f"{first_diff(streams[i], solo[i])}; {len(bad)} of 12 differ")
        expect = {"flash_prefill": nl * st["admissions"], "decode_layers": 0,
                  "paged_attention": nl * st["decode_steps"], "argmax_head": 0}
        if counts != expect or st["admissions"] != len(workload):
            raise AssertionError(f"int8 serving {run} launch counts {counts}, expected "
                                 f"{expect} ({st['admissions']} admissions)")
        served[run] = {**st, "launches": counts}
        emit({"phase": "e2e", "model": "tinyllama-1.1b", "path": "serving",
              "quant": "int8", "run": run, **st, "launches": counts,
              "streams_equal_solo": len(streams), "pages_leaked": 0, "card": card})
    emit(serve_profile_phase(torch, "tinyllama-1.1b-int8", q_eng, workload, card,
                             kv_quant="int8"))
    reset_counters()
    x_streams, x_st = serve(torch, x_eng, workload, 1, kv_quant="int8")
    if any(counters().values()):
        raise AssertionError(f"the plain int8 serving path launched kernels: {counters()}")
    emit({"phase": "e2e", "model": "tinyllama-1.1b", "path": "serving-plain",
          "quant": "int8", "run": "q1", **x_st,
          "streams_equal_solo": sum(g == w for g, w in zip(x_streams, solo)),
          "card": card})
    del q_eng, x_eng
    torch.cuda.empty_cache()
    return decode_row, paged_row, {
        "decode_layers": {"generate": q_counts["decode_layers"]},
        "paged_attention": {"serve_q1": served["q1"]["launches"]["paged_attention"],
                            "serve_q4": served["q4"]["launches"]["paged_attention"]}}


def decode_steps_of(names):
    """Step labels for one decode token's device kernels in launch order:
    the GEMVs of a layer come as QKV, wo, gate/up, down; a residual+norm
    kernel (the first design's) after a down GEMV (or first) normalizes
    the attention input, after a wo GEMV the FFN input, and the last one
    of the token writes x_out."""
    labels, gemv = [], 0
    for i, n in enumerate(names):
        low = n.lower()
        if "memset" in low:
            labels.append("memset")
        elif "attn_combine" in low:
            labels.append("merge")
        elif "attn" in low:
            labels.append("attention")
        elif "gemv" in low:
            labels.append(("qkv", "wo", "gate_up", "down")[gemv % 4])
            gemv += 1
        elif "rmsnorm" in low:
            labels.append("x_out" if i == len(names) - 1 else
                          "residual_norm_ffn" if gemv % 4 == 2 else "residual_norm_attn")
        else:
            labels.append("other")
    return labels


def decode_breakdown(torch, fn, calls: int = 8):
    """One decode_layers call broken down by step: `calls` calls under
    torch.profiler, each device kernel labelled by its place in the
    token (`decode_steps_of`), device µs per call by step and by kernel
    name, and the launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not evs:
        return {"device_us_per_call": "not measured"}
    per_call = len(evs) // calls
    by_step, by_name, path, span = {}, {}, {}, 0.0
    for c in range(calls):
        chunk = evs[c * per_call : (c + 1) * per_call]
        prev_end = chunk[0].time_range.start
        span += (chunk[-1].time_range.end - prev_end) / calls
        for e, lab in zip(chunk, decode_steps_of([e.name for e in chunk])):
            us = e.time_range.elapsed_us()
            by_step[lab] = by_step.get(lab, 0.0) + us / calls
            key = e.name.split("(")[0][-60:]
            by_name[key] = by_name.get(key, 0.0) + us / calls
            # The critical path: a kernel launched early (programmatically)
            # waits on its predecessor inside its own duration, so each
            # step is charged from the previous kernel's end to its own.
            path[lab] = path.get(lab, 0.0) + (e.time_range.end - prev_end) / calls
            prev_end = max(prev_end, e.time_range.end)
    return {"calls": calls, "launches_per_call": per_call,
            "device_us_per_call": sum(by_step.values()), "span_us_per_call": span,
            "device_us_by_step": by_step, "critical_path_us_by_step": path,
            "device_us_by_kernel": by_name}


def card_layers(torch, args, mode: str, seed: int = 0, scale: float = 0.02):
    """A fused whole-layer decode tree of `args` made on the card from a
    seeded card generator, layer by layer: weights normal x scale, norms
    1 + that; fp32, bf16 or fp16 weights, or int8 ones quantized per
    output column (scale = max |w| / 127) under f32, bf16 or fp16 norms."""
    g = torch.Generator("cuda").manual_seed(seed)
    nl, d, fd = args.n_layers, args.dim, args.hidden_dim
    qd, kvd = args.n_heads * args.head_dim, args.kv_heads * args.head_dim
    act = {"bf16": torch.bfloat16, "fp16": torch.float16}.get(mode.split("-")[-1],
                                                              torch.float32)
    int8 = mode.startswith("int8")
    out = {n: (1 + scale * torch.randn(nl, 1, d, generator=g, device="cuda")).to(act)
           for n in ("attn_norm", "ffn_norm")}
    for name, (k, n) in {"wqkv": (d, qd + 2 * kvd), "wo": (qd, d), "wgu": (d, 2 * fd),
                         "w_down": (fd, d)}.items():
        w = torch.empty(nl, k, n, dtype=torch.int8 if int8 else act, device="cuda")
        if int8:
            sc = torch.empty(nl, 1, n, device="cuda")
        for layer in range(nl):
            wl = torch.randn(k, n, generator=g, device="cuda") * scale
            if int8:
                sc[layer] = wl.abs().amax(dim=0, keepdim=True) / 127.0
                w[layer] = torch.clamp(torch.round(wl / sc[layer]), -127, 127).to(torch.int8)
            else:
                w[layer] = wl.to(act)
            del wl
        out[name] = w
        if int8:
            out[name + "_scale"] = sc
    return out


def load_parent(parent_dir: str, module: str = "decode_step"):
    """A kernel wrapper module (`ops.kernels.<module>`) of another checkout
    of the port (its own kernel sources and build directory), imported
    from the package `l3t_parent`."""
    import importlib
    import importlib.util

    if "l3t_parent" not in sys.modules:  # one parent package a process
        pkg = os.path.join(os.path.abspath(parent_dir), "llama3np_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "l3t_parent", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["l3t_parent"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"l3t_parent.ops.kernels.{module}")


def decode_ab(torch, parent_dir: str, card: str, only=()):
    """The decode kernel of the checkout at `parent_dir` against this one's,
    in one process on one card: at each shape of the main path's modes
    (or those named in `only`, as "model:mode" or "model:mode@pos,pos"),
    the same inputs, device time per call queued behind a spin kernel
    (`queued_ms`) in the order parent, change, change, parent, and each
    one's step breakdown (`decode_breakdown`).  A mode the other checkout
    lacks (the int8/bf16 mode before this design) is timed alone.  Returns
    the rows."""
    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.ops.kernels import decode_step as new

    old = load_parent(parent_dir)
    t0 = time.perf_counter()
    old._build.KernelLibrary.get()
    new._build.KernelLibrary.get()
    emit({"phase": "ab_build", "seconds": time.perf_counter() - t0,
          "parent": os.path.relpath(old._build.KernelLibrary.path, REPO),
          "change": os.path.relpath(new._build.KernelLibrary.path, REPO)})
    cases = [("stories15M", preset("stories15M", max_seq_len=1024), "fp32", (0, 5, 1023)),
             ("stories15M", preset("stories15M", max_seq_len=1024), "int8", (0, 5, 1023)),
             ("tinyllama-1.1b", preset("tinyllama-1.1b"), "fp32", (0, 511)),
             ("tinyllama-1.1b", preset("tinyllama-1.1b"), "int8", (0, 511)),
             ("llama3-8b", preset("llama3-8b"), "bf16", (0, 511, 8191)),
             ("llama3-8b", preset("llama3-8b"), "int8-bf16", (0, 511, 8191))]
    if only:
        picked = []
        for spec in only:
            name, _, at = spec.partition("@")
            for model, args, mode, positions in cases:
                if name == f"{model}:{mode}":
                    picked.append((model, args, mode, tuple(int(p) for p in at.split(","))
                                   if at else positions))
        cases = picked
    rows = []
    for model, args, mode, positions in cases:
        layers = card_layers(torch, args, mode)
        dt = layers["attn_norm"].dtype
        nl, kvh, M, hd = args.n_layers, args.kv_heads, args.max_seq_len, args.head_dim
        g = torch.Generator("cuda").manual_seed(1)
        kc = torch.randn(nl, kvh, M, hd, generator=g, device="cuda").to(dt)
        vc = torch.randn(nl, kvh, M, hd, generator=g, device="cuda").to(dt)
        x = (0.5 * torch.randn(1, args.dim, generator=g, device="cuda")).to(dt)
        kw = dict(n_heads=args.n_heads, kv_heads=kvh, head_dim=hd, norm_eps=args.norm_eps)
        reps = queue_reps(200, 8 * nl + 1)  # the parent's 7-8 launches a layer, + 1
        for pos in positions:
            ang = torch.rand(1, hd // 2, generator=g, device="cuda") * pos
            cos, sin = ang.cos(), ang.sin()
            fns = {"change": lambda: new.decode_layers(layers, x, pos, kc, vc, cos, sin, **kw)}
            if mode != "int8-bf16" or "l3t_decode_layers_i8_bf16" in old._build.SIGNATURES:
                fns["parent"] = lambda: old.decode_layers(layers, x, pos, kc, vc, cos, sin,
                                                          **kw)
            outs = {k: f()[0] for k, f in fns.items()}
            torch.cuda.synchronize()
            order = ("parent", "change", "change", "parent") if "parent" in fns else ("change",)
            series = {k: [] for k in fns}
            for who in order:
                series[who].append(queued_ms(torch, fns[who], reps))
            row = {"phase": "decode_ab", "model": model, "mode": mode, "pos": pos,
                   "ms": series, "order": list(order),
                   "breakdown": {k: decode_breakdown(torch, f) for k, f in fns.items()},
                   "card": card}
            if "parent" in outs:
                row["change_vs_parent_max_abs"] = (outs["change"].float()
                                                   - outs["parent"].float()).abs().max().item()
            emit(row)
            rows.append(row)
        del layers, kc, vc
        torch.cuda.empty_cache()
    new.decode_layers.launches = 0
    return rows


def paged_ab(torch, parent_dir: str, card: str):
    """The paged kernel of the checkout at `parent_dir` against this one's,
    in one process on one card: llama3-8b's paged shapes (B=8, page 16,
    tables of 512 pages; skewed rows and 8 rows at 4,096), stacked mode,
    int8 pools under a bf16 and an fp16 q and bf16 pools, the same inputs,
    device time per call queued behind a spin kernel (`queued_ms`, 8
    layers of pools in rotation) in the order parent, change, change,
    parent, and the largest difference of the two outputs."""
    from llama3np_tpu_torch.ops.core import quantize_kv_rows
    from llama3np_tpu_torch.ops.kernels import paged_attention as new

    old = load_parent(parent_dir, "paged_attention")
    B, NH, KVH, HD, page, maxp, NL = 8, 32, 8, 128, 16, 512, 8
    g = torch.Generator("cuda").manual_seed(3)
    rows = []
    for case, pos_list in (("skewed", SKEWED_8B), ("equal", [4096] * 8)):
        P = 1 + B * maxp
        bt = (torch.randperm(P - 1, generator=g, device="cuda")[: B * maxp] + 1)
        bt = bt.reshape(B, maxp).to(torch.int32)
        for b, p in enumerate(pos_list):
            bt[b, min(p // page + 1, maxp):] = 0
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        for mode in ("int8-bf16", "int8-fp16", "bf16"):
            qdt = torch.float16 if mode.endswith("fp16") else torch.bfloat16
            kv = [torch.randn(NL, P, KVH, page, HD, generator=g, device="cuda").to(qdt)
                  for _ in range(2)]
            cur = [torch.randn(B, KVH, HD, generator=g, device="cuda").to(qdt)
                   for _ in range(2)]
            kw = {}
            if mode.startswith("int8"):
                (kp, ks), (vp, vs) = quantize_kv_rows(kv[0]), quantize_kv_rows(kv[1])
                (ck, cks), (cv, cvs) = quantize_kv_rows(cur[0]), quantize_kv_rows(cur[1])
                kw = dict(k_scale=ks, v_scale=vs, cur_ks=cks, cur_vs=cvs)
            else:
                kp, vp, (ck, cv) = kv[0], kv[1], cur
            del kv
            q = torch.randn(B, 1, NH, HD, generator=g, device="cuda").to(qdt)
            it = itertools.count()

            def call(mod, layer=None):
                def run():
                    li = next(it) % NL if layer is None else layer
                    return mod.paged_attention(q, kp, vp, bt, pos, layer=li, cur_k=ck,
                                               cur_v=cv, **kw)
                return run
            outs = {who: call(mod, 1)() for who, mod in (("parent", old), ("change", new))}
            torch.cuda.synchronize()
            series = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                series[who].append(queued_ms(torch, call(old if who == "parent" else new), 50))
            row = {"phase": "paged_ab", "model": "llama3-8b", "mode": mode, "case": case,
                   "ms": series, "change_vs_parent_max_abs":
                   (outs["change"].float() - outs["parent"].float()).abs().max().item(),
                   "card": card}
            emit(row)
            rows.append(row)
            del kp, vp
            torch.cuda.empty_cache()
    new.paged_attention.launches = 0
    return rows


def alternate(torch, fns: dict, reps: int, rounds: int = 6) -> dict:
    """`queued_ms` of each callable in `fns`, `rounds` times, in turns that
    reverse every round (a, b, ..., then ..., b, a): each one's series."""
    series = {k: [] for k in fns}
    for r in range(rounds):
        for who in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            series[who].append(queued_ms(torch, fns[who], reps))
    return series


def spread_of(series: dict) -> dict:
    """(max - min) / min of each series."""
    return {k: (max(v) - min(v)) / min(v) for k, v in series.items()}


def head_alternation(torch, smoke, model: str, w, rounds: int = 6):
    """The greedy head against one torch.matmul + torch.argmax on the same
    lm_head and row, alternated `rounds` times (kernel, library, library,
    kernel, ...), each a `queued_ms` of 50 calls: both series and their
    spreads."""
    from llama3np_tpu_torch.ops.kernels.greedy_head import argmax_head

    launches = argmax_head.launches
    x = smoke.randn(1, w.shape[0], dtype=torch.bfloat16).to(w.dtype)
    series = alternate(torch, {"kernel": lambda: argmax_head(x, w),
                               "library": lambda: torch.argmax(torch.matmul(x, w), dim=-1)},
                       50, rounds)
    argmax_head.launches = launches  # comparison launches do not count
    return {"phase": "head_alternation", "model": model,
            "shape": {"D": w.shape[0], "VS": w.shape[1]},
            "dtype": str(w.dtype).replace("torch.", ""), "ms": series,
            "spread": spread_of(series),
            "kernel_mean_ms": sum(series["kernel"]) / rounds,
            "library_mean_ms": sum(series["library"]) / rounds,
            "kernel_slower_beyond_spread": min(series["kernel"]) > max(series["library"]),
            "card": smoke.card}


def flash_alternation(torch, smoke, model: str, L, NH, KVH, HD, rounds: int = 6):
    """fp32 flash prefill against one scaled_dot_product_attention
    (`is_causal`, `enable_gqa`; TF32 off) on the same inputs, alternated
    `rounds` times, each a `queued_ms` of 200 calls (50 from L = 256):
    both series and their spreads."""
    import torch.nn.functional as F
    from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill

    launches = flash_prefill.launches
    q, k, v = (smoke.randn(1, L, h, HD) for h in (NH, KVH, KVH))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    series = alternate(torch, {
        "kernel": lambda: flash_prefill(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)},
        200 if L < 256 else 50, rounds)
    flash_prefill.launches = launches  # comparison launches do not count
    return {"phase": "flash_alternation", "model": model,
            "shape": {"L": L, "NH": NH, "KVH": KVH, "HD": HD}, "dtype": "float32",
            "ms": series, "spread": spread_of(series),
            "kernel_mean_ms": sum(series["kernel"]) / rounds,
            "library_mean_ms": sum(series["library"]) / rounds,
            "kernel_slower_beyond_spread": min(series["kernel"]) > max(series["library"]),
            "card": smoke.card}


# The shapes `kernel_ab` times: the greedy head's lm_heads (D, VS, dtype) and
# fp32 flash prefill's (L, NH, KVH, HD), as the main paths give them
# (tinyllama-1.1b serving admits prompts in buckets up to 1,024).
AB_HEADS = (("stories15M", 288, 32000, "float32"), ("tinyllama-1.1b", 2048, 32000, "float32"),
            ("tinyllama-1.1b", 2048, 32000, "float16"),
            ("llama3-8b", 4096, 128256, "bfloat16"))
AB_FLASH = (("stories15M", 16, 6, 6, 48), ("stories15M", 100, 6, 6, 48),
            ("tinyllama-1.1b", 256, 32, 4, 64), ("tinyllama-1.1b", 512, 32, 4, 64),
            ("tinyllama-1.1b", 1024, 32, 4, 64))


def kernel_ab(torch, parent_dir: str, card: str, rounds: int = 4):
    """The greedy head and fp32 flash prefill of the checkout at
    `parent_dir` against this one's and the library call, in one process on
    one card: at each shape of AB_HEADS and AB_FLASH, the same inputs,
    `queued_ms` in turns (parent, change, library, then reversed), and the
    two kernels' outputs compared.  Returns the rows."""
    import torch.nn.functional as F

    from llama3np_tpu_torch.ops.kernels import flash_prefill as new_flash
    from llama3np_tpu_torch.ops.kernels import greedy_head as new_head

    old_head = load_parent(parent_dir, "greedy_head")
    old_flash = load_parent(parent_dir, "flash_prefill")
    t0 = time.perf_counter()
    old_head._build.KernelLibrary.get()
    new_head._build.KernelLibrary.get()
    emit({"phase": "ab_build", "seconds": time.perf_counter() - t0,
          "parent": os.path.relpath(old_head._build.KernelLibrary.path, REPO),
          "change": os.path.relpath(new_head._build.KernelLibrary.path, REPO)})
    g = torch.Generator("cuda").manual_seed(5)
    rows = []
    for model, D, VS, dt in AB_HEADS:
        dtype = getattr(torch, dt)
        w = (torch.randn(D, VS, generator=g, device="cuda") * 0.02).to(dtype)
        x = torch.randn(1, D, generator=g, device="cuda").to(dtype)
        fns = {"parent": lambda: old_head.argmax_head(x, w),
               "change": lambda: new_head.argmax_head(x, w),
               "library": lambda: torch.argmax(torch.matmul(x, w), dim=-1)}
        toks = {k: int(f()[0]) for k, f in fns.items() if k != "library"}
        series = alternate(torch, fns, 50, rounds)
        row = {"phase": "kernel_ab", "kernel": "argmax_head", "model": model, "dtype": dt,
               "shape": {"D": D, "VS": VS}, "ms": series, "spread": spread_of(series),
               "tokens_equal": toks["parent"] == toks["change"], "card": card}
        if not row["tokens_equal"]:
            raise AssertionError(f"argmax_head A/B {model} {dt}: tokens {toks}")
        emit(row)
        rows.append(row)
        del w
    for model, L, NH, KVH, HD in AB_FLASH:
        q, k, v = (torch.randn(1, L, h, HD, generator=g, device="cuda") for h in (NH, KVH, KVH))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fns = {"parent": lambda: old_flash.flash_prefill(q, k, v),
               "change": lambda: new_flash.flash_prefill(q, k, v),
               "library": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)}
        diff = (fns["change"]() - fns["parent"]()).abs().max().item()
        series = alternate(torch, fns, 200 if L < 256 else 50, rounds)
        row = {"phase": "kernel_ab", "kernel": "flash_prefill", "model": model,
               "dtype": "float32", "shape": {"L": L, "NH": NH, "KVH": KVH, "HD": HD},
               "ms": series, "spread": spread_of(series), "change_vs_parent_max_abs": diff,
               "card": card}
        emit(row)
        rows.append(row)
    new_head.argmax_head.launches = new_flash.flash_prefill.launches = 0
    return rows


def llama3_8b_int8_phases(torch, smoke, card, target, limit):
    """llama3-8b with int8 weights under bf16 activations (quant="int8",
    dtype bfloat16) at full width and depth, quantized on the card from the
    loaded bf16 engine's tree, the decode kernel's int8/bf16 mode against
    its twin at pos 0 / 511 / 8191, greedy generation through flash
    prefill and that mode (the int8 lm_head stays plain: lm_logits and
    argmax) against the plain path (attn_impl="xla"): logits within the
    bf16 envelope with top-1 equal, the stream equal or parted at a
    near-tie; prefill ms and decode tok/s of both, and a trace that shows
    the plain head's share.  The engine is the int8 self-draft of the bf16
    `target` (the loaded bf16 engine, kept alive; the same tree as
    `quantized_draft` of its seeded weights): last, speculation of the
    target guided by
    it (k = 4; `limit`: the bf16 near-tie limit).  Returns the kernel row
    and the launch counts."""
    import resource

    import numpy as np

    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.checkpoint import quantize_param_tree
    from llama3np_tpu_torch.models.llama import Llama

    args = preset("llama3-8b", quant="int8")
    nl = args.n_layers
    t0 = time.perf_counter()
    # The target's own tree quantized on the card: the codes and scales
    # `quantized_draft` of the seeded weights gives (its loader rounds each
    # weight to bf16 and then quantizes, C5), without a third host staging.
    eng = Llama.from_param_tree(
        quantize_param_tree(target.params, device="cuda", dtype=args.dtype), args)
    torch.cuda.synchronize()
    import gc
    gc.collect()
    emit({"phase": "load", "model": "llama3-8b", "quant": "int8", "layers": nl,
          "dtype": args.dtype, "seconds": time.perf_counter() - t0,
          "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "weights_gb": sum(t.numel() * t.element_size()
                            for t in eng.params["layers"].values()) / 1e9,
          "device_allocated_gb": torch.cuda.memory_allocated() / 1e9, "card": card})
    layers = eng.params["layers"]
    smoke.decode_phase("llama3-8b", layers, args, 0)
    row = smoke.decode_phase("llama3-8b", layers, args, 511)
    smoke.decode_phase("llama3-8b", layers, args, 8191)
    torch.cuda.empty_cache()

    prompt = np.random.default_rng(0).integers(3, args.vocab_size, size=(1, 500))
    # The main path: int8 greedy generation through the kernels.
    counts, q_limit = generate_vs_plain(torch, "llama3-8b", eng, prompt, 32, E8B_ENVELOPE,
                                        card, quant="int8", dtype="bfloat16")
    prof = profile_phase(torch, "llama3-8b-int8", eng, prompt, card)
    dec = prof["decode"]["device_ms_by_kind"]
    total = sum(dec.values()) or 1.0
    # The plain int8 head: its f32 product (gemm) and the widening of the
    # 525 M-weight lm_head (copy_cast); nothing else of a decode token
    # runs a GEMM or a cast.
    prof["decode"]["plain_head_share"] = (dec.get("gemm", 0.0) + dec.get("copy_cast", 0.0)) / total
    emit(prof)
    # Serving with int8 weights and int8 KV under bf16 activations, quantum 1.
    i8 = serve_vs_solo(torch, "llama3-8b", eng, serve_workload(args.vocab_size), (("q1", 1),),
                       q_limit, card, kv_quant="int8", quant="int8", dtype="bfloat16", kv="int8")
    torch.cuda.empty_cache()
    spec = speculative_phase(torch, "llama3-8b", target, eng, prompt, 64, limit, card,
                             dtype="bfloat16", draft_quant="int8")
    del eng
    torch.cuda.empty_cache()
    return row, {"decode_layers": {"generate": counts["decode_layers"],
                                   "speculative": spec["decode_layers"]},
                 "flash_prefill": {"speculative": spec["flash_prefill"]},
                 "paged_attention_i8": {"serve_q1_int8_weights": i8["q1"]["paged_attention"]}}


def speculative_phase(torch, model: str, target, draft, prompt, n_tok: int, limit: float,
                      card, k: int = 4, rounds: int = 6, **tags):
    """Greedy speculative decoding (`SpeculativeGenerator`, k proposals a
    round) of `target` guided by `draft`, against the target's own greedy
    stream through the kernels and against the plain path's: equal, or
    first parted at a near-tie of the plain path's logits under `limit`
    (the verify pass's (k+1)-row products against the decode kernel's
    GEMVs, or the plain path's one-row products); exact launch counts
    (flash once a layer for each engine's prefill, the decode kernel k+1
    times a round for the draft's steps, no greedy head: the int8 draft's
    head and the verify's logits are plain); tokens, rounds, accept rate,
    host reads a round; decode tok/s (that run's fenced time less a fenced
    prefill) against the target-only greedy rate; `rounds` rounds timed
    part by part (draft steps, verify, the host
    read), and one traced, its device time by kind.  Returns the launch
    counts."""
    import numpy as np

    from llama3np_tpu_torch import SpeculativeGenerator
    from llama3np_tpu_torch.generate import pad_prompt
    from llama3np_tpu_torch.observability import timed_generate

    nl = target.args.n_layers
    want = target.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    t_stats = timed_generate(target, prompt, n_tok)[1]
    spec = SpeculativeGenerator(target, draft, k=k)
    spec.generate_tokens(prompt, 2 * k)  # warm
    reset_counters()  # the main path: speculative generation through the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = spec.generate_tokens(prompt, n_tok)[0].tolist()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts, st = counters(), dict(spec.last_stats)
    expect = {"flash_prefill": 2 * nl, "decode_layers": st["rounds"] * (k + 1),
              "paged_attention": 0, "argmax_head": 0}
    if counts != expect:
        raise AssertionError(f"{model} speculative launch counts {counts}, expected {expect}")
    if st["host_reads"] != st["rounds"]:
        raise AssertionError(f"{model} speculative host reads {st}")
    twin = plain_twin(target)

    def plain_margin(i):  # the plain path's top-2 margin before token i
        ctx = np.array([prompt[0].tolist() + want[:i]])
        top = torch.from_numpy(twin(ctx, 0))[0, -1].float().topk(2).values
        return float(top[0] - top[1])

    rule = near_tie(got, want, plain_margin, limit, f"{model} {tags} speculative stream")
    # The verify's logits are the plain path's: the stream against the
    # plain path's own greedy stream too, by the same rule.
    plain = twin.generate_tokens(prompt, n_tok).cpu()[0].tolist()

    def plain_margin_own(i):
        ctx = np.array([prompt[0].tolist() + plain[:i]])
        top = torch.from_numpy(twin(ctx, 0))[0, -1].float().topk(2).values
        return float(top[0] - top[1])

    rule_plain = near_tie(got, plain, plain_margin_own, limit,
                          f"{model} {tags} speculative stream vs the plain path")
    del twin
    padded, L = pad_prompt(prompt, target.args)
    ids = torch.as_tensor(padded, device=target.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur, t_cache, d_cache = spec.prefill(ids, L)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos, parts = L, {"draft_ms": [], "verify_ms": [], "read_ms": []}

    def one_round(cur, pos, split=True):
        t0 = time.perf_counter()
        props = spec.propose(cur, pos, d_cache)
        if split:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = spec.verify(cur, props, pos, t_cache)
        if split:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        vals = torch.cat([cur, props, g]).tolist()
        t3 = time.perf_counter()
        p, gg = vals[1 : k + 1], vals[k + 1 :]
        a = next((i for i in range(k) if p[i] != gg[i]), k)
        return g[a : a + 1], pos + a + 1, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3)

    for _ in range(rounds):
        cur, pos, ms = one_round(cur, pos)
        for name, v in zip(parts, ms):
            parts[name].append(v)
    _, win, rows = trace(torch, lambda: one_round(cur, pos, split=False), top=8)
    split = by_kind(rows)
    emit({"phase": "e2e", "model": model, "path": "speculative", **tags, "k": k,
          "prompt_tokens": int(prompt.shape[1]), "tokens": n_tok, "launches": counts,
          "stats": st,
          "host_reads_per_round": st["host_reads"] / max(st["rounds"], 1),
          "stream_vs_target": rule, "stream_vs_plain": rule_plain, "near_tie_limit": limit,
          "spec": {"prefill_ms": prefill_s * 1e3, "total_s": total_s,
                   "decode_tok_s": (n_tok - 1) / (total_s - prefill_s)},
          "target_only": {"prefill_ms": t_stats.prefill_ms,
                          "decode_tok_s": t_stats.decode_tok_s},
          "round_ms": {name: sum(v) / len(v) for name, v in parts.items()},
          "round_ms_each": parts,
          "traced_round": {**win, "device_ms_by_kind": split}, "card": card})
    del t_cache, d_cache
    torch.cuda.empty_cache()
    return counts


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in
               [*params["layers"].values(), *(v for k, v in params.items() if k != "layers")])


def split_int4_phases(torch, t_eng, weights, prompt, toks_k, logits_k, limit, workload,
                      card):
    """tinyllama-1.1b (`t_eng`: the fp32 fused engine on the kernels) at
    full width, ROADMAP A4-A5: speculation with an int8
    self-draft (k = 4); the split layout in fp32 (its greedy stream
    against the fused kernel stream `toks_k`, logits within 1e-3 of
    `logits_k`); int4 on int4-grid weights (its stream equal to the fp32
    split engine's on the same weights, logits within 1e-3; weight bytes,
    prefill ms, decode tok/s, a trace); int4 serving over int8 pools at
    quanta 1 and 4 against capacity-1 streams (strict); a quantized
    checkpoint's round trip and a mixed-bit tree (bits=4, head_bits=8,
    quantized on the card).  Returns each path's launch counts."""
    from llama3np_tpu_torch import quantized_draft
    from llama3np_tpu_torch.checkpoint import quantize_param_tree, save_quantized_npz
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import timed_generate

    import numpy as np

    model, args = "tinyllama-1.1b", t_eng.args
    nl, n_tok = args.n_layers, 32
    draft = quantized_draft(weights, args)
    paths = {"speculative": speculative_phase(torch, model, t_eng, draft, prompt, 64, limit,
                                              card, dtype="float32", draft_quant="int8")}
    del draft
    torch.cuda.empty_cache()
    plain_gen = {"flash_prefill": nl, "decode_layers": 0, "paged_attention": 0,
                 "argmax_head": 0}

    def generate(eng, what):
        reset_counters()  # a split tree decodes on the plain path
        toks = eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
        if counters() != plain_gen:
            raise AssertionError(f"{what} launch counts {counters()}, expected {plain_gen}")
        logits = torch.from_numpy(eng(prompt, 0))
        if not torch.isfinite(logits).all():
            raise AssertionError(f"non-finite {what} logits")
        return toks, logits

    # The split layout in fp32 against the fused engine's kernel stream.
    split_args = args.replace(fuse_matmuls=False)
    s_eng = Llama(weights, split_args, device="cuda")
    toks_s, logits_s = generate(s_eng, "tinyllama split fp32")
    s_abs, s_rel = compare(torch, logits_s, logits_k, 1e-3, 1e-3,
                           "tinyllama split vs fused logits")

    def split_margin(i):
        ctx = np.array([prompt[0].tolist() + toks_k[:i]])
        top = torch.from_numpy(s_eng(ctx, 0))[0, -1].topk(2).values
        return float(top[0] - top[1])

    rule = near_tie(toks_s, toks_k, split_margin, limit, "tinyllama split stream")
    s_stats = timed_generate(s_eng, prompt, 64)[1]
    emit({"phase": "e2e", "model": model, "layout": "split", "dtype": "float32",
          "launches": plain_gen, "stream_vs_fused_kernels": rule, "near_tie_limit": limit,
          "logits_max_abs_err": s_abs, "logits_max_rel_err": s_rel,
          "logits_tol": {"rtol": 1e-3, "atol": 1e-3},
          "prefill_ms": s_stats.prefill_ms, "decode_tok_s": s_stats.decode_tok_s,
          "timed_tokens": 64, "card": card})
    del s_eng
    torch.cuda.empty_cache()

    # int4 on int4-grid weights against the fp32 split engine on them.
    g4 = grid_weights(torch, weights, qmax=7)
    f_eng = Llama(g4, split_args, device="cuda")
    toks_f, logits_f = generate(f_eng, "tinyllama split fp32 (int4 grid)")
    f_bytes = weight_bytes(f_eng.params)
    q_args = split_args.replace(quant="int4")
    t0 = time.perf_counter()
    q_eng = Llama(g4, q_args, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    toks_q, logits_q = generate(q_eng, "tinyllama int4")
    if toks_q != toks_f:
        raise AssertionError("tinyllama int4 stream on int4-grid weights diverges from the "
                             f"fp32 split stream at token {first_diff(toks_q, toks_f)}")
    q_abs, q_rel = compare(torch, logits_q, logits_f, 1e-3, 1e-3,
                           "tinyllama int4 vs fp32 logits (int4 grid)")
    q_stats = timed_generate(q_eng, prompt, 64)[1]
    q_bytes = weight_bytes(q_eng.params)
    payload = sum(t.numel() for t in q_eng.params["layers"].values() if t.dtype == torch.uint8)
    emit({"phase": "e2e", "model": model, "quant": "int4", "layout": "split",
          "load_s": load_s, "launches": plain_gen, "greedy_tokens_equal_fp32": n_tok,
          "logits_max_abs_err": q_abs, "logits_max_rel_err": q_rel,
          "logits_tol": {"rtol": 1e-3, "atol": 1e-3},
          "weight_bytes": {"int4": q_bytes, "fp32": f_bytes, "ratio": q_bytes / f_bytes,
                           "packed_layer_payload": payload},
          "prefill_ms": q_stats.prefill_ms, "decode_tok_s": q_stats.decode_tok_s,
          "timed_tokens": 64, "card": card})
    emit(profile_phase(torch, "tinyllama-1.1b-int4", q_eng, prompt, card))

    # int4 serving over int8 pools, against capacity-1 streams (strict).
    served = serve_vs_solo(torch, model, q_eng, workload, (("q1", 1), ("q4", 4)), 0.0, card,
                           kv_quant="int8", quant="int4", kv="int8")
    emit(serve_profile_phase(torch, "tinyllama-1.1b-int4", q_eng, workload, card,
                             kv_quant="int8"))
    paths.update(int4_serve_q1=served["q1"], int4_serve_q4=served["q4"])

    # A quantized checkpoint: save, boot, the same stream.
    ckpt = os.path.join(REPO, "build", "smoke", "tinyllama-int4.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    t0 = time.perf_counter()
    save_quantized_npz(q_eng.params, ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_eng = Llama.from_quantized(ckpt, q_args, device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    toks_b, _ = generate(b_eng, "tinyllama int4 from_quantized")
    if toks_b != toks_q:
        raise AssertionError("the int4 checkpoint's stream diverges at token "
                             f"{first_diff(toks_b, toks_q)}")
    file_bytes = os.path.getsize(ckpt)
    del b_eng, q_eng
    os.remove(ckpt)
    torch.cuda.empty_cache()

    # Mixed bits: int4 layers under an int8 head, quantized on the card
    # from the fp32 split engine's tree (built, permuted) on the same weights.
    mixed = quantize_param_tree(f_eng.params, bits=4, head_bits=8, device="cuda")
    del f_eng
    save_quantized_npz(mixed, ckpt)
    del mixed
    m_eng = Llama.from_quantized(ckpt, q_args, device="cuda")
    toks_m, _ = generate(m_eng, "tinyllama mixed bits")
    toks_m2, _ = generate(m_eng, "tinyllama mixed bits, again")
    if toks_m != toks_m2 or m_eng.params["lm_head"].dtype != torch.int8:
        raise AssertionError("the mixed-bit engine is not deterministic or not mixed")
    emit({"phase": "e2e", "model": model, "path": "quantized_checkpoint",
          "int4": {"file_bytes": file_bytes, "save_s": save_s, "boot_s": boot_s,
                   "stream_equal": True},
          "mixed_bits": {"bits": 4, "head_bits": 8, "file_bytes": os.path.getsize(ckpt),
                         "stream_repeats": True,
                         "greedy_tokens_equal_int4": first_diff(toks_m, toks_q)},
          "card": card})
    del m_eng
    os.remove(ckpt)
    torch.cuda.empty_cache()
    return paths


def fp16_phases(torch, smoke, args, weights, prompt, workload, card):
    """tinyllama-1.1b in float16 at full width: the four kernels'
    fp16 modes and the paged kernel's int8-under-fp16 mode against their
    twins at its shapes; greedy generation against the plain path (the
    fp16 envelope, near-tie rule), serving over fp16 pools and over int8
    pools at quantum 1 against capacity-1 streams; then int8 weights under
    fp16 activations: the decode kernel's int8/fp16 mode against its twin,
    and greedy generation against the plain path (the bf16 envelope: the
    kernel rounds the activation to bf16 before an int8 product).  Returns
    the kernel rows and each one's launches on its path."""
    from llama3np_tpu_torch.models.llama import Llama

    f16, model = torch.float16, "tinyllama-1.1b"
    h_args = args.replace(dtype="float16", kv_dtype=None).validate()  # fp16 caches too
    shape = (args.n_heads, args.kv_heads, args.head_dim)
    skewed = [0, 15, 16, 255, 500, 1023, 1500, 2047]
    eng = Llama(weights, h_args, device="cuda")
    rows = {"flash_prefill": smoke.flash_phase(model, 1, 512, *shape, dtype=f16)}
    smoke.decode_phase(model, eng.params["layers"], h_args, 0)
    rows["decode_layers"] = smoke.decode_phase(model, eng.params["layers"], h_args, 511)
    rows["argmax_head"] = smoke.argmax_phase(model, eng.params["lm_head"])
    emit(head_alternation(torch, smoke, model, eng.params["lm_head"]))
    rows["paged_attention"] = smoke.paged_phase(model, 8, *shape, 16, args.max_seq_len // 16,
                                                skewed, NL=22, dtype=f16)
    rows["paged_attention_i8"] = smoke.paged_phase(
        model, 8, *shape, 16, args.max_seq_len // 16, skewed, NL=22, quant=True, dtype=f16)
    gen, limit = generate_vs_plain(torch, model, eng, prompt, 32, F16_ENVELOPE, card,
                                   dtype="float16")
    emit(profile_phase(torch, "tinyllama-1.1b-fp16", eng, prompt, card))
    serve_f = serve_vs_solo(torch, model, eng, workload, (("q1", 1),), limit, card,
                            dtype="float16")
    serve_i = serve_vs_solo(torch, model, eng, workload, (("q1", 1),), limit, card,
                            kv_quant="int8", dtype="float16", kv="int8")
    del eng
    torch.cuda.empty_cache()
    q_eng = Llama(weights, h_args.replace(quant="int8"), device="cuda")
    rows["decode_layers_i8"] = smoke.decode_phase(model, q_eng.params["layers"], h_args, 511)
    q_gen, _ = generate_vs_plain(torch, model, q_eng, prompt, 32, E8B_ENVELOPE, card,
                                 dtype="float16", quant="int8")
    del q_eng
    torch.cuda.empty_cache()
    paths = {"flash_prefill": {"serve_q1": serve_f["q1"]["flash_prefill"],
                               "generate": gen["flash_prefill"]},
             "decode_layers": {"generate": gen["decode_layers"]},
             "argmax_head": {"generate": gen["argmax_head"]},
             "paged_attention": {"serve_q1": serve_f["q1"]["paged_attention"]},
             "paged_attention_i8": {"serve_q1": serve_i["q1"]["paged_attention"]},
             "decode_layers_i8": {"generate": q_gen["decode_layers"]}}
    return rows, paths


def fp16_8b_shapes(torch, smoke):
    """The fp16 kernel modes at llama3-8b's shapes, alone (no 8B fp16
    engine is built): flash at L=512, the greedy head on a 4096 x 128,256
    lm_head, the decode kernel's fp16 and int8/fp16 modes on 32 layers
    made on the card (`card_layers`) at pos 511, the paged kernel over fp16
    pools and over int8 pools under an fp16 q (skewed rows)."""
    from llama3np_tpu_torch import preset

    f16, model = torch.float16, "llama3-8b"
    args = preset("llama3-8b", dtype="float16")
    shape = (args.n_heads, args.kv_heads, args.head_dim)
    smoke.flash_phase(model, 1, 512, *shape, dtype=f16)
    w = smoke.randn(args.dim, args.vocab_size, scale=0.02, dtype=f16)
    smoke.argmax_phase(model, w)
    del w
    for mode in ("fp16", "int8-fp16"):
        layers = card_layers(torch, args, mode)
        smoke.decode_phase(model, layers, args, 511)
        del layers
        torch.cuda.empty_cache()
    smoke.paged_phase(model, 8, *shape, 16, 512, SKEWED_8B, dtype=f16)
    smoke.paged_phase(model, 8, *shape, 16, 512, SKEWED_8B, quant=True, dtype=f16)
    torch.cuda.empty_cache()


# The kv_dtype override (ROADMAP B11): every ordered pair of float dtypes
# (activations, cache) with the two different.
KV_PAIRS = [("float32", "bfloat16"), ("float32", "float16"), ("bfloat16", "float32"),
            ("bfloat16", "float16"), ("float16", "float32"), ("float16", "bfloat16")]


def kv_override_phases(torch, smoke, args, weights, prompt, workload, card, fp32):
    """The kv_dtype override at tinyllama-1.1b's shapes (ROADMAP B11): for
    every pair, the decode kernel (float weights in the activation dtype,
    and int8 weights) and the paged kernel (float pools under a q of
    another dtype) against their twins; then fp32 activations over a bf16
    cache at full width: greedy generation through flash, the
    decode kernel's override mode and the greedy head against the plain
    path (the fp16 envelope, 0.02 x max(1, max |logits|): only attention's
    rounding points differ, at a bf16 ulp; near-tie rule), exact launch
    counts, paged serving over bf16 pools at quanta 1 and 4 with every
    stream equal to its capacity-1 stream and every page back, decode
    tok/s, prefill ms and ms a step beside the fp32-cache numbers of this
    run (`fp32`).  Returns the kernel rows and their launches."""
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import timed_generate

    model, dt = "tinyllama-1.1b", lambda n: getattr(torch, n)
    shape = (args.n_heads, args.kv_heads, args.head_dim)
    skewed = [0, 15, 16, 255, 500, 1023, 1500, 2047]
    rows, mode_of = {}, {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}
    for act in ("float32", "bfloat16", "float16"):
        a_args = args.replace(dtype=act, kv_dtype=None)
        for int8 in (False, True):
            mode = mode_of[act] if not int8 else (
                "int8" if act == "float32" else f"int8-{mode_of[act]}")
            layers = card_layers(torch, a_args, mode)
            for a, kv in KV_PAIRS:
                if a != act:
                    continue
                poses = (511, 0) if (act, kv, int8) == ("float32", "bfloat16", False) else (511,)
                for pos in poses:
                    row = smoke.decode_phase(model, layers, a_args, pos, cache_dtype=dt(kv),
                                             reps=10)
                    rows.setdefault(("decode_layers", row["mode"]), row)
            del layers
            torch.cuda.empty_cache()
    for act, kv in KV_PAIRS:
        row = smoke.paged_phase(model, 8, *shape, 16, args.max_seq_len // 16, skewed,
                                NL=22, dtype=dt(act), kv_dtype=dt(kv))
        rows[("paged_attention", row["mode"])] = row

    o_args = args.replace(kv_dtype="bfloat16")
    eng = Llama(weights, o_args, device="cuda")
    assert eng.cache["k"].dtype == torch.bfloat16
    gen, limit = generate_vs_plain(torch, model, eng, prompt, 32, F16_ENVELOPE, card,
                                   dtype="float32", kv_dtype="bfloat16")
    stats = timed_generate(eng, prompt, 64)[1]
    steps = {}
    served = serve_vs_solo(torch, model, eng, workload, (("q1", 1), ("q4", 4)), 0.0, card,
                           timings=steps, dtype="float32", kv_dtype="bfloat16")
    del eng
    torch.cuda.empty_cache()
    emit({"phase": "e2e", "model": model, "path": "kv_dtype override", "dtype": "float32",
          "kv_dtype": "bfloat16",
          "kv_bf16": {"prefill_ms": stats.prefill_ms, "decode_tok_s": stats.decode_tok_s,
                      "ms_per_step_q1": steps["q1"]["ms_per_step"],
                      "ms_per_step_q4": steps["q4"]["ms_per_step"]},
          "kv_fp32": fp32, "card": card})
    paths = {("decode_layers", "fp32-kv-bf16"): {"generate": gen["decode_layers"]},
             ("paged_attention", "bf16-q-fp32"): {"serve_q1": served["q1"]["paged_attention"],
                                                  "serve_q4": served["q4"]["paged_attention"]}}
    return rows, paths, {"flash_prefill": gen["flash_prefill"] + served["q1"]["flash_prefill"],
                         "argmax_head": gen["argmax_head"]}


def write_llama2c_bin(path: str, w, args):
    """A llama2.c v0 export (the 7-int32 header, then float32 tensors in
    llama2.c's order, an untied classifier last) of HF-schema weights."""
    import numpy as np

    L, p = args.n_layers, "model.layers.{i}."
    names = ["input_layernorm", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "post_attention_layernorm", "mlp.gate_proj",
             "mlp.down_proj", "mlp.up_proj"]
    with open(path, "wb") as f:
        np.array([args.dim, args.hidden_dim, L, args.n_heads, args.kv_heads,
                  -args.vocab_size, args.max_seq_len], np.int32).tofile(f)
        np.asarray(w["model.embed_tokens.weight"], np.float32).tofile(f)
        for n in names:
            for i in range(L):
                np.asarray(w[(p + n + ".weight").format(i=i)], np.float32).tofile(f)
        np.asarray(w["model.norm.weight"], np.float32).tofile(f)
        np.zeros(args.max_seq_len * args.head_dim, np.float32).tofile(f)  # RoPE tables
        np.asarray(w["lm_head.weight"], np.float32).tofile(f)


def write_hf_dir(torch, d: str, w, args):
    """A HuggingFace directory: one bf16 `model.safetensors` (8-byte
    little-endian header length, JSON header, raw data) with q/k rows in
    HF's rotate-half layout, and a `config.json`."""
    from llama3np_tpu_torch.ops.core import rope_split_permutation

    os.makedirs(d, exist_ok=True)
    perm = {"q_proj": rope_split_permutation(args.n_heads, args.head_dim),
            "k_proj": rope_split_permutation(args.kv_heads, args.head_dim)}
    header, off = {}, 0
    for k in sorted(w):
        header[k] = {"dtype": "BF16", "shape": list(w[k].shape),
                     "data_offsets": [off, off + 2 * w[k].size]}
        off += 2 * w[k].size
    head = json.dumps(header).encode()
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for k in sorted(w):
            v = w[k][perm[k.split(".")[-2]]] if k.split(".")[-2] in perm else w[k]
            f.write(torch.from_numpy(v).to(torch.bfloat16).view(torch.uint8).numpy().tobytes())
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"hidden_size": args.dim, "num_hidden_layers": args.n_layers,
                   "num_attention_heads": args.n_heads, "num_key_value_heads": args.kv_heads,
                   "vocab_size": args.vocab_size, "max_position_embeddings": args.max_seq_len,
                   "rope_theta": args.rope_theta, "rms_norm_eps": args.norm_eps,
                   "intermediate_size": args.hidden_dim, "torch_dtype": "bfloat16"}, f)


def tooling_phases(torch, card, s_weights, s_args, s_stream, t_eng, t_weights, prompt,
                   toks_k):
    """The host tooling at full width (ROADMAP A6), on checkpoints this
    script writes from seeded weights: stories15M as a llama2.c `.bin`,
    converted and booted on the card (its greedy stream against the same
    weights handed over directly, `s_stream`); tinyllama-1.1b as an HF
    directory (bf16 safetensors, rotate-half q/k rows, config.json),
    converted with `args_from_hf_config` and booted in bf16 (against the
    direct bf16 engine's stream); a generation saved and resumed on the
    card over a bf16 cache under fp32 activations (first + rest against
    the uninterrupted stream, the rest through the decode kernel); a
    profiler trace of greedy generation (the file names the port's
    kernels); `debug_trace_generate`'s tokens against the fp32 kernel
    stream `toks_k`.  Returns each step's seconds."""
    import shutil

    import numpy as np

    from llama3np_tpu_torch import checkpoint as ck
    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import debug_trace_generate, trace

    root = os.path.join(REPO, "build", "smoke", "a6")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ids = np.array([PROMPT], np.int64)
    out, t0 = {"card": card}, time.perf_counter()

    write_llama2c_bin(os.path.join(root, "stories15M.bin"), s_weights, s_args)
    cw, cargs = ck.convert_llama2c_bin(os.path.join(root, "stories15M.bin"))
    got = Llama(cw, cargs, device="cuda").generate_tokens(ids, len(s_stream)).cpu()[0].tolist()
    if got != s_stream:
        raise AssertionError(f"stories15M from its llama2.c .bin diverges at token "
                             f"{first_diff(got, s_stream)}")
    out["llama2c"] = {"tokens_equal": len(got), "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    b_args = t_eng.args.replace(dtype="bfloat16")
    want = Llama(t_weights, b_args, device="cuda").generate_tokens(prompt, 16).cpu()[0].tolist()
    hf = os.path.join(root, "tinyllama-hf")
    write_hf_dir(torch, hf, t_weights, b_args)
    hw = ck.convert_hf_model(hf)
    h_args = ck.args_from_hf_config(hf)
    if h_args.dtype != "bfloat16" or (h_args.dim, h_args.n_layers, h_args.kv_heads) != (
            b_args.dim, b_args.n_layers, b_args.kv_heads):
        raise AssertionError(f"args_from_hf_config gave {h_args}")
    got = Llama(hw, h_args, device="cuda").generate_tokens(prompt, 16).cpu()[0].tolist()
    del hw
    if got != want:
        raise AssertionError(f"tinyllama from its HF directory diverges at token "
                             f"{first_diff(got, want)}")
    out["hf_safetensors_bf16"] = {"tokens_equal": len(got),
                                  "file_gb": os.path.getsize(os.path.join(
                                      hf, "model.safetensors")) / 1e9,
                                  "s": time.perf_counter() - t0}
    shutil.rmtree(hf)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    o_eng = Llama(t_weights, b_args.replace(dtype="float32", kv_dtype="bfloat16"),
                  device="cuda")
    full = o_eng.generate_tokens(prompt, 24).cpu()[0].tolist()
    first = o_eng.generate_tokens(prompt, 8).cpu()[0].tolist()
    state = os.path.join(root, "state.npz")
    o_eng.save_generation_state(state)
    o_eng.reset()
    reset_counters()
    rest = o_eng.resume_generate(state, 16).cpu()[0].tolist()
    counts = counters()
    del o_eng
    if first + rest != full or counts["decode_layers"] != 16:
        raise AssertionError(f"resume: first + rest parts from the stream at token "
                             f"{first_diff(first + rest, full)}, launches {counts}")
    out["resume"] = {"cache": "bfloat16", "first": 8, "rest": 16, "launches": counts,
                     "state_mb": os.path.getsize(state) / 1e6, "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with trace(os.path.join(root, "trace")):
        t_eng.generate_tokens(prompt, 8)
    text = open(trace.last).read()
    named = {k: k in text for k in ("decode_gemv_kernel", "decode_attn_kernel",
                                    "flash_prefill", "argmax_head")}
    if not all(named.values()):
        raise AssertionError(f"the profiler trace misses the port's kernels: {named}")
    out["trace"] = {"file_mb": os.path.getsize(trace.last) / 1e6, "names": named,
                    "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    lines = []
    toks = debug_trace_generate(t_eng, prompt, 8, emit=lines.append)[0].tolist()
    if toks != toks_k[:8]:
        raise AssertionError(f"debug_trace_generate's tokens {toks} differ from the "
                             f"kernel stream {toks_k[:8]}")
    out["debug_trace_generate"] = {"tokens_equal": 8, "lines": len(lines),
                                   "s": time.perf_counter() - t0}
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "tooling", "model": "stories15M, tinyllama-1.1b", **out})


# ---------------------------------------------------------------------------
# LoRA, training, perplexity and data (ROADMAP A7, A8)
# ---------------------------------------------------------------------------

# tests/test_multilora.py's targets: the q/k/v deltas (after the rounding)
# and the o-projection and FFN callbacks (before it) both run.
LORA_TARGETS = ("wq", "wv", "w_gate", "w_down")


def card_adapters(torch, args, n: int = 3, rank: int = 16, alpha: float = 32.0,
                  b_scale: float = 1e-3):
    """n adapters on LORA_TARGETS: A from `init_lora` (seed i), B seeded
    normals x b_scale made on the card (a fresh B is zero, which would
    serve the base model), so each delta is a few per cent of its base
    product (`lora_delta_share` measures it)."""
    from llama3np_tpu_torch.lora import init_lora

    out = []
    for i in range(n):
        lora = init_lora(args, rank=rank, alpha=alpha, targets=LORA_TARGETS, seed=i,
                         device="cuda")
        g = torch.Generator("cuda").manual_seed(1000 + i)
        lora["layers"] = {k: v if k.endswith("_a") else
                          torch.randn(v.shape, generator=g, device="cuda") * b_scale
                          for k, v in lora["layers"].items()}
        out.append(lora)
    return out


def lora_delta_share(torch, eng, lora, prompt) -> dict:
    """|scale * (x@A)@B| / |x@W| (Frobenius) of each adapted target at layer
    0, on the prompt's normed embeddings (w_down on the SwiGLU of them)."""
    import torch.nn.functional as F

    from llama3np_tpu_torch.models.llama import embed_tokens
    from llama3np_tpu_torch.ops import core as ops

    lp = {k: v[0] for k, v in eng.params["layers"].items()}
    ll = {k: v[0] for k, v in lora["layers"].items()}
    scale = lora["alpha"] / lora["rank"]
    with torch.inference_mode():
        x = ops.rms_norm(embed_tokens(eng.params, torch.as_tensor(prompt, device="cuda")),
                         lp["attn_norm"], eng.args.norm_eps)
        inputs = {"wq": x, "wv": x, "w_gate": x,
                  "w_down": (F.silu(ops._dot(x, lp["w_gate"])) * ops._dot(x, lp["w_up"]))
                  .to(x.dtype)}
        out = {}
        for t, xin in inputs.items():
            base = ops._dot(xin, lp[t])
            delta = scale * ops._dot(ops._dot(xin, ll[t + "_a"]).to(xin.dtype), ll[t + "_b"])
            out[t] = (delta.norm() / base.norm()).item()
    return out


def multilora_phase(torch, eng, limit, card):
    """(a) llama3-8b multi-LoRA serving in bf16 at full width and depth.

    The split engine is `Llama.split_view` of the loaded fused engine (views
    of wqkv and wgu: no second copy of the weights).  Three adapters (rank
    16, alpha 32, LORA_TARGETS); the 12 requests of `serve_workload` go
    round-robin to no adapter and adapters 0, 1 and 2, served paged at
    quanta 1 and 4.  Gates: each stream equals its capacity-1 stream
    through the same adapter (near-tie rule under `limit`); exact launch
    counts (flash once a layer an admission, the paged kernel once a layer
    a decode step) and all pages back; the no-adapter rows equal the same
    workload served without a bank (near-tie rule); one adapter's solo
    stream equals the plain path's (`plain_twin`, near-tie rule against the
    plain path's margins).  Then the HTTP server over a banked engine with
    adapter names: a streamed request naming an adapter (its solo stream,
    near-tie rule) and one naming an unknown adapter (400).  Reports the
    served tok/s and ms a step with and without the bank.  Returns the
    launch counts of each run."""
    from llama3np_tpu_torch.server import serve as http_serve
    from llama3np_tpu_torch.serving import BatchEngine

    split = eng.split_view()
    args, nl = split.args, split.args.n_layers
    ads = card_adapters(torch, args)
    workload = serve_workload(args.vocab_size)
    assign = [(None, 0, 1, 2)[i % 4] for i in range(len(workload))]
    shares = lora_delta_share(torch, split, ads[0], workload[0][0][:64])
    solo, gaps = solo_serve(split, workload, None, margins=True, adapters=ads, assign=assign)
    out, timings, streams = {}, {}, {}
    for bank, runs in ((True, (("q1", 1), ("q4", 4))), (False, (("q1", 1), ("q4", 4)))):
        for run, quantum in runs:
            reset_counters()  # the main path: multi-LoRA serving through the kernels
            got, st = serve(torch, split, workload, quantum, adapters=ads if bank else None,
                            assign=assign if bank else None)
            counts = counters()
            expect = {"flash_prefill": nl * st["admissions"], "decode_layers": 0,
                      "paged_attention": nl * st["decode_steps"], "argmax_head": 0}
            what = f"llama3-8b multi-LoRA {run} bank={bank}"
            if counts != expect or st["admissions"] != len(workload):
                raise AssertionError(f"{what} launch counts {counts}, expected {expect}")
            rows = [i for i, a in enumerate(assign) if bank or a is None]
            rules = [near_tie(got[i], solo[i], lambda j, m=gaps[i]: m[j], limit,
                              f"{what} request {i}") for i in rows]
            name = ("multilora_" if bank else "split_") + run
            out[name], timings[name], streams[name] = counts, st, got
            emit({"phase": "e2e", "model": "llama3-8b", "path": "multilora" if bank
                  else "serving-split", "dtype": "bfloat16", "run": run, **st,
                  "adapters": len(ads) if bank else 0, "assign": assign if bank else None,
                  "launches": counts, "checked_rows": len(rows),
                  "streams_equal_solo": sum(r["first_diff"] is None for r in rules),
                  "near_ties": [dict(request=i, **r) for i, r in zip(rows, rules)
                                if r["first_diff"] is not None],
                  "near_tie_limit": limit, "pages_leaked": 0, "card": card})
    # The no-adapter rows of the banked runs against the bank-less runs.
    base_rows = [i for i, a in enumerate(assign) if a is None]
    for run in ("q1", "q4"):
        for i in base_rows:
            near_tie(streams["multilora_" + run][i], streams["split_" + run][i],
                     lambda j, m=gaps[i]: m[j], limit, f"no-adapter row {i} {run}")
    # One adapter's solo stream against the plain path.
    k = assign.index(0)
    plain, pgaps = solo_serve(plain_twin(split), workload[k : k + 1], None, margins=True,
                              adapters=ads, assign=[0])
    plain_rule = near_tie(solo[k], plain[0], lambda j: pgaps[0][j], limit,
                          "multi-LoRA solo vs the plain path")

    # The HTTP server over a banked engine: a named adapter, an unknown one.
    be = BatchEngine(split, capacity=8, paged=True, page_size=16, adapters=ads)
    srv = http_serve(be, None, "127.0.0.1", 0, quantum=4, adapter_names=["a0", "a1", "a2"])
    port = srv.server_address[1]
    r = assign.index(1)
    try:
        status, events, t_first, _ = http_call(
            port, "/v1/completions", {"prompt_ids": workload[r][0], "max_tokens": 16,
                                      "stop_ids": list(STOP_IDS), "adapter": "a1",
                                      "stream": True}, stream=True)
        ids = [t for e in events for t in e["choices"][0]["token_ids"]]
        bad_status, bad = http_call(port, "/v1/completions",
                                    {"prompt_ids": [1, 2, 3], "adapter": "nope"})
    finally:
        srv.shutdown()
        srv.loop.shutdown()
        srv.server_close()
    if status != 200 or t_first is None or bad_status != 400 or "unknown adapter" not in \
            bad.get("error", ""):
        raise AssertionError(f"multi-LoRA server: {status} {bad_status} {bad}")
    server_rule = near_tie(ids, solo[r][:16], lambda j: gaps[r][j], limit,
                           "multi-LoRA server stream")
    if be.allocator.available != be.allocator.num_pages - 1:
        raise AssertionError("multi-LoRA server: pages leaked")
    bank_mb = sum(v.numel() * v.element_size() for v in be.lora_bank["layers"].values()) / 1e6
    del be, srv
    import gc
    gc.collect()  # the server's engine thread and pools hold reference cycles
    torch.cuda.empty_cache()
    t = timings
    emit({"phase": "multilora", "model": "llama3-8b", "dtype": "bfloat16",
          "adapters": len(ads), "rank": ads[0]["rank"], "alpha": ads[0]["alpha"],
          "targets": list(LORA_TARGETS), "delta_share_layer0": shares, "bank_mb": bank_mb,
          "served_tok_s": {k: v["served_tok_s"] for k, v in t.items()},
          "ms_per_step": {k: v["ms_per_step"] for k, v in t.items()},
          "bank_cost_ms_per_step": {q: t["multilora_" + q]["ms_per_step"]
                                    - t["split_" + q]["ms_per_step"] for q in ("q1", "q4")},
          "no_adapter_rows_equal_bankless": len(base_rows), "plain_twin": plain_rule,
          "server": {"status": status, "ttft_s": t_first, "stream": server_rule,
                     "unknown_adapter_status": bad_status},
          "near_tie_limit": limit, "card": card})
    return split, out


def shard_batches(torch, path: str, vocab: str, docs: int, chars: int, seed: int):
    """A token shard the script writes (`pack_documents` over seeded
    letter-and-space documents, tokenized with the synthetic vocabulary
    `vocab`) and its `TokenDataset`."""
    import numpy as np

    from llama3np_tpu_torch import Tokenizer
    from llama3np_tpu_torch.data import TokenDataset, pack_documents

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz      ")
    texts = ["".join(rng.choice(letters, size=chars)) for _ in range(docs)]
    n = pack_documents(texts, Tokenizer(vocab), path)
    return TokenDataset(path), n


def leaf_checksum(torch, t) -> tuple:
    """A checksum of a 16-bit tensor's bits: the sum and the sum of squares
    of its words, to show a frozen leaf is unchanged."""
    w = t.contiguous().view(torch.int16).reshape(-1).int()
    return int(w.sum(dtype=torch.int64)), int((w * w).sum(dtype=torch.int64))


def lora_train_phase(torch, split, vocab, card, steps: int = 8, L: int = 512):
    """(b) llama3-8b LoRA fine-tuning in bf16 at full width and depth: the
    split view's weights frozen, one adapter on DEFAULT_TARGETS (rank 16),
    `make_lora_train_step` with AdamW (lr 1e-3) and remat, B=1, L=512, on
    the first 2 batches of a `TokenDataset` shard the script writes,
    alternating, for 8 steps.  Gates: every loss finite, the loss on batch
    0 after the steps below step 0's, the base leaves' checksums unchanged,
    no kernel launched (training runs the plain ops, as the JAX package's
    does).  Reports ms a step, tokens/s and the peak device memory."""
    from llama3np_tpu_torch.lora import (DEFAULT_TARGETS, init_lora, lora_loss,
                                         make_lora_train_step)
    from llama3np_tpu_torch.train import init_optimizer

    args = split.args
    ds, n_tok = shard_batches(torch, os.path.join(REPO, "build", "smoke", "lora8b.bin"),
                              vocab, docs=2, chars=3000, seed=5)
    batches = [torch.as_tensor(b, device="cuda")
               for b, _ in zip(ds.batches(1, L, shuffle=False, epochs=1), range(2))]
    params = split.params
    leaves = {"layers.wq": params["layers"]["wq"], "layers.w_down": params["layers"]["w_down"],
              "lm_head": params["lm_head"], "tok_embedding": params["tok_embedding"],
              "layers.attn_norm": params["layers"]["attn_norm"]}
    before = {k: leaf_checksum(torch, v) for k, v in leaves.items()}
    weights_gb = sum(t.numel() * t.element_size() for t in
                     [params["tok_embedding"], params["lm_head"], params["norm"],
                      *params["layers"].values()]) / 1e9
    cfg = split.cfg  # rope_split: the engine's permuted weights and tables
    lora = init_lora(args, rank=16, alpha=32.0, targets=DEFAULT_TARGETS, seed=0,
                     device="cuda")
    scale = lora["alpha"] / lora["rank"]
    ly = lora["layers"]
    opt, st = init_optimizer(ly, learning_rate=1e-3)
    step = make_lora_train_step(opt, cfg, scale, remat=True)
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    reset_counters()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        ly, st, loss = step(ly, st, params, batches[i % 2], split.cos, split.sin)
        losses.append(float(loss))  # syncs
        times.append(time.perf_counter() - t0)
    with torch.no_grad():
        after0 = float(lora_loss(ly, params, batches[0], split.cos, split.sin, cfg, scale))
    counts = counters()
    peak = torch.cuda.max_memory_allocated()
    after = {k: leaf_checksum(torch, v) for k, v in leaves.items()}
    import math
    if not all(math.isfinite(x) for x in losses + [after0]):
        raise AssertionError(f"8B LoRA losses not finite: {losses} {after0}")
    if not after0 < losses[0]:
        raise AssertionError(f"8B LoRA: batch 0's loss {after0} after {steps} steps is not "
                             f"below step 0's {losses[0]}")
    if after != before:
        raise AssertionError("8B LoRA: the frozen base changed")
    if any(counts.values()):
        raise AssertionError(f"8B LoRA training launched kernels: {counts}")
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    emit({"phase": "e2e", "model": "llama3-8b", "path": "lora-train", "dtype": "bfloat16",
          "targets": list(DEFAULT_TARGETS), "rank": 16, "alpha": 32.0, "lr": 1e-3,
          "remat": True, "batch": 1, "seq_len": L, "steps": steps, "shard_tokens": n_tok,
          "losses": losses, "loss_batch0_after": after0,
          "adapter_params": sum(v.numel() for v in ly.values()),
          "ms_per_step": step_ms, "first_step_ms": 1e3 * times[0],
          "tokens_per_s": L / (step_ms / 1e3),
          "peak_memory_gb": peak / 1e9, "resident_before_gb": base_alloc / 1e9,
          "training_peak_gb": (peak - base_alloc) / 1e9, "base_weights_gb": weights_gb,
          "base_checksums_equal": len(before), "launches": counts, "card": card})
    del opt, st, ly, lora
    torch.cuda.empty_cache()


def perplexity_phase(torch, smoke, eng, card, batch: int = 8):
    """(c) llama3-8b perplexity in bf16: `Scorer` over the loaded fused
    engine (its forward runs `flash_prefill`, once a layer a batch), 16
    seeded sequences of 17-1000 tokens, batch 8.  Gates: each batch's
    per-token log-probabilities against the plain twin's on the same
    padded batch, and each sequence's log-probabilities scored alone at
    its own length (no padding) against the batched ones, within
    2 x E8B_ENVELOPE x max(1, max |logits|) (a log-probability is a logit
    less a log-sum-exp, each within the bf16 envelope of
    tests/test_dtype.py); the launch counts.  Reports scored tokens/s of
    the kernel path and the plain path.  Returns the launch count."""
    import numpy as np

    from llama3np_tpu_torch.eval import Scorer

    args = eng.args
    shape = (args.n_heads, args.kv_heads, args.head_dim)
    for L in (8, 16):  # the Scorer's smallest buckets, at its batch of 8
        smoke.flash_phase("llama3-8b", batch, L, *shape, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    lens = rng.integers(17, 1001, size=16)
    lens[:2] = (17, 1000)
    seqs = [[1] + rng.integers(3, args.vocab_size, size=int(n) - 1).tolist() for n in lens]
    twin = plain_twin(eng)
    # The limit: the plain path's largest logit at a prompt's last position.
    logits = torch.from_numpy(twin(np.asarray([seqs[1][:64]]), 0))
    limit = 2 * E8B_ENVELOPE * max(1.0, logits.abs().max().item())
    sc, ptw = Scorer(eng, batch_size=batch), Scorer(twin, batch_size=batch)
    sc.score(seqs[:batch])  # warm
    torch.cuda.synchronize()
    reset_counters()  # the main path: scoring through flash prefill
    t0 = time.perf_counter()
    nll, cnt = sc.score(seqs)
    wall = time.perf_counter() - t0
    counts = counters()
    n_batches = -(-len(seqs) // batch)
    if counts != {"flash_prefill": args.n_layers * n_batches, "decode_layers": 0,
                  "paged_attention": 0, "argmax_head": 0}:
        raise AssertionError(f"perplexity launch counts {counts}")
    t0 = time.perf_counter()
    pnll, pcnt = ptw.score(seqs)
    plain_wall = time.perf_counter() - t0
    # Per-token log-probabilities of each padded batch, kernels against the
    # plain twin; and each sequence alone at its own length.
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    err_twin = err_alone = 0.0
    for start in range(0, len(order), batch):
        idxs = order[start : start + batch]
        Lb = sc._bucket(max(len(seqs[i]) for i in idxs))
        ids = torch.zeros((batch, Lb), dtype=torch.long)
        for j, i in enumerate(idxs):
            ids[j, : len(seqs[i])] = torch.tensor(seqs[i])
        ids = ids.to("cuda")
        lp, plp = sc._score_impl(ids), ptw._score_impl(ids)
        for j, i in enumerate(idxs):
            n = len(seqs[i]) - 1
            err_twin = max(err_twin, (lp[j, :n] - plp[j, :n]).abs().max().item())
            alone = sc._score_impl(torch.tensor([seqs[i]], device="cuda"))[0]
            err_alone = max(err_alone, (lp[j, :n] - alone).abs().max().item())
    if not (err_twin < limit and err_alone < limit) or not np.isfinite(nll).all() or \
            list(cnt) != list(pcnt):
        raise AssertionError(f"perplexity: per-token err vs plain {err_twin}, padded vs "
                             f"alone {err_alone}, limit {limit}")
    tokens = int(cnt.sum())
    emit({"phase": "e2e", "model": "llama3-8b", "path": "perplexity", "dtype": "bfloat16",
          "sequences": len(seqs), "batch": batch, "lens": [int(x) for x in lens],
          "scored_tokens": tokens, "ppl": float(np.exp(nll.sum() / tokens)),
          "ppl_plain": float(np.exp(pnll.sum() / tokens)),
          "lp_max_abs_err_vs_plain": err_twin, "lp_max_abs_err_padded_vs_alone": err_alone,
          "lp_limit": limit, "wall_s": wall, "scored_tok_s": tokens / wall,
          "plain_scored_tok_s": tokens / plain_wall, "launches": counts, "card": card})
    return counts["flash_prefill"]


def train_tree(torch, weights, args, device):
    """The training layout (`train.forward_train`): the split float32 tree
    with interleaved RoPE, on `device`, with its config and tables."""
    from llama3np_tpu_torch.checkpoint import build_param_tree, params_to_device
    from llama3np_tpu_torch.models.llama import StaticConfig
    from llama3np_tpu_torch.ops.core import rope_tables

    params = params_to_device(build_param_tree(weights, args), device, "float32")
    if torch.device(device).type == "cpu":  # own copies: a step trains them in place
        params = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
                  for k, v in params.items()}
    cfg = StaticConfig.from_args(args, device)._replace(fused=False, rope_split=False)
    cos, sin = rope_tables(args.head_dim, args.max_seq_len, args.rope_theta, device=device)
    return params, cfg, cos, sin


def full_train_phase(torch, weights, args, vocab, card, B: int = 4, L: int = 256,
                     steps: int = 8):
    """(d) tinyllama-1.1b full-model training in float32 (TF32 off) at full
    width: `pack_documents` over the synthetic vocabulary, a
    `TokenDataset`, `prefetch_to_device` onto the card, `make_train_step`
    (AdamW, lr 1e-3), B=4, L=256, 8 steps.  Gates: step 0's loss equals
    `next_token_loss` of its batch (rtol 2e-4 / atol 1e-4), the loss falls,
    every gradient finite, no kernel launched.  Reports ms a step,
    tokens/s, peak device memory (parameters, gradients and both moments:
    16 bytes a parameter)."""
    import math

    from llama3np_tpu_torch.data import prefetch_to_device
    from llama3np_tpu_torch.train import init_optimizer, make_train_step, next_token_loss

    ds, n_tok = shard_batches(torch, os.path.join(REPO, "build", "smoke", "tiny.bin"),
                              vocab, docs=8, chars=3000, seed=9)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params, cfg, cos, sin = train_tree(torch, weights, args, "cuda")
    n_params = sum(p.numel() for p in [params["tok_embedding"], params["norm"],
                                       params["lm_head"], *params["layers"].values()])
    opt, st = init_optimizer(params, learning_rate=1e-3)
    step = make_train_step(opt, cfg)
    losses, times, first_check = [], [], None
    reset_counters()
    it = prefetch_to_device(ds.batches(B, L, seed=0, epochs=None), size=2, device="cuda")
    for i, batch in zip(range(steps), it):
        if i == 0:
            with torch.no_grad():
                first_check = float(next_token_loss(params, batch, cos, sin, cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, loss = step(params, st, batch, cos, sin)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(p.grad).all()) for g in opt.param_groups
                   for p in g["params"]):
            raise AssertionError(f"tinyllama training: a gradient is not finite at step {i}")
    counts = counters()
    peak = torch.cuda.max_memory_allocated()
    if abs(losses[0] - first_check) > 1e-4 + 2e-4 * abs(first_check):
        raise AssertionError(f"tinyllama step 0 loss {losses[0]} vs next_token_loss "
                             f"{first_check}")
    if not (all(math.isfinite(x) for x in losses) and
            sum(losses[-2:]) / 2 < losses[0] - 0.1):
        raise AssertionError(f"tinyllama training loss does not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"tinyllama training launched kernels: {counts}")
    step_ms = 1e3 * sum(times[1:]) / (steps - 1)
    emit({"phase": "e2e", "model": "tinyllama-1.1b", "path": "train", "dtype": "float32",
          "tf32": torch.backends.cuda.matmul.allow_tf32, "batch": B, "seq_len": L,
          "steps": steps, "lr": 1e-3, "shard_tokens": n_tok, "losses": losses,
          "step0_vs_next_token_loss": abs(losses[0] - first_check),
          "params": n_params, "ms_per_step": step_ms, "first_step_ms": 1e3 * times[0],
          "tokens_per_s": B * L / (step_ms / 1e3), "peak_memory_gb": peak / 1e9,
          "resident_before_gb": resident / 1e9, "launches": counts, "card": card})
    del opt, st, params
    torch.cuda.empty_cache()


def train_card_vs_cpu_phase(torch, weights, args, card, steps: int = 3, lr: float = 1e-3):
    """Three `make_train_step` steps of stories15M in float32 on the card
    and on the CPU, on the same seeded batches.  The losses of every step
    and the gradients of every step agree to rtol 2e-4 / atol 1e-4; at
    step 0 (the same parameters on both sides) each leaf's gradient also
    agrees normwise within 1e-4 (float32 sums in another order; TF32
    would leave ~1e-3).  The parameters after the steps agree to rtol 2e-4 /
    atol 1e-4, except where AdamW's update follows rounding noise: its
    first update of an element is lr * g / (|g| + 1e-8), about a sign, and
    where g is what is left of a cancelling sum the two devices disagree on
    it beyond its first digit (|g_card - g_cpu| > 0.1 |g_cpu| at some
    step), so the update may go either way.  Those elements are counted and
    held to the most AdamW can move them apart: 2 lr a step."""
    import numpy as np

    from llama3np_tpu_torch.train import init_optimizer, make_train_step, tree_leaves

    rng = np.random.default_rng(4)
    batches = [rng.integers(3, args.vocab_size, size=(2, 65)) for _ in range(steps)]
    out = {}
    for dev in ("cuda", "cpu"):
        params, cfg, cos, sin = train_tree(torch, weights, args, dev)
        opt, st = init_optimizer(params, learning_rate=lr)
        step = make_train_step(opt, cfg)
        losses, grads = [], []
        for b in batches:
            params, st, loss = step(params, st, torch.as_tensor(b, device=dev), cos, sin)
            losses.append(float(loss))
            grads.append([p.grad.detach().cpu().clone() for p in tree_leaves(params)])
        out[dev] = losses, grads, [p.detach().cpu() for p in tree_leaves(params)]
    compare(torch, torch.tensor(out["cuda"][0]), torch.tensor(out["cpu"][0]), 2e-4, 1e-4,
            "stories15M card vs CPU losses")
    grad_err, grad_norm_err = 0.0, [0.0] * steps
    for s in range(steps):
        for a, b in zip(out["cuda"][1][s], out["cpu"][1][s]):
            grad_err = max(grad_err, compare(torch, a, b, 2e-4, 1e-4,
                                             "stories15M card vs CPU gradients")[0])
            grad_norm_err[s] = max(grad_norm_err[s], ((a - b).norm() / b.norm()).item())
    if not grad_norm_err[0] < 1e-4:
        raise AssertionError(f"stories15M card vs CPU step-0 gradients: normwise "
                             f"{grad_norm_err[0]}")
    noisy, worst, worst_noisy = 0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(out["cuda"][2], out["cpu"][2])):
        mask = torch.zeros_like(b, dtype=torch.bool)
        for s in range(steps):
            g = out["cpu"][1][s][i]
            mask |= (out["cuda"][1][s][i] - g).abs() > 0.1 * g.abs()
        noisy += int(mask.sum())
        worst = max(worst, compare(torch, a[~mask], b[~mask], 2e-4, 1e-4,
                                   "stories15M card vs CPU params")[0])
        if mask.any():
            worst_noisy = max(worst_noisy, (a[mask] - b[mask]).abs().max().item())
    if not worst_noisy <= 2 * lr * steps * (1 + 1e-4):
        raise AssertionError(f"stories15M card vs CPU: {noisy} noise-bound elements, max "
                             f"abs err there {worst_noisy}, past 2 lr a step")
    emit({"phase": "train-card-vs-cpu", "model": "stories15M", "steps": steps, "lr": lr,
          "losses_card": out["cuda"][0], "losses_cpu": out["cpu"][0],
          "grads_max_abs_err": grad_err, "grads_normwise_err_by_step": grad_norm_err,
          "params_max_abs_err": worst, "params": sum(p.numel() for p in out["cpu"][2]),
          "noise_bound_elements": noisy, "noise_bound_max_abs_err": worst_noisy,
          "tol": {"rtol": 2e-4, "atol": 1e-4, "step0_grads_normwise": 1e-4}, "card": card})


# ROADMAP A9: llama3-70b at its published widths, depth cut to 2 of 80
# layers and max_seq_len to 2048, in bf16, over two ranks on the one card.
A9_ARGS = dict(n_layers=2, max_seq_len=2048)
A9_TOKENS = 32


def card_split_tree(torch, args, seed: int = 0, scale: float = 0.02):
    """The split parameter tree of `args` in its dtype, made on the card from
    a seeded card generator (weights normal x scale, norms 1 + that): the
    tree `Llama.from_param_tree` and the ranks' shards read.  Its wq/wk
    columns are taken as already in the split-halves RoPE layout (a
    permutation of random columns is random columns)."""
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, args.dtype)
    nl, d, fd, vs = args.n_layers, args.dim, args.hidden_dim, args.vocab_size
    qd, kvd = args.n_heads * args.head_dim, args.kv_heads * args.head_dim

    def w(*shape):
        out = torch.empty(shape, dtype=dt, device="cuda")
        for i in range(shape[0]):  # one f32 slab at a time
            out[i] = (torch.randn(shape[1:], generator=g, device="cuda") * scale).to(dt)
        return out

    def norm(*shape):
        return (1 + scale * torch.randn(shape, generator=g, device="cuda")).to(dt)

    return {"tok_embedding": w(vs, d),
            "layers": {"wq": w(nl, d, qd), "wk": w(nl, d, kvd), "wv": w(nl, d, kvd),
                       "wo": w(nl, qd, d), "w_gate": w(nl, d, fd), "w_up": w(nl, d, fd),
                       "w_down": w(nl, fd, d), "attn_norm": norm(nl, d),
                       "ffn_norm": norm(nl, d)},
            "norm": norm(d), "lm_head": w(d, vs)}


def a9_rank(rank: int, device: str, tree, args, prompt, batch, workload, n_tok: int):
    """One of two ranks on the card (gloo; spawned by `parallel.launch`
    with the parent's tree through CUDA IPC): a tp=2 engine's logits,
    greedy tokens and serving streams (paged, quanta 1 and 4, bf16 and int8
    pools) with each kernel's launches on this rank, its decode and step
    times, the all-reduces a token and their time; then a pp=2 pipeline's
    tokens in both schedules and its stage's weight bytes."""
    import numpy as np
    import torch

    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.observability import timed_generate
    from llama3np_tpu_torch.parallel.pipeline import PipelinedLlama, make_pp_mesh
    from llama3np_tpu_torch.parallel.sharding import make_mesh

    out = {"rank": rank}
    t0 = time.perf_counter()
    mesh = make_mesh(1, 2, backend="gloo", device=device)
    eng = Llama.from_param_tree(tree, args, mesh=mesh)
    torch.cuda.synchronize()
    out.update(tp_load_s=time.perf_counter() - t0, tp_weight_bytes=weight_bytes(eng.params),
               tp_local_heads=(eng.cfg.n_heads, eng.cfg.kv_heads))
    out["tp_logits"] = eng(prompt, 0)[0, -1]
    reduces = []
    all_reduce = mesh.all_reduce

    def counted(t, axis):
        reduces.append(tuple(t.shape))
        return all_reduce(t, axis)

    mesh.all_reduce = counted
    reset_counters()
    out["tp_tokens"] = eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    out["tp_generate_launches"] = counters()
    mesh.all_reduce = all_reduce
    out["tp_all_reduces_a_token"] = len(reduces) / n_tok  # the prefill's count too
    out["tp_all_reduce_shapes"] = sorted(set(reduces))
    _, st = timed_generate(eng, prompt, n_tok)
    out["tp_prefill_ms"], out["tp_decode_tok_s"] = st.prefill_ms, st.decode_tok_s
    ar = {}  # host clock: gloo stages a CUDA tensor through the host
    for name, shape in (("hidden", (1, 1, args.dim)), ("logits", (1, args.vocab_size))):
        t = torch.ones(shape, device=device)
        for _ in range(3):
            all_reduce(t, "tp")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            all_reduce(t, "tp")
        torch.cuda.synchronize()
        ar[name] = (time.perf_counter() - t0) * 1e3 / 20
    out["all_reduce_ms"] = ar
    out["serve"] = {}
    for run, quantum, kv in (("q1", 1, None), ("q4", 4, None),
                             ("q1_int8", 1, "int8"), ("q4_int8", 4, "int8")):
        reset_counters()
        streams, st = serve(torch, eng, workload, quantum, kv_quant=kv)
        out["serve"][run] = {"streams": streams, "stats": st, "launches": counters()}
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pp = PipelinedLlama.from_param_tree(tree, args, make_pp_mesh(2, backend="gloo",
                                                                 device=device))
    torch.cuda.synchronize()
    out.update(pp_load_s=time.perf_counter() - t0, pp_stage_bytes=pp.stage_param_bytes())
    for key, mb in (("pp", False), ("pp_mb", True)):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[key + "_tokens"] = pp.generate_tokens(batch, n_tok, microbatched=mb).cpu().tolist()
        torch.cuda.synchronize()
        out[key + "_s"] = time.perf_counter() - t0
        out[key + "_launches"] = counters()
    del pp
    torch.cuda.empty_cache()
    return out


def parallel_phase(torch, smoke, card):
    """ROADMAP A9 on the card: llama3-70b's widths (D=8192, 64 heads over 8
    KV heads, HD=128, FD=28672, VS=128,256) at 2 of its 80 layers, bf16.
    The split tree is made once on the card; the parent's single-rank
    engine over it is the reference, and two ranks spawned on the same
    card (gloo: NCCL refuses two ranks on one device) take their shards of
    it through CUDA IPC (`a9_rank`).  tp=2: greedy generation of a
    500-token prompt and 32 tokens (logits within the bf16 envelope of the
    reference's, the stream equal or parted at a near-tie, both ranks'
    tokens equal) and paged serving of `serve_workload` at quanta 1 and 4
    over bf16 and int8 pools (each stream against the reference's
    capacity-1 stream by the same rule; flash once a layer an admission
    and the paged kernel once a layer a step, on each rank; all pages
    back).  pp=2 (one layer a stage), B=2, both schedules, against the
    reference.  The kernels at a rank's shapes (NH/2 = 32 query heads over
    KVH/2 = 4) against their twins.  One card shows correctness and the
    per-rank costs, not scaling: the two ranks share its SMs and HBM, and
    their collectives cross the host (gloo), not NVLink.  Returns the
    kernel rows and their launches."""
    import numpy as np

    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.models.llama import Llama
    from llama3np_tpu_torch.parallel.launch import launch

    t_start = time.perf_counter()
    args = preset("llama3-70b", **A9_ARGS)
    nl, bf16 = args.n_layers, torch.bfloat16
    tree = card_split_tree(torch, args)
    ref = Llama.from_param_tree(tree, args, device="cuda")
    torch.cuda.synchronize()
    whole = weight_bytes(ref.params)
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, args.vocab_size, size=(1, 500))
    batch = np.concatenate([prompt, rng.integers(3, args.vocab_size, size=(1, 500))])
    workload = serve_workload(args.vocab_size)
    ref_logits = torch.from_numpy(ref(prompt, 0)[0, -1]).float()
    ref_toks = ref.generate_tokens(prompt, A9_TOKENS).cpu()[0].tolist()
    ref_batch = ref.generate_tokens(batch, A9_TOKENS).cpu().tolist()
    solo = {kv: solo_serve(ref, workload, kv, margins=True) for kv in (None, "int8")}
    ref_s = time.perf_counter() - t_start

    local = (args.n_heads // 2, args.kv_heads // 2, args.head_dim)
    rows = {"flash_prefill": smoke.flash_phase("llama3-70b tp=2 rank", 1, 512, *local,
                                               dtype=bf16),
            "paged_attention": smoke.paged_phase(
                "llama3-70b tp=2 rank", 8, *local, 16, args.max_seq_len // 16,
                [0, 15, 16, 255, 500, 1023, 1500, 2047], dtype=bf16)}

    t0 = time.perf_counter()
    ranks = launch(a9_rank, 2, (tree, args, prompt, batch, workload, A9_TOKENS),
                   backend="gloo", devices=["cuda:0", "cuda:0"], timeout_s=600)
    ranks_s = time.perf_counter() - t0

    def margin_at(ctx_row):
        def at(i, toks):
            ctx = np.array([list(ctx_row) + toks[:i]])
            top = torch.from_numpy(ref(ctx, 0))[0, -1].float().topk(2).values
            return float(top[0] - top[1])
        return at

    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("tp_tokens", "pp_tokens", "pp_mb_tokens"):
            if r[key] != r0[key]:
                raise AssertionError(f"A9: rank {r['rank']}'s {key} differ from rank 0's")
        for run in r0["serve"]:
            if r["serve"][run]["streams"] != r0["serve"][run]["streams"]:
                raise AssertionError(f"A9: rank {r['rank']}'s {run} streams differ")
    logits = torch.from_numpy(r0["tp_logits"]).float()
    l_abs = (logits - ref_logits).abs().max().item()
    l_scale = max(1.0, ref_logits.abs().max().item())
    if not torch.isfinite(logits).all() or l_abs > E8B_ENVELOPE * l_scale or \
            int(logits.argmax()) != int(ref_logits.argmax()):
        raise AssertionError(f"A9 tp=2 logits: max abs err {l_abs} (envelope "
                             f"{E8B_ENVELOPE * l_scale}) or top-1 differs")
    limit = 2 * l_abs
    at = margin_at(prompt[0].tolist())
    gen_rule = near_tie(r0["tp_tokens"], ref_toks, lambda i: at(i, ref_toks), limit,
                        "A9 tp=2 greedy stream")
    pp_rules = {}
    for key in ("pp_tokens", "pp_mb_tokens"):
        pp_rules[key] = [near_tie(got, want, lambda i, a=margin_at(row.tolist()), w=want:
                                  a(i, w), limit, f"A9 pp=2 {key} row {b}")
                         for b, (got, want, row) in enumerate(zip(r0[key], ref_batch, batch))]
    serve_rows = {}
    for run, res in r0["serve"].items():
        kv = "int8" if run.endswith("int8") else None
        want, gaps = solo[kv]
        rules = [near_tie(g, w, lambda i, m=m: m[i], limit, f"A9 tp=2 serving {run} request {q}")
                 for q, (g, w, m) in enumerate(zip(res["streams"], want, gaps))]
        st = res["stats"]
        for r in ranks:
            c = r["serve"][run]["launches"]
            s = r["serve"][run]["stats"]
            expect = {"flash_prefill": nl * s["admissions"], "decode_layers": 0,
                      "paged_attention": nl * s["decode_steps"], "argmax_head": 0}
            if c != expect or s["admissions"] != len(workload):
                raise AssertionError(f"A9 rank {r['rank']} serving {run} launch counts "
                                     f"{c}, expected {expect}")
        serve_rows[run] = {"ms_per_step": [r["serve"][run]["stats"]["ms_per_step"]
                                           for r in ranks],
                           "served_tok_s": [r["serve"][run]["stats"]["served_tok_s"]
                                            for r in ranks],
                           "decode_steps": st["decode_steps"], "admissions": st["admissions"],
                           "launches": [r["serve"][run]["launches"] for r in ranks],
                           "streams_equal_solo": sum(x["first_diff"] is None for x in rules),
                           "near_ties": [dict(request=q, **x) for q, x in enumerate(rules)
                                         if x["first_diff"] is not None]}
    for r in ranks:
        g = r["tp_generate_launches"]
        if g != {"flash_prefill": nl, "decode_layers": 0, "paged_attention": 0,
                 "argmax_head": 0}:
            raise AssertionError(f"A9 rank {r['rank']} tp generation launches {g}")
        if r["pp_launches"]["flash_prefill"] != nl // 2 or \
                r["pp_mb_launches"]["flash_prefill"] != nl // 2:
            raise AssertionError(f"A9 rank {r['rank']} pp launches {r['pp_launches']}")
    emit({"phase": "a9", "model": "llama3-70b", "layers": nl, "of_layers": 80,
          "max_seq_len": args.max_seq_len, "dtype": args.dtype, "ranks": 2,
          "backend": "gloo", "ranks_on_one_card": True,
          "whole_weight_gb": whole / 1e9,
          "tp_rank_weight_gb": [r["tp_weight_bytes"] / 1e9 for r in ranks],
          "pp_stage_weight_gb": [r["pp_stage_bytes"] / 1e9 for r in ranks],
          "tp_local_heads": r0["tp_local_heads"],
          "logits_max_abs_err": l_abs, "logits_max_abs": l_scale, "near_tie_limit": limit,
          "tp_stream_vs_reference": gen_rule, "pp_streams_vs_reference": pp_rules,
          "tp_prefill_ms": [r["tp_prefill_ms"] for r in ranks],
          "tp_decode_ms_a_token": [1e3 / r["tp_decode_tok_s"] for r in ranks],
          "tp_all_reduces_a_token": r0["tp_all_reduces_a_token"],
          "tp_all_reduce_shapes": r0["tp_all_reduce_shapes"],
          "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
          "serving": serve_rows,
          "pp_s": [r["pp_s"] for r in ranks], "pp_mb_s": [r["pp_mb_s"] for r in ranks],
          "tp_generate_launches": [r["tp_generate_launches"] for r in ranks],
          "pp_launches": [r["pp_launches"] for r in ranks],
          "load_s": {"tp": [r["tp_load_s"] for r in ranks], "pp": [r["pp_load_s"] for r in ranks]},
          "reference_s": ref_s, "ranks_s": ranks_s, "card": card})
    del ref, tree
    torch.cuda.empty_cache()
    q1 = [r["serve"]["q1"]["launches"] for r in ranks]
    paths = {name: {"serve_q1": q1[0][name], "serve_q1_rank1": q1[1][name],
                    "serve_q4": r0["serve"]["q4"]["launches"][name],
                    "serve_q1_int8": r0["serve"]["q1_int8"]["launches"][name]}
             for name in ("flash_prefill", "paged_attention")}
    paths["flash_prefill"].update(generate=r0["tp_generate_launches"]["flash_prefill"],
                                  pp=r0["pp_launches"]["flash_prefill"])
    return rows, paths


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
    if len(sys.argv) >= 3 and sys.argv[1] == "--decode-ab":
        # The decode kernel of another checkout (a `git archive` of the
        # parent commit) against this one's, then nothing else.
        decode_ab(torch, sys.argv[2], card, sys.argv[3:])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--paged-ab":
        # The paged kernel of another checkout against this one's at
        # llama3-8b's shapes, then nothing else.
        paged_ab(torch, sys.argv[2], card)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--parallel":
        # The A9 phase alone (after the build), then nothing else.
        _build.KernelLibrary.get()
        rows, paths = parallel_phase(torch, Smoke(torch, card), card)
        emit({"a9_kernels": {name: {"ms": row.get("ms", row.get("modes", {}).get(
            "stacked", {}).get("ms")), "launches": paths[name]} for name, row in rows.items()}})
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--dot":
        # The plain products' two paths alone, then nothing else.
        dot_smoke = Smoke(torch, card)
        for what, M, K, N in DOT_SHAPES:
            dot_smoke.dot_phase(what, M, K, N)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-ab":
        # The greedy head and fp32 flash prefill of another checkout against
        # this one's and the library calls, then nothing else.
        kernel_ab(torch, sys.argv[2], card)
        return 0
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
    for what, M, K, N in DOT_SHAPES:
        smoke.dot_phase(what, M, K, N)

    # ---- stories15M: kernels at its shapes, then the greedy path ----------
    s_args = preset("stories15M", max_seq_len=1024)
    s_weights = synthetic_weights(s_args, seed=0)
    s_eng = Llama(s_weights, s_args, device="cuda")
    hd = s_args.head_dim
    for L in (16, 100):
        smoke.flash_phase("stories15M", 1, L, s_args.n_heads, s_args.kv_heads, hd)
        emit(flash_alternation(torch, smoke, "stories15M", L, s_args.n_heads,
                               s_args.kv_heads, hd))
    for pos in (0, 5, 1023):
        smoke.decode_phase("stories15M", s_eng.params["layers"], s_args, pos)
    smoke.argmax_phase("stories15M", s_eng.params["lm_head"])
    s_q8 = Llama(s_weights, s_args.replace(quant="int8"), device="cuda")
    for pos in (0, 5, 1023):
        smoke.decode_phase("stories15M", s_q8.params["layers"], s_args, pos)
    del s_q8

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
    s_stream = got
    if s_counts != {"flash_prefill": s_args.n_layers, "decode_layers": n_check - 1,
                    "paged_attention": 0, "argmax_head": n_check - 1}:
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
    for quant in (False, True):
        smoke.paged_phase("stories15M", 4, s_args.n_heads, s_args.kv_heads, hd, 16,
                          s_args.max_seq_len // 16, [0, 100, 511, 1023], over_row=1,
                          quant=quant)

    # ---- tinyllama-1.1b at full width, TINY_LAYERS of its 22 layers -------
    t_args = preset("tinyllama-1.1b", n_layers=TINY_LAYERS)
    t_weights = synthetic_weights(t_args, seed=0)
    t_eng = Llama(t_weights, t_args, device="cuda")
    flash_row = smoke.flash_phase("tinyllama-1.1b", 1, 512, t_args.n_heads,
                                  t_args.kv_heads, t_args.head_dim)
    emit(flash_alternation(torch, smoke, "tinyllama-1.1b", 512, t_args.n_heads,
                           t_args.kv_heads, t_args.head_dim))
    smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 0)
    decode_row = smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 511)
    head_row = smoke.argmax_phase("tinyllama-1.1b", t_eng.params["lm_head"])
    emit(head_alternation(torch, smoke, "tinyllama-1.1b", t_eng.params["lm_head"]))

    prompt = np.random.default_rng(0).integers(3, t_args.vocab_size, size=(1, 500))
    n_tok = 32
    reset_counters()  # the main path: greedy generation through the kernels
    toks_k = t_eng.generate_tokens(prompt, n_tok).cpu()[0].tolist()
    main_counts = counters()
    if main_counts != {"flash_prefill": t_args.n_layers, "decode_layers": n_tok - 1,
                       "paged_attention": 0, "argmax_head": n_tok - 1}:
        raise AssertionError(f"tinyllama launch counts {main_counts}")
    logits_k = torch.from_numpy(t_eng(prompt, 0))  # ragged L=500 prefill
    k_stats = timed_generate(t_eng, prompt, 64)[1]
    emit(profile_phase(torch, "tinyllama-1.1b", t_eng, prompt, card))
    # Sampled generation through the decode kernel, against the plain path.
    t_sampled = sampled_vs_plain(torch, "tinyllama-1.1b", t_eng, prompt, n_tok, card,
                                 dtype="float32")
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

    # ---- speculation, the split layout and int4 (ROADMAP A4-A5) -------------
    workload = serve_workload(t_args.vocab_size)
    a45_paths = split_int4_phases(torch, t_eng, t_weights, prompt, toks_k, logits_k,
                                  2 * l_abs, workload, card)

    # ---- the host tooling: converted checkpoints, resume, traces (A6) -------
    tooling_phases(torch, card, s_weights, s_args, s_stream, t_eng, t_weights, prompt,
                   toks_k)
    del t_eng
    torch.cuda.empty_cache()

    # ---- the CLI ------------------------------------------------------------
    vocab = synthetic_vocab(os.path.join(REPO, "build", "smoke", "vocab.json"),
                            preset("stories15M").vocab_size)
    for dtype in ("float32", "bfloat16"):  # bfloat16: the kernels' bf16 modes
        cli = subprocess.run(
            [sys.executable, "-m", "llama3np_tpu_torch.cli", "--synthetic",
             "--preset", "stories15M", "--dtype", dtype, "--tokenizer", vocab,
             "I have a dream"], cwd=REPO, capture_output=True, text=True, timeout=600)
        last = cli.stdout.rstrip().splitlines()[-1] if cli.stdout.strip() else ""
        if cli.returncode != 0 or not last.startswith("Token count:"):
            raise AssertionError(f"CLI --dtype {dtype} failed (rc {cli.returncode}):\n"
                                 f"{cli.stdout[-2000:]}\n{cli.stderr[-2000:]}")
        emit({"phase": "cli", "dtype": dtype, "last_line": last,
              "stats": cli.stderr.strip().splitlines()[-1]})

    # ---- serving: tinyllama-1.1b at full width, paged cache ----------------
    nl = t_args.n_layers
    paged_row = smoke.paged_phase(
        "tinyllama-1.1b", 8, t_args.n_heads, t_args.kv_heads, t_args.head_dim, 16,
        t_args.max_seq_len // 16, [0, 15, 16, 255, 500, 1023, 1500, 2047])
    v_eng = Llama(t_weights, t_args, device="cuda")
    solo = solo_streams(v_eng, workload)
    served = {}
    for run, quantum, chunk in (("q1", 1, None), ("q4", 4, None), ("chunked", 1, 512)):
        reset_counters()  # the main path: serving through the kernels
        streams, st = serve(torch, v_eng, workload, quantum, chunk)
        counts = counters()
        bad = [i for i, (g, w) in enumerate(zip(streams, solo)) if g != w]
        if bad:
            i = bad[0]
            at = next((j for j, (a, b) in enumerate(zip(streams[i], solo[i])) if a != b),
                      min(len(streams[i]), len(solo[i])))
            raise AssertionError(f"serving {run}: request {i} (prompt "
                                 f"{len(workload[i][0])}) diverges from its solo "
                                 f"stream at token {at}; {len(bad)} of 12 differ")
        expect = {"flash_prefill": nl * st["admissions"], "decode_layers": 0,
                  "paged_attention": nl * st["decode_steps"], "argmax_head": 0}
        if counts != expect or st["admissions"] != len(workload):
            raise AssertionError(f"serving {run} launch counts {counts}, expected "
                                 f"{expect} ({st['admissions']} admissions)")
        served[run] = {**st, "launches": counts}
        emit({"phase": "e2e", "model": "tinyllama-1.1b", "path": "serving",
              "run": run, **st, "launches": counts,
              "streams_equal_solo": len(streams), "pages_leaked": 0, "card": card})
    emit(serve_profile_phase(torch, "tinyllama-1.1b", v_eng, workload, card))
    sampled_step_phase(torch, "tinyllama-1.1b", v_eng, workload, card)
    del v_eng
    torch.cuda.empty_cache()

    x_eng = Llama(t_weights, t_args.replace(attn_impl="xla"), device="cuda")
    reset_counters()
    x_streams, x_st = serve(torch, x_eng, workload, 1)
    x_counts = counters()
    del x_eng
    if any(x_counts.values()):
        raise AssertionError(f"the plain serving path launched kernels: {x_counts}")
    emit({"phase": "e2e", "model": "tinyllama-1.1b", "path": "serving-plain",
          "run": "q1", **x_st,
          "streams_equal_solo": sum(g == w for g, w in zip(x_streams, solo)),
          "card": card})

    # ---- the kv_dtype override: fp32 activations over a bf16 cache (B11) ----
    kv_rows, kv_paths, kv_other = kv_override_phases(
        torch, smoke, t_args, t_weights, prompt, workload, card,
        {"prefill_ms": k_stats.prefill_ms, "decode_tok_s": k_stats.decode_tok_s,
         "ms_per_step_q1": served["q1"]["ms_per_step"],
         "ms_per_step_q4": served["q4"]["ms_per_step"]})

    # ---- tinyllama-1.1b with int8 weights and int8 KV ----------------------
    decode_i8, paged_i8, i8_paths = int8_phases(torch, smoke, t_args, t_weights, prompt,
                                                workload, card)

    # ---- tinyllama-1.1b in float16, and int8 weights under float16 ----------
    h_rows, h_paths = fp16_phases(torch, smoke, t_args, t_weights, prompt, workload, card)

    # ---- training (A8): tinyllama-1.1b in float32 from a token shard, and
    # stories15M's steps on the card against the CPU --------------------------
    full_train_phase(torch, t_weights, t_args, vocab, card)
    train_card_vs_cpu_phase(torch, s_weights, s_args, card)
    del t_weights  # host memory for the 8B staging
    import gc
    gc.collect()

    # ---- llama3-8b in bf16 at full width and depth -------------------------
    b_rows, b_paths, b_eng, b_limit = llama3_8b_phases(torch, smoke, card)
    gc.collect()

    # ---- llama3-8b multi-LoRA serving, LoRA fine-tuning and perplexity (A7,
    # A8), on the loaded bf16 engine before the int8 engine loads -------------
    split, ml_counts = multilora_phase(torch, b_eng, b_limit, card)
    vocab128k = synthetic_vocab(os.path.join(REPO, "build", "smoke", "vocab128k.json"),
                                b_eng.args.vocab_size)
    lora_train_phase(torch, split, vocab128k, card)
    del split
    ppl_flash = perplexity_phase(torch, smoke, b_eng, card)
    for run, counts in ml_counts.items():
        for name in ("flash_prefill", "paged_attention"):
            b_paths[name][run] = counts[name]
    b_paths["flash_prefill"]["perplexity"] = ppl_flash
    gc.collect()
    torch.cuda.empty_cache()

    # ---- llama3-8b with int8 weights under bf16 activations, and speculation
    # with the bf16 engine as target and the int8 engine as its draft --------
    q8_row, q8_paths = llama3_8b_int8_phases(torch, smoke, card, b_eng, b_limit)
    del b_eng
    torch.cuda.empty_cache()

    # ---- parallelism (A9): llama3-70b's widths over two ranks on the card ----
    a9_rows, a9_paths = parallel_phase(torch, smoke, card)

    # ---- the fp16 kernel modes at llama3-8b's shapes ------------------------
    fp16_8b_shapes(torch, smoke)

    # ---- summary --------------------------------------------------------------
    sources = {"flash_prefill": ("llama3np_tpu_torch/csrc/flash_prefill.cu",
                                 "llama3np_tpu/ops/kernels/flash_prefill.py:76"),
               "decode_layers": ("llama3np_tpu_torch/csrc/decode_step.cu",
                                 "llama3np_tpu/ops/kernels/decode_step.py:917"),
               "paged_attention": ("llama3np_tpu_torch/csrc/paged_attention.cu",
                                   "llama3np_tpu/ops/kernels/paged_attention.py:257"),
               "argmax_head": ("llama3np_tpu_torch/csrc/greedy_head.cu",
                               "llama3np_tpu/ops/kernels/greedy_head.py:70")}
    # Launches: each kernel's count in the main path that carries it (the
    # serving run at quantum 1 for flash_prefill and paged_attention, greedy
    # generation for decode_layers and argmax_head; the int8 and bf16 modes'
    # own runs), and the count in each path.
    by_path = {name: {"generate": main_counts[name],
                      "sampled_generate": t_sampled[name],
                      "serve_q1": served["q1"]["launches"][name],
                      "serve_q4": served["q4"]["launches"][name]}
               for name in sources}
    main_path = {"flash_prefill": "serve_q1", "decode_layers": "generate",
                 "paged_attention": "serve_q1", "argmax_head": "generate"}
    # Speculation (ROADMAP A4): each engine's prefill through flash, the
    # int8 draft's steps through the decode kernel's int8 (tinyllama) or
    # int8/bf16 (8B) mode, never the greedy head; int4 serving (A5): flash
    # for the float32 admissions, the paged kernel's int8 mode.
    spec_t = a45_paths["speculative"]
    by_path["flash_prefill"].update(
        speculative=spec_t["flash_prefill"],
        int4_serve_q1=a45_paths["int4_serve_q1"]["flash_prefill"],
        int4_serve_q4=a45_paths["int4_serve_q4"]["flash_prefill"])
    by_path["argmax_head"]["speculative"] = spec_t["argmax_head"]
    i8_paths["decode_layers"]["speculative"] = spec_t["decode_layers"]
    i8_paths["paged_attention"].update(
        int4_serve_q1=a45_paths["int4_serve_q1"]["paged_attention"],
        int4_serve_q4=a45_paths["int4_serve_q4"]["paged_attention"])
    b_paths["flash_prefill"]["speculative"] = q8_paths["flash_prefill"]["speculative"]
    b_paths["argmax_head"]["speculative"] = 0
    # The kv_dtype override (B11): flash (activation-dtype k/v) and the
    # greedy head on its generation and serving; its own decode and paged
    # modes below.
    by_path["flash_prefill"]["kv_override"] = kv_other["flash_prefill"]
    by_path["argmax_head"]["kv_override"] = kv_other["argmax_head"]
    # The PR of each kernel mode's current design.
    design = {("flash_prefill", "fp32"): "pr8", ("flash_prefill", "bf16"): "pr5",
              ("decode_layers", "fp32"): "pr6", ("decode_layers", "int8"): "pr6",
              ("decode_layers", "bf16"): "pr6", ("decode_layers", "int8-bf16"): "pr6",
              ("paged_attention", "fp32"): "pr5",
              ("paged_attention", "int8"): "pr5", ("paged_attention", "bf16"): "pr5",
              ("argmax_head", "fp32"): "pr8", ("argmax_head", "bf16"): "pr8",
              ("paged_attention", "int8-bf16"): "pr7", ("paged_attention", "int8-fp16"): "pr7",
              ("paged_attention", "fp16"): "pr7", ("flash_prefill", "fp16"): "pr7",
              ("decode_layers", "fp16"): "pr7", ("decode_layers", "int8-fp16"): "pr7",
              ("argmax_head", "fp16"): "pr8"}
    design.update({key: "kv_dtype override" for key in kv_rows})

    def stacked(row):  # the paged kernel's stacked mode stands for the row
        return {**row, **row["modes"]["stacked"], "paged_mode": "stacked"}

    kernels = []
    for row, paths in ((flash_row, by_path["flash_prefill"]),
                       (decode_row, by_path["decode_layers"]),
                       (stacked(paged_row), by_path["paged_attention"]),
                       (head_row, by_path["argmax_head"]),
                       (decode_i8, i8_paths["decode_layers"]),
                       (stacked(paged_i8), i8_paths["paged_attention"]),
                       (b_rows["flash_prefill"], b_paths["flash_prefill"]),
                       (b_rows["decode_layers"], b_paths["decode_layers"]),
                       (stacked(b_rows["paged_attention"]), b_paths["paged_attention"]),
                       (b_rows["argmax_head"], b_paths["argmax_head"]),
                       (q8_row, q8_paths["decode_layers"]),
                       (stacked(b_rows["paged_attention_i8"]),
                        {**b_paths["paged_attention_i8"], **q8_paths["paged_attention_i8"]}),
                       (h_rows["flash_prefill"], h_paths["flash_prefill"]),
                       (h_rows["decode_layers"], h_paths["decode_layers"]),
                       (h_rows["argmax_head"], h_paths["argmax_head"]),
                       (stacked(h_rows["paged_attention"]), h_paths["paged_attention"]),
                       (h_rows["decode_layers_i8"], h_paths["decode_layers_i8"]),
                       (stacked(h_rows["paged_attention_i8"]), h_paths["paged_attention_i8"]),
                       (a9_rows["flash_prefill"], a9_paths["flash_prefill"]),
                       (stacked(a9_rows["paged_attention"]), a9_paths["paged_attention"]),
                       *((stacked(r) if r["kernel"] == "paged_attention" else r,
                          kv_paths.get(key, {})) for key, r in kv_rows.items())):
        name = row["kernel"]
        src, replaces = sources[name]
        if name == "decode_layers" and row["mode"].split("-kv-")[0] != "fp32":
            replaces = "llama3np_tpu/ops/kernels/decode_step.py:793"  # the streamed layout
        kernels.append({
            "name": name, "mode": row["mode"], "route": "cuda",
            "design": design[name, row["mode"]], "source": src, "replaces": replaces,
            "launches": paths.get(main_path[name], 0), "launches_by_path": paths,
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
