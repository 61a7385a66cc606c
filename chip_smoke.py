#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`llama3np_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from `llama3np_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card at the shapes the
main path gives it (stories15M, tinyllama-1.1b and llama3-8b widths; the
decode kernel in its float32, int8, bf16, fp16, int8/bf16 and int8/fp16
modes, the paged-attention kernel over float32, bf16, fp16 and int8 pools,
int8 under a float32, bf16 or fp16 q, flash prefill and the greedy head in
float32, bf16 and fp16), drives greedy generation end to end through the
port's entry points (stories15M against the port's NumPy oracle;
tinyllama-1.1b at full width and depth against the plain path on the same
card), traces each model's prefill and a few decode tokens with
torch.profiler (device time by kernel, device busy share), runs the CLI in
float32 and bfloat16, then drives continuous-batching serving of
tinyllama-1.1b at full width and depth over the paged KV cache (12
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
a near-tie: the first differing token must be one); then llama3-8b with
int8 weights under bf16 activations at full width and depth (the decode
kernel's int8/bf16 mode against its twin, greedy generation against the
plain path by the same rules, a trace with the plain int8 head's share,
serving with int8 KV); last, the fp16 kernel modes alone at llama3-8b's
shapes.  The greedy head is also re-timed against torch.matmul +
torch.argmax in alternation at tinyllama-1.1b.  It prints one JSON line
per phase (each with `t_s`, the seconds since start), then the `kernels`
line.  Any failure raises and exits non-zero; the last line, `{"ok": true,
"device": {...}}`, is printed only when every phase passed.  Without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.

    python3 chip_smoke.py --decode-ab PARENT_DIR [MODEL:MODE[@POS,...] ...]
    python3 chip_smoke.py --paged-ab PARENT_DIR

run only an A/B of the decode kernel (or of the paged kernel): the one of
the checkout unpacked at PARENT_DIR (e.g. `git archive` of the parent
commit) against this one's, in one process, parent, change, change, parent
at every shape of the decode phases, with each one's step breakdown from
torch.profiler (the paged kernel: at llama3-8b's paged shapes, int8 pools
under a bf16 and an fp16 q, and bf16 pools).

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


def decode_mode(layers) -> str:
    """The decode kernel's mode for a layer tree: fp32, int8 (under f32
    activations), bf16 or fp16, int8-bf16 or int8-fp16 (int8 weights under
    16-bit ones)."""
    act = dtype_name(layers["attn_norm"].dtype)
    if "wqkv_scale" in layers:
        return "int8" if act == "fp32" else f"int8-{act}"
    return act


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

    def decode_phase(self, model: str, layers, args, pos: int):
        """The decode kernel against its plain twin; `layers` holds float32,
        bf16 or fp16 weights, or int8 weights with their scales (the int8
        mode under float32 norms, the int8/bf16 or int8/fp16 mode under
        16-bit norms).  `ms` is
        the device time per call queued behind a spin kernel
        (`queued_ms`: where the host's enqueue of a call's launches takes
        longer than the card, back-to-back events time the host);
        `event_ms` the CUDA-event time of back-to-back calls."""
        torch = self.torch
        from llama3np_tpu_torch.ops.kernels.decode_step import (
            decode_layers, decode_layers_plain)

        nl, kvh, M, hd = args.n_layers, args.kv_heads, args.max_seq_len, args.head_dim
        dt = layers["attn_norm"].dtype  # the activations' dtype
        half = dt != torch.float32
        kc = self.randn(nl, kvh, M, hd, dtype=dt)
        vc = self.randn(nl, kvh, M, hd, dtype=dt)
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
        if half:
            # The twin rounds at the same points, but an f32 sum taken in
            # another order may round the other way at any of them, and the
            # 1-ulp flips compound through the layers (`by_depth` prints the
            # kernel-vs-twin error over the first 1 and 8 layers).  So 16-bit
            # modes are held normwise: kernel vs twin within 5e-2, and the kernel
            # no farther (within 25 %) from the f32 function of the same
            # weights and inputs (no bf16 rounding inside; int8 weights
            # dequantized by their scales) than the twin.
            rtol, atol = None, None
            tol = {"normwise": 5e-2, "vs_f32_ratio": 1.25}
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
        reps = 200 if nl * args.dim < 10000 else 20

        def call():
            return decode_layers(layers, x, pos, k1, v1, cos, sin, **kw)

        ms = queued_ms(torch, call, queue_reps(reps, 5 * nl + 1))  # 5 launches a layer
        event_ms = time_ms(torch, call, reps)
        plain_ms = time_ms(torch, lambda: decode_layers_plain(
            layers, x, pos, k2, v2, cos, sin, **kw), min(reps, 20))
        decode_layers.launches = launches  # comparison launches do not count
        mode = decode_mode(layers)
        w_elems = sum(layers[n].numel() for n in ("wqkv", "wo", "wgu", "w_down"))
        nbytes = (sum(t.numel() * t.element_size() for t in layers.values())
                  + kc.element_size() * (2 * args.dim + 2 * nl * kvh * hd * (pos + 1))
                  + 4.0 * hd)
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
                    quant: bool = False, dtype=None, case: str = "skewed"):
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
        or equal: imbalance apart from staging)."""
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
        q = self.randn(B, 1, NH, HD, dtype=dt)
        kp = self.randn(NL, P, KVH, page, HD, dtype=dt)
        vp = self.randn(NL, P, KVH, page, HD, dtype=dt)
        ck, cv = self.randn(B, KVH, HD, dtype=dt), self.randn(B, KVH, HD, dtype=dt)
        wk, wv = self.randn(B, KVH, Q, HD, dtype=dt), self.randn(B, KVH, Q, HD, dtype=dt)
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
        [D, VS]: the same token for `n_x` random rows, and for a row whose
        two top columns tie across a block boundary (the last column of
        block 0 and the first of block 1, each summing to exactly 32: the
        lower one must win).  `ms` is the device time per call (both
        launches, `queued_ms`); `library_ms` one torch.matmul
        + torch.argmax (in w's dtype: bf16 or fp16 rounds the logits), a yardstick
        the port never calls."""
        torch = self.torch
        from llama3np_tpu_torch.ops.kernels.greedy_head import (
            argmax_head, argmax_head_plain)

        D, VS = w.shape
        launches = argmax_head.launches
        xs = [self.randn(1, D, dtype=torch.bfloat16).to(w.dtype) for _ in range(n_x)]
        got = [int(argmax_head(x, w)[0]) for x in xs]
        want = [int(argmax_head_plain(x, w)[0]) for x in xs]
        if got != want:
            raise AssertionError(f"argmax_head {model}: tokens {got} vs plain {want}")
        cols = 32 * 16 // w.element_size()  # vocab columns of a block
        tied = w.clone()
        tied[:, cols - 1 : cols + 1] = 0
        tied[0, cols - 1 : cols + 1] = 8.0
        x = xs[0].clone()
        x[0, 0] = 4.0
        tie = (int(argmax_head(x, tied)[0]), int(argmax_head_plain(x, tied)[0]))
        if tie != (cols - 1, cols - 1):
            raise AssertionError(f"argmax_head {model}: tie across a block boundary "
                                 f"gave {tie}, expected {cols - 1}")
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
               "tie_across_blocks_ok": True, "max_abs_err": 0.0, "tol": "exact token",
               "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "library_ms": library_ms, "vs_library": ms / library_ms,
               "weights_mb": w.numel() * w.element_size() / 1e6, "card": self.card}
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
    port's kernels by name, GEMMs (cuBLAS/CUTLASS), copies and casts (an
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
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "sm90")):
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
          kv_quant=None):
    """Serve `workload` through a paged BatchEngine (capacity 8, page 16):
    6 requests at once, then 2 more after every 3 steps, so some queue;
    then drain.  Returns the streams and the run's counts and times.  The
    admission time (prefill, fenced) is kept apart from the decode time."""
    from llama3np_tpu_torch.serving import BatchEngine

    be = BatchEngine(engine, capacity=8, paged=True, page_size=16,
                     admit_chunk=admit_chunk, kv_quant=kv_quant)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [be.submit(p, n, stop_ids=STOP_IDS) for p, n in workload[:6]]
    calls = 0
    while be.num_active or be._queue or len(reqs) < len(workload):
        if calls and calls % 3 == 0 and len(reqs) < len(workload):
            reqs += [be.submit(p, n, stop_ids=STOP_IDS)
                     for p, n in workload[len(reqs) : len(reqs) + 2]]
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


def grid_weights(torch, weights):
    """Weights snapped onto an int8 grid per output channel (the rule of
    tests/test_quant.py:27-41), computed on the card: quantization then
    round-trips, so the int8 engine computes the fp32 engine's numbers."""
    out = {}
    for k, v in weights.items():
        if v.ndim == 2:
            w = torch.from_numpy(v).to("cuda")
            sc = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
            v = (torch.clamp(torch.round(w / sc), -127, 127) * sc).cpu().numpy()
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


def solo_serve(engine, workload, kv_quant, margins: bool = False):
    """Each request's stream from a capacity-1 paged engine (the
    schedule-independence rule of tests/test_kv_quant.py:160-178); with
    `margins`, also each token's top-2 logit margin (the difference of the
    top two log-probabilities), for the near-tie rule."""
    from llama3np_tpu_torch.serving import BatchEngine

    out, gaps = [], []
    for prompt, budget in workload:
        be = BatchEngine(engine, capacity=1, paged=True, page_size=16,
                         kv_quant=kv_quant, logprobs=2 if margins else None)
        req = be.submit(prompt, budget, stop_ids=STOP_IDS,
                        logprobs=2 if margins else None)
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
                  **tags):
    """Paged serving of `workload` (`serve`) at each (run, quantum) of
    `runs`, every stream against its capacity-1 stream (`solo_serve`) by
    the near-tie rule under `limit`; exact launch counts (flash once a
    layer an admission, the paged kernel once a layer a decode step), all
    pages back.  Returns each run's launch counts."""
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

    # Serving: bf16 pools at quanta 1 and 4, against capacity-1 streams.
    workload = serve_workload(args.vocab_size)
    served = serve_vs_solo(torch, "llama3-8b", eng, workload, (("q1", 1), ("q4", 4)), limit,
                           card, dtype="bfloat16")
    paths = {name: {"generate": n, **{"serve_" + run: c[name] for run, c in served.items()}}
             for name, n in gen_counts.items()}
    emit(serve_profile_phase(torch, "llama3-8b", eng, workload, card))

    # Serving with int8 KV (int8 pools under the bf16 q) at quanta 1 and 4,
    # against capacity-1 int8-KV streams; the pools' bytes a token and the
    # 8,192-token rows that fit beside the weights.
    emit(pool_capacity(torch, eng, card))
    i8 = serve_vs_solo(torch, "llama3-8b", eng, workload, (("q1", 1), ("q4", 4)), limit,
                       card, kv_quant="int8", dtype="bfloat16", kv="int8")
    paths["paged_attention_i8"] = {"serve_q1": i8["q1"]["paged_attention"],
                                   "serve_q4": i8["q4"]["paged_attention"]}
    emit(serve_profile_phase(torch, "llama3-8b", eng, workload, card, kv_quant="int8"))
    del eng
    torch.cuda.empty_cache()
    return rows, paths


def int8_phases(torch, smoke, args, weights, prompt, workload, card):
    """tinyllama-1.1b with int8 weights: the decode kernel's int8 mode at
    full width and depth, greedy generation ((a) on grid weights against
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


def head_alternation(torch, smoke, w, rounds: int = 6):
    """The greedy head against one torch.matmul + torch.argmax on the same
    lm_head and row, alternated `rounds` times (kernel, library, library,
    kernel, ...), each a `queued_ms` of 50 calls: both series and their
    spreads ((max - min) / min)."""
    from llama3np_tpu_torch.ops.kernels.greedy_head import argmax_head

    launches = argmax_head.launches
    x = smoke.randn(1, w.shape[0], dtype=torch.bfloat16).to(w.dtype)
    fns = {"kernel": lambda: argmax_head(x, w),
           "library": lambda: torch.argmax(torch.matmul(x, w), dim=-1)}
    series = {"kernel": [], "library": []}
    for r in range(rounds):
        for who in (("kernel", "library") if r % 2 == 0 else ("library", "kernel")):
            series[who].append(queued_ms(torch, fns[who], 50))
    argmax_head.launches = launches  # comparison launches do not count
    spread = {k: (max(v) - min(v)) / min(v) for k, v in series.items()}
    return {"phase": "head_alternation", "shape": {"D": w.shape[0], "VS": w.shape[1]},
            "dtype": str(w.dtype).replace("torch.", ""), "ms": series, "spread": spread,
            "kernel_mean_ms": sum(series["kernel"]) / rounds,
            "library_mean_ms": sum(series["library"]) / rounds,
            "kernel_slower_beyond_spread": min(series["kernel"]) > max(series["library"]),
            "card": smoke.card}


def llama3_8b_int8_phases(torch, smoke, card):
    """llama3-8b with int8 weights under bf16 activations (quant="int8",
    dtype bfloat16) at full width and depth: the engine's own loader over
    weights made on the card, the decode kernel's int8/bf16 mode against
    its twin at pos 0 / 511 / 8191, greedy generation through flash
    prefill and that mode (the int8 lm_head stays plain: lm_logits and
    argmax) against the plain path (attn_impl="xla"): logits within the
    bf16 envelope with top-1 equal, the stream equal or parted at a
    near-tie; prefill ms and decode tok/s of both, and a trace that shows
    the plain head's share.  Returns the kernel row and the launch
    counts."""
    import resource

    import numpy as np

    from llama3np_tpu_torch import preset
    from llama3np_tpu_torch.models.llama import Llama

    args = preset("llama3-8b", quant="int8")
    nl = args.n_layers
    t0 = time.perf_counter()
    eng = Llama(CardWeights(torch, args), args, device="cuda")
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
    counts, limit = generate_vs_plain(torch, "llama3-8b", eng, prompt, 32, E8B_ENVELOPE,
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
                       limit, card, kv_quant="int8", quant="int8", dtype="bfloat16", kv="int8")
    del eng
    torch.cuda.empty_cache()
    return row, {"decode_layers": {"generate": counts["decode_layers"]},
                 "paged_attention_i8": {"serve_q1_int8_weights": i8["q1"]["paged_attention"]}}


def fp16_phases(torch, smoke, args, weights, prompt, workload, card):
    """tinyllama-1.1b in float16 at full width and depth: the four kernels'
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

    # ---- tinyllama-1.1b at full width and depth ---------------------------
    t_args = preset("tinyllama-1.1b")
    t_weights = synthetic_weights(t_args, seed=0)
    t_eng = Llama(t_weights, t_args, device="cuda")
    flash_row = smoke.flash_phase("tinyllama-1.1b", 1, 512, t_args.n_heads,
                                  t_args.kv_heads, t_args.head_dim)
    smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 0)
    decode_row = smoke.decode_phase("tinyllama-1.1b", t_eng.params["layers"], t_args, 511)
    smoke.argmax_phase("tinyllama-1.1b", t_eng.params["lm_head"])
    emit(head_alternation(torch, smoke, t_eng.params["lm_head"]))

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

    # ---- serving: tinyllama-1.1b at full width and depth, paged cache -------
    nl = t_args.n_layers
    paged_row = smoke.paged_phase(
        "tinyllama-1.1b", 8, t_args.n_heads, t_args.kv_heads, t_args.head_dim, 16,
        t_args.max_seq_len // 16, [0, 15, 16, 255, 500, 1023, 1500, 2047])
    v_eng = Llama(t_weights, t_args, device="cuda")
    workload = serve_workload(t_args.vocab_size)
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

    # ---- tinyllama-1.1b with int8 weights and int8 KV ----------------------
    decode_i8, paged_i8, i8_paths = int8_phases(torch, smoke, t_args, t_weights, prompt,
                                                workload, card)

    # ---- tinyllama-1.1b in float16, and int8 weights under float16 ----------
    h_rows, h_paths = fp16_phases(torch, smoke, t_args, t_weights, prompt, workload, card)
    del t_weights  # host memory for the 8B staging
    import gc
    gc.collect()

    # ---- llama3-8b in bf16 at full width and depth -------------------------
    b_rows, b_paths = llama3_8b_phases(torch, smoke, card)
    gc.collect()

    # ---- llama3-8b with int8 weights under bf16 activations ----------------
    q8_row, q8_paths = llama3_8b_int8_phases(torch, smoke, card)

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
                      "serve_q1": served["q1"]["launches"][name],
                      "serve_q4": served["q4"]["launches"][name]}
               for name in sources}
    main_path = {"flash_prefill": "serve_q1", "decode_layers": "generate",
                 "paged_attention": "serve_q1", "argmax_head": "generate"}
    # The PR of each kernel mode's current design.
    design = {("flash_prefill", "fp32"): "pr1", ("flash_prefill", "bf16"): "pr5",
              ("decode_layers", "fp32"): "pr6", ("decode_layers", "int8"): "pr6",
              ("decode_layers", "bf16"): "pr6", ("decode_layers", "int8-bf16"): "pr6",
              ("paged_attention", "fp32"): "pr5",
              ("paged_attention", "int8"): "pr5", ("paged_attention", "bf16"): "pr5",
              ("argmax_head", "bf16"): "pr4",
              ("paged_attention", "int8-bf16"): "pr7", ("paged_attention", "int8-fp16"): "pr7",
              ("paged_attention", "fp16"): "pr7", ("flash_prefill", "fp16"): "pr7",
              ("decode_layers", "fp16"): "pr7", ("decode_layers", "int8-fp16"): "pr7",
              ("argmax_head", "fp16"): "pr7"}

    def stacked(row):  # the paged kernel's stacked mode stands for the row
        return {**row, **row["modes"]["stacked"], "paged_mode": "stacked"}

    kernels = []
    for row, paths in ((flash_row, by_path["flash_prefill"]),
                       (decode_row, by_path["decode_layers"]),
                       (stacked(paged_row), by_path["paged_attention"]),
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
                       (stacked(h_rows["paged_attention_i8"]), h_paths["paged_attention_i8"])):
        name = row["kernel"]
        src, replaces = sources[name]
        if name == "decode_layers" and row["mode"] != "fp32":
            replaces = "llama3np_tpu/ops/kernels/decode_step.py:793"  # the streamed layout
        kernels.append({
            "name": name, "mode": row["mode"], "route": "cuda",
            "design": design[name, row["mode"]], "source": src, "replaces": replaces,
            "launches": paths[main_path[name]], "launches_by_path": paths,
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
