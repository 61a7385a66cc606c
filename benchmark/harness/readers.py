"""What the metric readers (`benchmark/metrics/<metric>.py`) compute, each
from the run (`runner.Harness`): the window's results and counts, the
spans and the profiler window.  A reader returns None where it finds
nothing to read; a share of a roofline or of a peak is never made up."""

from __future__ import annotations

from typing import Optional

from . import roofline, stats


def output_tok_s(ctx) -> Optional[float]:
    w = ctx.window
    return w["output_tokens"] / w["window_s"] if w.get("window_s") else None


def ttft_ms(ctx, q: float) -> Optional[float]:
    w = ctx.window
    if "due" not in w or not w["due"]:
        return None
    return 1e3 * stats.percentile(stats.ttfts(w["due"], w["first"], w["give_up"]), q)


def itl_ms(ctx, q: float) -> Optional[float]:
    """The q-th percentile of every gap between consecutive tokens of every
    request, up to the window's close (ms)."""
    w = ctx.window
    g = stats.gaps(w.get("stamps", []), until=w.get("t1", float("inf")))
    return 1e3 * stats.percentile(g, q) if g else None


def span_share(ctx, name: str) -> Optional[float]:
    """Share (%) of the window's wall time inside spans called `name`."""
    if ctx.spans is None:
        return None
    w = ctx.window
    idx = ctx.spans.of(name, w["t0"], w["t1"])
    total = sum(ctx.spans.spans[i].end - ctx.spans.spans[i].start for i in idx)
    return 100.0 * total / (w["t1"] - w["t0"])


def span_self_ms(ctx, name: str) -> Optional[float]:
    """Mean self time (ms) of the window's spans called `name`: nested
    spans (an admission inside a step) taken out."""
    if ctx.spans is None:
        return None
    w = ctx.window
    idx = ctx.spans.of(name, w["t0"], w["t1"])
    return 1e3 * sum(ctx.spans.self_s(i) for i in idx) / len(idx) if idx else None


def decode_ms_per_token(ctx) -> Optional[float]:
    c = ctx.counters
    return 1e3 * c["decode_s"] / c["decode_tokens"] if c.get("decode_tokens") else None


def step_mfu(ctx) -> Optional[float]:
    """Model FLOPs of the work done in the window over the window's time at
    the bf16 peak (%)."""
    flops = ctx.counters.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (ctx.window["window_s"] * roofline.BF16_FLOP_S)


def matmul_share(ctx) -> Optional[float]:
    """Device time (%) of the products and the copies and casts that feed
    them, over the device's busy time, in the profiler window."""
    p = ctx.profile
    if p is None or p.busy_s <= 0 or not p.count({"matmul"}):
        return None
    return 100.0 * p.time_s({"matmul", "copy_cast"}) / p.busy_s


def idle_share(ctx) -> Optional[float]:
    p = ctx.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def paged_attention_roofline(ctx) -> Optional[float]:
    """The paged kernel's bound (its rows' K/V, q and out once) over its
    device time, merge included (%)."""
    p, c = ctx.profile, ctx.counters
    if p is None or not p.count({"paged_attention"}) or not c.get("profile_paged_bytes"):
        return None
    bound = roofline.bound_s(c["profile_paged_bytes"], c["profile_paged_flops"])
    return 100.0 * bound / p.time_s({"paged_attention"})


def decode_layers_roofline(ctx) -> Optional[float]:
    """The fused decode kernel's bound (weights and visible K/V a token)
    over its device time, overlapping launches counted once (%)."""
    p, c = ctx.profile, ctx.counters
    if p is None or not p.count({"decode_layers"}) or not c.get("profile_decode_bytes"):
        return None
    bound = c["profile_decode_bytes"] / roofline.HBM_BYTES_S
    return 100.0 * bound / p.time_s({"decode_layers"})
