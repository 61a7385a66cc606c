"""95th percentile of (first token back - due time), ms, over the requests due in a traced run's window whose wait does not overlap the profiler (from its start to its stop, which holds the loop for up to seconds); a request with no token counts as missing.  Per layer: the end-to-end tail spreads too widely for a bound."""

from benchmark.harness import stats


def read(ctx):
    w = ctx.window
    if not w.get("due"):
        return None
    a, b = w.get("profiled", (float("inf"), float("-inf")))
    waits = [t for d, t in zip(w["due"], stats.ttfts(w["due"], w["first"], w["give_up"]))
             if d + t < a or d > b]
    return 1e3 * stats.percentile(waits, 95) if waits else None
