"""CLI: `python -m llama3np_tpu_torch.cli [options] "prompt"`.

Mirrors `llama3np_tpu.cli`: the same streamed text and the same final
`Token count: N, elapsed: S, T tokens/s` line (quirks Q3/Q6), with the
prefill/decode split on stderr.  It runs on the card unless `--device cpu`
is given; `--dtype bfloat16` or `--dtype float16` runs the kernels' 16-bit
modes there.  `--quant int8` runs int8 weights under any of the three
dtypes; `--quant int4` raises the engine's "unfused" ValueError on the
fused default layout, as the JAX CLI does.  `--temperature` above 0
samples (with `--top-k`, `--top-p` and `--seed`): the JAX CLI's tokens
for the same seed.  `--trace DIR` writes a torch.profiler Chrome trace of
the generation, `--debug-stats` / `--debug-log-dir DIR` (with
`--debug-tokens N`) the reference debug build's tensor-stats trace of an
eager replay, `--run-log PATH` a JSONL record of the run; `--precision`
takes the JAX CLI's values and keeps f32 sums with TF32 off whatever it is
(`models.llama.Llama`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llama3np_tpu_torch",
                                description="Llama inference on PyTorch + CUDA")
    p.add_argument("prompt", nargs="?", default="I have a dream")
    p.add_argument("--model", default="./stories15M.model.npz",
                   help=".npz checkpoint (reference schema)")
    p.add_argument("--tokenizer", default="./tokenizer.model.np")
    p.add_argument("--preset", default="stories15M",
                   help="config preset (stories15M, stories110M, "
                        "tinyllama-1.1b, llama3-8b, llama3-70b)")
    p.add_argument("--max-new-tokens", type=int, default=None,
                   help="number of NEW tokens (default: preset budget)")
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "bfloat16", "float16"])
    p.add_argument("--attn-impl", default=None, choices=[None, "auto", "xla", "pallas"])
    p.add_argument("--quant", default=None, choices=[None, "int8", "int4"],
                   help="weight-only quantization (per-output-channel "
                        "scales; int4 needs the split layout)")
    p.add_argument("--precision", default=None, choices=[None, "default", "highest"],
                   help="the JAX CLI's matmul precision; every value keeps f32 sums")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy, the reference behavior)")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if there is no card)")
    p.add_argument("--fixed-decode", action="store_true",
                   help="correct decode (disable the reference's strip quirk Q3)")
    p.add_argument("--no-stream", action="store_true")
    p.add_argument("--stats-json", action="store_true",
                   help="print a JSON stats line at the end")
    p.add_argument("--trace", metavar="LOGDIR", default=None,
                   help="write a torch.profiler Chrome trace of the generation")
    p.add_argument("--debug-stats", action="store_true",
                   help="one-shot per-op tensor-stats trace of the forward")
    p.add_argument("--debug-log-dir", default=None, metavar="DIR",
                   help="also write the per-op tensor-stats trace to a "
                        "rotating debug log in DIR; implies the trace itself")
    p.add_argument("--debug-tokens", type=int, default=0, metavar="N",
                   help="with --debug-stats/--debug-log-dir: eager-replay N "
                        "generated tokens, logging every checkpoint per "
                        "forward, instead of one forward")
    p.add_argument("--run-log", default=None, metavar="PATH",
                   help="append a JSONL record of this run")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic weights (no checkpoint file needed)")
    return p


def main(argv=None) -> int:
    from . import Tokenizer, preset, synthetic_weights
    from .generate import Sampling
    from .models.llama import Llama
    from .observability import RunLog, debug_trace_forward, timed_generate, trace

    args_ns = build_parser().parse_args(argv)
    overrides = {}
    if args_ns.dtype:
        overrides["dtype"] = args_ns.dtype
    if args_ns.attn_impl:
        overrides["attn_impl"] = args_ns.attn_impl
    if args_ns.quant:
        overrides["quant"] = args_ns.quant
    try:
        margs = preset(args_ns.preset, **overrides)
        tokenizer = Tokenizer(args_ns.tokenizer, fix_decode=args_ns.fixed_decode)
        source = (synthetic_weights(margs, seed=0) if args_ns.synthetic
                  else args_ns.model)
        model = Llama(source, margs, device=args_ns.device,
                      precision=args_ns.precision)
    except NotImplementedError as e:
        print(f"llama3np_tpu_torch: {e}", file=sys.stderr)
        return 2

    ids = np.array([tokenizer.encode(args_ns.prompt)])
    n_new = args_ns.max_new_tokens
    if n_new is None:
        n_new = max(margs.max_new_tokens - ids.shape[1], 0)
    n_new = min(n_new, margs.max_seq_len - ids.shape[1])

    if args_ns.debug_stats or args_ns.debug_log_dir:
        sinks = []
        if args_ns.debug_stats:
            sinks.append(lambda s: print(s, file=sys.stderr))
        if args_ns.debug_log_dir:
            from .observability import make_debug_logger
            sinks.append(make_debug_logger(args_ns.debug_log_dir).debug)
        emit = lambda s: [sink(s) for sink in sinks]  # noqa: E731
        if args_ns.debug_tokens > 0:
            from .observability import debug_trace_generate
            debug_trace_generate(model, ids, args_ns.debug_tokens, emit=emit)
        else:
            debug_trace_forward(model, ids, 0, emit=emit)
        model.reset()

    print(f"\n{args_ns.prompt}", end="")
    policy = None
    if args_ns.temperature > 0:
        policy = Sampling(temperature=args_ns.temperature, top_k=args_ns.top_k,
                          top_p=args_ns.top_p, seed=args_ns.seed)
    with (trace(args_ns.trace) if args_ns.trace else contextlib.nullcontext()):
        toks, stats = timed_generate(model, ids, n_new, sampling=policy)
    toks = toks.cpu().numpy()[0]

    emitted = 0
    for t in toks.tolist():
        if t in (tokenizer.eos_id, tokenizer.bos_id):
            break
        emitted += 1
        if not args_ns.no_stream:
            print(tokenizer.decode([t]), end="")
            sys.stdout.flush()
    total = ids.shape[1] + emitted
    elapsed = stats.prefill_s + stats.decode_s
    print(f"\n\nToken count: {total}, elapsed: {elapsed:.2f}s, "
          f"{round(total / elapsed) if elapsed else 0} tokens/s")
    print(f"prefill: {stats.prefill_ms:.2f} ms | "
          f"decode: {stats.decode_tok_s:.1f} tokens/s", file=sys.stderr)
    if args_ns.stats_json:
        print(json.dumps(stats.to_dict()))
    if args_ns.run_log:
        RunLog(args_ns.run_log).append(
            {"prompt": args_ns.prompt, "preset": args_ns.preset, **stats.to_dict()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
