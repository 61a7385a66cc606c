"""CLI: `python -m llama3np_tpu_torch.cli [options] "prompt"`.

Mirrors `llama3np_tpu.cli`: the same streamed text and the same final
`Token count: N, elapsed: S, T tokens/s` line (quirks Q3/Q6), with the
prefill/decode split on stderr.  It runs on the card unless `--device cpu`
is given; `--dtype bfloat16` or `--dtype float16` runs the kernels' 16-bit
modes there.  `--quant int8` runs int8 weights under any of the three
dtypes (int4 exits with the ROADMAP message).  Trace, debug and sampling
flags wait for later slices.
"""

from __future__ import annotations

import argparse
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
                   help="weight-only quantization (int8 per-output-channel "
                        "scales; int4 is still to port)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if there is no card)")
    p.add_argument("--fixed-decode", action="store_true",
                   help="correct decode (disable the reference's strip quirk Q3)")
    p.add_argument("--no-stream", action="store_true")
    p.add_argument("--stats-json", action="store_true",
                   help="print a JSON stats line at the end")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic weights (no checkpoint file needed)")
    return p


def main(argv=None) -> int:
    from . import Tokenizer, preset, synthetic_weights
    from .models.llama import Llama
    from .observability import timed_generate

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
        model = Llama(source, margs, device=args_ns.device)
    except NotImplementedError as e:
        print(f"llama3np_tpu_torch: {e}", file=sys.stderr)
        return 2

    ids = np.array([tokenizer.encode(args_ns.prompt)])
    n_new = args_ns.max_new_tokens
    if n_new is None:
        n_new = max(margs.max_new_tokens - ids.shape[1], 0)
    n_new = min(n_new, margs.max_seq_len - ids.shape[1])

    print(f"\n{args_ns.prompt}", end="")
    toks, stats = timed_generate(model, ids, n_new)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
