"""HTTP serving front end over the continuous-batching engine.

Counterpart of `llama3np_tpu.server`, on stdlib ``http.server`` with the
same endpoints, bodies, SSE chunks and errors:

  * ``EngineLoop`` owns the ``BatchEngine`` and is the ONLY thread that
    touches the device: admissions and ragged decode steps stay
    serialized, on the device's current stream (the kernels keep scratch
    and tickets per (device, stream), so no thread opens a stream of its
    own).  HTTP handler threads talk to it through queues: a submission
    queue in, a token queue out per request.
  * The loop drains pending submissions, steps the engine one quantum and
    forwards each request's new tokens to its queue: streams see tokens at
    quantum granularity while the device runs full ragged steps for every
    co-tenant.
  * Backpressure is the engine's: submissions the paged pool cannot
    reserve worst-case pages for wait in the engine's own queue.

Endpoints:
  POST /v1/completions   {"prompt": str | "prompt_ids": [int], "max_tokens",
                          "temperature", "stream", "stop_ids", "echo", "n",
                          "logprobs": k}
                         -> JSON completion, or SSE chunks when streaming.
                         logprobs needs an engine built with
                         BatchEngine(..., logprobs=K) (k <= K).
  POST /v1/chat/completions
                         {"messages": [{"role", "content"}, ...],
                          "max_tokens", "temperature", "stream", "n",
                          "template": plain|llama2|chatml, "stop": [str]}
                         -> chat.completion (or delta chunks).  Template
                         stop STRINGS truncate on the host and cancel the
                         request; multi-turn prefixes ride the prefix cache.
  GET  /health           liveness + occupancy.
  GET  /stats            engine counters (with the prefix cache's).
  GET  /metrics          the same counters in Prometheus text exposition.

A disconnected streaming client or a stop-string hit CANCELS the request in
the engine (BatchEngine.cancel): its slot and pages are freed.  A request's
"adapter" (an int index or a name given to `serve(adapter_names=)` /
`--adapter NAME=PATH`) picks a LoRA adapter of the engine's bank; an
unknown one is answered 400.

Run:  python -m llama3np_tpu_torch.server --preset test-tiny --synthetic --device cpu
      (on the card: --device cuda, the default)
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

_DONE = object()


class _Pending:
    def __init__(self, prompt_ids: List[int], max_tokens: int,
                 temperature: float, stop_ids, logprobs: Optional[int] = None,
                 adapter: Optional[int] = None):
        self.prompt_ids = prompt_ids
        self.adapter = adapter
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.stop_ids = tuple(stop_ids)
        self.logprobs = logprobs
        self.out: "queue.Queue" = queue.Queue()
        self.error: Optional[str] = None
        self.finish_reason: str = "length"
        self.cancelled = False


class EngineLoop:
    """Single engine-owning thread: submissions in, token deltas out."""

    def __init__(self, batch_engine, quantum: int = 4):
        self.be = batch_engine
        self.quantum = quantum
        self._subs: "queue.Queue[_Pending]" = queue.Queue()
        self._cancels: "queue.Queue[_Pending]" = queue.Queue()
        self._tracked = {}  # request_id -> [Request, _Pending, n_sent]
        self._lock = threading.Lock()  # guards stats snapshot only
        self.served_requests = 0
        self.served_tokens = 0
        self.engine_steps = 0
        self.step_seconds_total = 0.0
        self.step_seconds_ema = 0.0  # ~32-step horizon
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llama3np-torch-engine")
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, prompt_ids, max_tokens, temperature=0.0,
               stop_ids=(1, 2), logprobs=None, adapter=None) -> _Pending:
        p = _Pending(list(map(int, prompt_ids)), int(max_tokens),
                     float(temperature), stop_ids, logprobs, adapter)
        self._subs.put(p)
        return p

    def cancel(self, p: _Pending) -> None:
        """Request-side abort (client disconnected, or a host-side stop
        string hit): the engine thread frees the request's slot/pages at
        its next iteration instead of decoding the rest of the budget."""
        p.cancelled = True
        self._cancels.put(p)

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def stats(self) -> dict:
        with self._lock:
            s = {"active": self.be.num_active,
                 "engine_queue": len(self.be._queue),
                 "served_requests": self.served_requests,
                 "served_tokens": self.served_tokens,
                 "engine_steps": self.engine_steps,
                 "step_seconds_total": self.step_seconds_total,
                 "step_seconds_ema": self.step_seconds_ema}
        px = self.be.prefix_stats
        if px is not None:
            s["prefix_cache"] = px
        return s

    # -- engine thread -------------------------------------------------------

    def _admit_one(self, p: _Pending):
        if p.cancelled:
            p.finish_reason = "cancelled"
            p.out.put(_DONE)
            return
        try:
            req = self.be.submit(p.prompt_ids, max_new_tokens=p.max_tokens,
                                 stop_ids=p.stop_ids,
                                 temperature=p.temperature,
                                 logprobs=p.logprobs,
                                 adapter=p.adapter)
        except (ValueError, MemoryError) as e:
            p.error = str(e)
            p.out.put(_DONE)
            return
        # Keyed by request_id: Request is a mutable dataclass (unhashable).
        self._tracked[req.request_id] = [req, p, 0]

    def _flush(self):
        finished = []
        for rid, state in self._tracked.items():
            req, p, n_sent = state
            new = req.generated[n_sent:]
            if new:
                delta = {"ids": list(new)}
                if req.logprobs is not None:
                    end = n_sent + len(new)
                    delta["lps"] = list(req.token_logprobs[n_sent:end])
                    delta["top"] = [
                        [{"id": i, "logprob": v} for i, v in top]
                        for top in req.top_logprobs[n_sent:end]]
                p.out.put(delta)
                state[2] = n_sent + len(new)
            if req.done:
                # The engine pops stop tokens before finishing, so "a stop id
                # ended this" is exactly "neither budget nor context ran out".
                hit_budget = len(req.generated) >= req.max_new_tokens
                hit_ctx = (len(req.prompt_ids) + len(req.generated)
                           >= self.be.args.max_seq_len)
                p.finish_reason = "length" if (hit_budget or hit_ctx) else "stop"
                p.out.put(_DONE)
                finished.append(rid)
        for rid in finished:
            _, p, n_sent = self._tracked.pop(rid)
            with self._lock:
                self.served_requests += 1
                self.served_tokens += n_sent

    def _drain_cancels(self):
        try:
            while True:
                p = self._cancels.get_nowait()
                for rid, state in list(self._tracked.items()):
                    if state[1] is p:
                        if self.be.cancel(state[0]):
                            p.finish_reason = "cancelled"
                        p.out.put(_DONE)
                        self._tracked.pop(rid)
                        # Tokens decoded before the cancel were served work;
                        # keep the /metrics counters honest.
                        with self._lock:
                            self.served_requests += 1
                            self.served_tokens += state[2]
                        break
                # Not tracked: either finished already (DONE sent) or still
                # in _subs — _admit_one sees p.cancelled and skips it.
        except queue.Empty:
            pass

    def _run(self):
        while not self._stop.is_set():
            self._drain_cancels()
            # Admit everything waiting (engine applies its own backpressure).
            try:
                while True:
                    self._admit_one(self._subs.get_nowait())
            except queue.Empty:
                pass
            if self.be.num_active or self.be._queue:
                t0 = time.perf_counter()
                self.be.step(quantum=self.quantum)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.engine_steps += 1
                    self.step_seconds_total += dt
                    self.step_seconds_ema = (
                        dt if self.engine_steps == 1
                        else 0.97 * self.step_seconds_ema + 0.03 * dt)
            # Unconditional: a request can finish AT admission (its first
            # prefill-produced token is a stop id — serving.py
            # _prefill_into's trailing _maybe_finish), leaving num_active
            # 0 with its _DONE still owed.
            self._flush()
            if not (self.be.num_active or self.be._queue):
                # Idle: block until the next submission (bounded, so
                # shutdown is responsive).
                try:
                    self._admit_one(self._subs.get(timeout=0.05))
                except queue.Empty:
                    pass


class CompletionHandler(BaseHTTPRequestHandler):
    """One instance per connection (ThreadingHTTPServer); the shared state
    lives on ``self.server`` (see ``serve``)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- helpers --------------------------------------------------------------

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _resolve_adapter(self, body):
        """OpenAI-style multi-model routing: "adapter" (an int index or a
        registered name) picks a LoRA of the engine's bank; absent, the
        base model.  Returns (index or None, error or None)."""
        a = body.get("adapter")
        if a is None:
            return None, None
        names = getattr(self.server, "adapter_names", None) or []
        if isinstance(a, str):
            if a not in names:
                return None, (f"unknown adapter {a!r}; "
                              f"available: {names or '(none)'}")
            return names.index(a), None
        try:
            return int(a), None
        except (TypeError, ValueError):
            return None, "adapter must be an int index or a name"

    def _decode(self, ids: List[int]) -> str:
        tok = self.server.tokenizer
        return tok.decode(ids) if tok is not None else ""

    # -- routes ----------------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            st = self.server.loop.stats()
            self._json(200, {"status": "ok", **st})
        elif self.path == "/stats":
            self._json(200, self.server.loop.stats())
        elif self.path == "/metrics":
            self._metrics()
        else:
            self._json(404, {"error": "not found"})

    def _metrics(self):
        """Prometheus text exposition of the engine counters (the format
        every scraper speaks; counters suffixed _total, gauges bare)."""
        s = self.server.loop.stats()
        px = s.pop("prefix_cache", None)
        lines = [
            "# TYPE llama3np_active_requests gauge",
            f"llama3np_active_requests {s['active']}",
            "# TYPE llama3np_queued_requests gauge",
            f"llama3np_queued_requests {s['engine_queue']}",
            "# TYPE llama3np_served_requests_total counter",
            f"llama3np_served_requests_total {s['served_requests']}",
            "# TYPE llama3np_served_tokens_total counter",
            f"llama3np_served_tokens_total {s['served_tokens']}",
            "# TYPE llama3np_engine_steps_total counter",
            f"llama3np_engine_steps_total {s['engine_steps']}",
            "# TYPE llama3np_step_seconds_total counter",
            f"llama3np_step_seconds_total {s['step_seconds_total']:.6f}",
            "# TYPE llama3np_step_seconds_ema gauge",
            f"llama3np_step_seconds_ema {s['step_seconds_ema']:.6f}",
        ]
        if px is not None:
            for k, v in px.items():
                kind = "counter" if k != "entries" else "gauge"
                suffix = "_total" if kind == "counter" else ""
                lines.append(f"# TYPE llama3np_prefix_{k}{suffix} {kind}")
                lines.append(f"llama3np_prefix_{k}{suffix} {v}")
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"error": "invalid JSON body"})
            return
        if self.path in ("/v1/completions", "/completions"):
            self._completions(body)
        elif self.path in ("/v1/chat/completions", "/chat/completions"):
            self._chat_completions(body)
        else:
            self._json(404, {"error": "not found"})

    def _completions(self, body):
        if "prompt_ids" in body:
            try:
                prompt_ids = [int(t) for t in body["prompt_ids"]]
            except (TypeError, ValueError):
                self._json(400, {"error": "prompt_ids must be a list of ints"})
                return
        elif "prompt" in body:
            tok = self.server.tokenizer
            if tok is None:
                self._json(400, {"error": "server has no tokenizer; "
                                          "send prompt_ids"})
                return
            prompt_ids = tok.encode(str(body["prompt"]), add_bos=True)
        else:
            self._json(400, {"error": "prompt or prompt_ids required"})
            return

        max_tokens = int(body.get("max_tokens", 16))
        temperature = float(body.get("temperature", 0.0))
        stop_ids = tuple(body.get("stop_ids", (1, 2)))
        stream = bool(body.get("stream", False))
        echo = bool(body.get("echo", False))
        n_choices = int(body.get("n", 1))
        logprobs = body.get("logprobs")
        if logprobs is not None:
            logprobs = int(logprobs)
        if n_choices < 1:
            self._json(400, {"error": "n must be >= 1"})
            return
        if stream and n_choices != 1:
            self._json(400, {"error": "stream supports n=1 only"})
            return
        adapter, err = self._resolve_adapter(body)
        if err:
            self._json(400, {"error": err})
            return

        loop = self.server.loop
        # n > 1: n independent engine requests decode as co-tenants of the
        # same batch (each gets its own request id, so sampled streams
        # differ by the per-request PRNG fold; greedy duplicates by design).
        pends = [loop.submit(prompt_ids, max_tokens, temperature, stop_ids,
                             logprobs, adapter) for _ in range(n_choices)]
        rid = f"cmpl-{int(time.time() * 1e3):x}-{id(pends[0]) & 0xffff:x}"

        if stream:
            self._stream_response(pends[0], rid)
            return

        choices = []
        total_completion = 0
        for i, pend in enumerate(pends):
            tokens: List[int] = []
            lps: List[float] = []
            top: List[list] = []
            while True:
                item = pend.out.get()
                if item is _DONE:
                    break
                tokens.extend(item["ids"])
                if logprobs is not None:
                    lps.extend(item.get("lps", ()))
                    top.extend(item.get("top", ()))
            if pend.error is not None:
                # Abandon the remaining choices in the engine too — otherwise
                # they decode their full budget into queues nobody reads.
                for later in pends[i + 1:]:
                    loop.cancel(later)
                self._json(400, {"error": pend.error})
                return
            text = self._decode((prompt_ids if echo else []) + tokens)
            choice = {"index": i, "text": text, "token_ids": tokens,
                      "finish_reason": pend.finish_reason}
            if logprobs is not None:
                choice["logprobs"] = {"token_logprobs": lps,
                                      "top_logprobs": top}
            choices.append(choice)
            total_completion += len(tokens)
        self._json(200, {
            "id": rid, "object": "text_completion",
            "choices": choices,
            "usage": {"prompt_tokens": len(prompt_ids),
                      "completion_tokens": total_completion,
                      "total_tokens": len(prompt_ids) + total_completion},
        })

    def _stream_response(self, pend: _Pending, rid: str):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: str):
            payload = f"data: {data}\n\n".encode()
            self.wfile.write(f"{len(payload):x}\r\n".encode()
                             + payload + b"\r\n")
            self.wfile.flush()

        n = 0
        try:
            while True:
                item = pend.out.get()
                if item is _DONE:
                    break
                n += len(item["ids"])
                choice = {"index": 0, "text": self._decode(item["ids"]),
                          "token_ids": item["ids"]}
                if "lps" in item:
                    choice["logprobs"] = {"token_logprobs": item["lps"],
                                          "top_logprobs": item["top"]}
                chunk(json.dumps({
                    "id": rid, "object": "text_completion.chunk",
                    "choices": [choice]}))
            if pend.error is not None:
                chunk(json.dumps({"id": rid, "error": pend.error}))
            chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # Client went away mid-stream: free the slot instead of decoding
            # the rest of the budget into a dead socket.
            self.server.loop.cancel(pend)

    # -- chat ------------------------------------------------------------------

    def _chat_completions(self, body):
        from .chat import render_chat, stop_strings
        tok = self.server.tokenizer
        if tok is None:
            self._json(400, {"error": "chat requires a server tokenizer"})
            return
        template = body.get("template",
                            getattr(self.server, "chat_template", "plain"))
        try:
            prompt = render_chat(body.get("messages", []), template)
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        prompt_ids = tok.encode(prompt, add_bos=True)
        max_tokens = int(body.get("max_tokens", 64))
        temperature = float(body.get("temperature", 0.0))
        stream = bool(body.get("stream", False))
        stops = list(stop_strings(template) or [])
        stop = body.get("stop")
        if stop:
            stops += [stop] if isinstance(stop, str) else list(map(str, stop))

        n_choices = int(body.get("n", 1))
        if n_choices < 1:
            self._json(400, {"error": "n must be >= 1"})
            return
        if stream and n_choices != 1:
            self._json(400, {"error": "stream supports n=1 only"})
            return
        adapter, err = self._resolve_adapter(body)
        if err:
            self._json(400, {"error": err})
            return
        loop = self.server.loop
        pends = [loop.submit(prompt_ids, max_tokens, temperature,
                             adapter=adapter)
                 for _ in range(n_choices)]
        rid = f"chatcmpl-{int(time.time() * 1e3):x}-{id(pends[0]) & 0xffff:x}"

        if stream:
            self._chat_stream(pends[0], rid, stops)
            return
        from .chat import truncate_at_stop
        choices = []
        total_completion = 0
        for i, pend in enumerate(pends):
            tokens: List[int] = []
            while True:
                item = pend.out.get()
                if item is _DONE:
                    break
                tokens.extend(item["ids"])
            if pend.error is not None:
                for later in pends[i + 1:]:
                    loop.cancel(later)
                self._json(400, {"error": pend.error})
                return
            text = self._decode(tokens)
            cut = truncate_at_stop(text, stops)
            finish = "stop" if cut != text else pend.finish_reason
            choices.append({"index": i,
                            "message": {"role": "assistant", "content": cut},
                            "finish_reason": finish})
            total_completion += len(tokens)
        self._json(200, {
            "id": rid, "object": "chat.completion",
            "choices": choices,
            "usage": {"prompt_tokens": len(prompt_ids),
                      "completion_tokens": total_completion,
                      "total_tokens": len(prompt_ids) + total_completion},
        })

    def _chat_stream(self, pend: _Pending, rid: str, stops: List[str]):
        """SSE deltas with stop-string holdback: the last max(len(stop))-1
        chars stay buffered so a stop string arriving across chunk
        boundaries is never partially emitted; a hit truncates the stream
        and cancels the request (the engine stops decoding its budget)."""
        from .chat import truncate_at_stop
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: str):
            payload = f"data: {data}\n\n".encode()
            self.wfile.write(f"{len(payload):x}\r\n".encode()
                             + payload + b"\r\n")
            self.wfile.flush()

        def delta_chunk(delta: dict, finish=None):
            chunk(json.dumps({
                "id": rid, "object": "chat.completion.chunk",
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]}))

        hold = max((len(s) for s in stops), default=1) - 1
        ids: List[int] = []
        emitted = 0
        hit = False
        try:
            delta_chunk({"role": "assistant"})
            while True:
                item = pend.out.get()
                if item is _DONE:
                    break
                ids.extend(item["ids"])
                text = self._decode(ids)
                cut = truncate_at_stop(text, stops)
                if len(cut) != len(text):
                    if len(cut) > emitted:
                        delta_chunk({"content": cut[emitted:]})
                        emitted = len(cut)
                    hit = True
                    self.server.loop.cancel(pend)
                    break
                safe = max(len(text) - hold, emitted)
                if safe > emitted:
                    delta_chunk({"content": text[emitted:safe]})
                    emitted = safe
            if pend.error is not None:
                chunk(json.dumps({"id": rid, "error": pend.error}))
            else:
                if not hit:  # flush the holdback tail
                    cut = truncate_at_stop(self._decode(ids), stops)
                    hit = len(cut) != len(self._decode(ids))
                    if len(cut) > emitted:
                        delta_chunk({"content": cut[emitted:]})
                delta_chunk({}, finish="stop" if hit else pend.finish_reason)
            chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            self.server.loop.cancel(pend)


def serve(batch_engine, tokenizer=None, host: str = "127.0.0.1",
          port: int = 8000, quantum: int = 4,
          verbose: bool = False,
          chat_template: str = "plain",
          adapter_names=None) -> ThreadingHTTPServer:
    """Start the HTTP front end; returns the (running) server.  The caller
    owns shutdown: ``srv.shutdown(); srv.loop.shutdown();
    srv.server_close()``.  adapter_names[i] names the engine's adapter i
    for requests' "adapter"."""
    loop = EngineLoop(batch_engine, quantum=quantum)
    srv = ThreadingHTTPServer((host, port), CompletionHandler)
    srv.loop = loop
    srv.tokenizer = tokenizer
    srv.verbose = verbose
    srv.chat_template = chat_template
    srv.adapter_names = list(adapter_names or [])
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="llama3np-torch-http")
    srv._serve_thread = t
    t.start()
    return srv


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="llama3np_tpu_torch.server",
                                description="OpenAI-style completions server")
    p.add_argument("--preset", default="stories15M")
    p.add_argument("--model", default="./stories15M.model.npz")
    p.add_argument("--tokenizer", default="./tokenizer.model.np")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no-tokenizer", action="store_true",
                   help="ids-only API (prompt_ids in, token_ids out)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if there is no card)")
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "bfloat16", "float16"])
    p.add_argument("--capacity", type=int, default=8)
    p.add_argument("--quantum", type=int, default=4)
    p.add_argument("--paged", action="store_true")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--kv-quant", default=None, choices=[None, "int8"])
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--quant", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--admit-chunk", type=int, default=None)
    p.add_argument("--logprobs", type=int, default=None, metavar="K",
                   help="enable per-token logprobs up to top-K")
    p.add_argument("--adapter", action="append", default=[],
                   metavar="NAME=PATH",
                   help="serve a LoRA adapter (save_lora .npz); repeatable "
                        "- requests pick one with \"adapter\": NAME")
    p.add_argument("--chat-template", default="plain",
                   choices=["plain", "llama2", "chatml"],
                   help="default template for /v1/chat/completions")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    from . import Tokenizer, preset, synthetic_weights
    from .models.llama import Llama
    from .serving import BatchEngine

    overrides = {}
    if args.quant:
        overrides["quant"] = args.quant
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.adapter or args.quant == "int4":
        overrides["fuse_matmuls"] = False  # bank deltas / int4 need split
    margs = preset(args.preset, **overrides)
    source = (synthetic_weights(margs, seed=0) if args.synthetic
              else args.model)
    engine = Llama(source, margs, device=args.device)
    names, adapters = [], []
    for spec in args.adapter:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--adapter wants NAME=PATH, got {spec!r}")
        from .lora import load_lora
        names.append(name)
        adapters.append(load_lora(path, device=engine.device))
    be = BatchEngine(engine, capacity=args.capacity, paged=args.paged,
                     page_size=args.page_size, kv_quant=args.kv_quant,
                     admit_chunk=args.admit_chunk,
                     prefix_cache=args.prefix_cache, logprobs=args.logprobs,
                     adapters=adapters or None)
    tok = None if args.no_tokenizer else Tokenizer(args.tokenizer)
    srv = serve(be, tok, args.host, args.port, quantum=args.quantum,
                verbose=args.verbose, chat_template=args.chat_template,
                adapter_names=names)
    print(f"serving {args.preset} on http://{args.host}:{srv.server_address[1]} "
          f"({engine.device}, capacity {args.capacity}, quantum {args.quantum})",
          flush=True)
    try:
        srv._serve_thread.join()
    except KeyboardInterrupt:
        srv.shutdown()
        srv.loop.shutdown()
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
