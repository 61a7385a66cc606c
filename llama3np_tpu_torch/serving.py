"""Continuous-batching serving engine.

Counterpart of `llama3np_tpu.serving`: a slot-based engine that admits
requests at any time, decodes one token (or a quantum of tokens) per step
for every active request in one ragged step (`forward_ragged_decode`: per-row
positions), and retires finished requests, freeing their slot and pages for
the next admission.

  * The batch is a fixed set of `capacity` slots.  Idle slots still flow
    through the step; their writes land on their own slot row (dense) or on
    the null page (paged) and are overwritten before any read.
  * Admission prefills one request on a single-row cache through
    `forward_hidden(first_chunk=True)` (the flash-prefill kernel on the
    card) and copies it into the slot's rows or pages.  With `admit_chunk`,
    a long prompt prefills in chunks, with decode steps for the co-tenants
    between them.
  * Host state stays numpy: block tables, positions, last tokens and the
    page allocator.  Each step hands them to the device once and reads the
    new tokens back once; nothing waits on the device per layer.

  * int8 KV (`kv_quant="int8"`, or the model's `args.kv_quant`): the
    cache holds int8 rows with per-(token, KV head) scales.  Admission
    prefills into a row cache of the activation dtype, and its rows
    quantize once, when they are copied into the slot or the pages.
  * A bf16 (float16) model serves from bf16 (float16) pools (the cache
    follows `kv_dtype`), or with `kv_quant="int8"` from int8 pools under
    its 16-bit q; on the card its paged steps run the paged kernel's mode
    for that pool and q.

Still to port, each raising NotImplementedError: sampling (`temperature >
0`, ROADMAP A1), the prefix cache (`prefix_cache`, with `gather_pool_row`,
A2), multi-LoRA (`adapters`, A7) and tensor-parallel serving (A9).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch

from .checkpoint import torch_dtype
from .generate import _last_logits, pad_prompt
from .kvcache import PageAllocator, init_cache, init_paged_cache
from .models.llama import (forward_hidden, forward_ragged_decode,
                           ragged_decode_steps, token_logprobs)
from .ops.core import quantize_kv_rows


def _row_cache(cache, M: int, row_dtype=None):
    """A zeroed single-request cache [NL, 1, KVH, M, HD] on the cache's
    device, of `row_dtype` (the activation dtype an int8 cache's admission
    prefills in) or else of the cache's own dtype."""
    k = cache["k"]
    shape = (k.shape[0], 1, k.shape[2], M, k.shape[-1])
    dt = row_dtype or k.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=k.device),
            "v": torch.zeros(shape, dtype=dt, device=k.device)}


def _stored_rows(row, cache):
    """The row cache's k/v as the serving cache stores them: quantized, with
    their scales, when the cache is int8 ("k_s" present)."""
    if "k_s" not in cache:
        return row
    k8, ks = quantize_kv_rows(row["k"])  # scales [NL, 1, KVH, M]
    v8, vs = quantize_kv_rows(row["v"])
    return {"k": k8, "v": v8, "k_s": ks, "v_s": vs}


def admission_prefill_dense(params, padded, true_len: int, slot: int, cache,
                            cos, sin, cfg, row_dtype=None):
    """Prefill one request (padded [1, L'] ids) on a fresh single-row cache
    and copy its K/V into `slot` of the dense serving cache, in place
    (int8 caches quantize here, the single write point).  Returns
    (last-position logits [1, VS], cache)."""
    row = _row_cache(cache, cache["k"].shape[3], row_dtype)
    h, row = forward_hidden(params, padded, 0, row, cos, sin, cfg,
                            first_chunk=True)
    for name, r in _stored_rows(row, cache).items():
        cache[name][:, slot] = r[:, 0]
    return _last_logits(params, h, true_len, cfg)[:, -1, :], cache


def scatter_row_paged(row, page_idx: torch.Tensor, cache):
    """Copy a request's row cache [NL, 1, KVH, M, HD] into the page pool at
    `page_idx` ([max_pages], unused entries -> null page 0), in place: page
    j of the row lands at pool page page_idx[j] of every layer.  int8 pools
    quantize here."""
    nl, _, kvh, page, _ = cache["k"].shape
    n = page_idx.shape[0]
    for name, r in _stored_rows(row, cache).items():
        tail = r.shape[4:]  # (HD,) for values, () for scales
        r = r[:, 0].reshape(nl, kvh, n, page, *tail).transpose(1, 2)
        cache[name][:, page_idx.long()] = r  # [NL, n, KVH, page, *tail]
    return cache


def admission_prefill_paged(params, padded, true_len: int,
                            page_idx: torch.Tensor, cache, cos, sin, cfg,
                            row_dtype=None):
    """Paged admission: prefill one request and copy its K/V rows into the
    page pool at `page_idx`.  Returns (logits [1, VS], cache)."""
    row = _row_cache(cache, page_idx.shape[0] * cache["k"].shape[3], row_dtype)
    h, row = forward_hidden(params, padded, 0, row, cos, sin, cfg,
                            first_chunk=True)
    logits = _last_logits(params, h, true_len, cfg)
    return logits[:, -1, :], scatter_row_paged(row, page_idx, cache)


def prefill_row_chunk(params, chunk_ids, start: int, chunk_len: int, row,
                      cos, sin, cfg, first_chunk: bool):
    """One chunk of a chunked admission against the request's row cache.

    chunk_ids: [1, A] (a tail chunk padded); start: absolute position of
    the chunk's first token; chunk_len: its real tokens.  Returns
    (logits at the last real position [1, VS], row).  The first chunk goes
    through flash prefill on the card; later chunks attend the row-cache
    prefix through the model's chunked-prefill path (plain in both
    packages)."""
    h, row = forward_hidden(params, chunk_ids, start, row, cos, sin, cfg,
                            first_chunk=first_chunk)
    return _last_logits(params, h, chunk_len, cfg)[:, -1, :], row


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    stop_ids: tuple = (1, 2)  # bos/eos, the reference's stop set (quirk Q6)
    temperature: float = 0.0  # 0 = greedy (the only policy ported)
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    admitting: bool = False  # mid chunked-admission: slot reserved, no decode
    # Per-token log-probabilities (None = not requested; k >= 0 = record the
    # chosen token's logprob plus the top-k alternatives), aligned with
    # `generated` (a popped stop token pops its entries too).
    logprobs: Optional[int] = None
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[List[tuple]] = dataclasses.field(default_factory=list)

    def _record_logprob(self, lp: float, ids, lps) -> None:
        self.token_logprobs.append(float(lp))
        k = self.logprobs or 0
        self.top_logprobs.append(
            [(int(i), float(v)) for i, v in zip(ids[:k], lps[:k])])


class BatchEngine:
    """Continuous batching over a `Llama` engine's params, on its device.

    paged=True swaps the dense per-slot cache for a page pool and block
    tables (kvcache.init_paged_cache): device memory holds the pages that
    exist.  Pages are allocated at admission and on demand as a sequence
    crosses a page boundary, under an admission-time worst-case
    reservation, so a step never runs out of pages.  On the card each paged
    decode step runs the paged-attention kernel once per layer.

    kv_quant="int8" (or the model's `args.kv_quant`) stores the cache as
    int8 rows with f32 scales (kvcache.init_cache / init_paged_cache).
    """

    def __init__(self, engine, capacity: int = 8, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 admit_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 logprobs: Optional[int] = None,
                 adapters: Optional[list] = None):
        self.engine = engine
        self.args = engine.args
        self.cfg = engine.cfg
        self.device = engine.device
        self.capacity = capacity
        self.paged = paged
        kv_quant = kv_quant or self.args.kv_quant
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        self.kv_quant = kv_quant
        # int8 caches: admission prefills in the activation dtype and its
        # rows quantize once, at the copy into the cache.
        self._row_dt = torch_dtype(self.args.dtype) if kv_quant else None
        if prefix_cache:
            raise NotImplementedError("the prefix cache is still to port "
                                      "(ROADMAP A2)")
        if adapters:
            raise NotImplementedError("multi-LoRA serving is still to port "
                                      "(ROADMAP A7)")
        if self.args.mesh_tp > 1 or self.args.mesh_dp > 1:
            raise NotImplementedError("sharded serving is still to port "
                                      "(ROADMAP A9)")
        if admit_chunk is not None:
            # Chunked admission parks the slot on an all-zero block table:
            # interleaved decode steps write its K/V into the null page,
            # never into live cache.  The dense layout has no such sink.
            if not paged:
                raise ValueError("admit_chunk requires paged=True")
            if self.args.max_seq_len % admit_chunk:
                raise ValueError("admit_chunk must divide max_seq_len "
                                 "(chunk starts stay in-bounds)")
        self.admit_chunk = admit_chunk
        self._in_admission = False
        if paged:
            if self.args.max_seq_len % page_size:
                raise ValueError("page_size must divide max_seq_len")
            self.page_size = page_size
            self.max_pages = self.args.max_seq_len // page_size
            if num_pages is None:
                num_pages = 1 + capacity * self.max_pages
            self.allocator = PageAllocator(num_pages)
            self.cache = init_paged_cache(self.args, num_pages, page_size,
                                          quant=kv_quant, device=self.device)
            self.block_tables = np.zeros((capacity, self.max_pages), np.int32)
            self._pages: List[List[int]] = [[] for _ in range(capacity)]
            # Reserved-but-unallocated worst-case tail pages per slot.
            self._future_pages = np.zeros(capacity, np.int64)
        else:
            self.cache = init_cache(self.args, capacity, quant=kv_quant,
                                    device=self.device)
        self.pos = np.zeros(capacity, np.int32)     # next write position
        self.tokens = np.zeros(capacity, np.int32)  # last token per slot
        self.slots: List[Optional[Request]] = [None] * capacity
        self._ids = itertools.count()
        self._queue: List[Request] = []
        # `logprobs` is the engine-wide top-K; requests record at most their
        # own submit(logprobs=k) <= K entries.
        if logprobs is not None and logprobs < 1:
            raise ValueError("engine logprobs (top-K) must be >= 1")
        self.logprobs_k = logprobs

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host state on the engine's device."""
        return torch.tensor(a, device=self.device)

    # -- admission -----------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, stop_ids=(1, 2),
               temperature: float = 0.0, logprobs: Optional[int] = None,
               adapter: Optional[int] = None) -> Request:
        if temperature > 0:
            raise NotImplementedError("sampled serving is still to port "
                                      "(ROADMAP A1); the port serves greedy "
                                      "requests")
        if adapter is not None:
            raise NotImplementedError("multi-LoRA serving is still to port "
                                      "(ROADMAP A7)")
        req = Request(next(self._ids), list(prompt_ids), max_new_tokens,
                      tuple(stop_ids), temperature, logprobs=logprobs)
        # Validate at submission: a bad request must fail here, not in a
        # later step() when it is admitted from the queue.
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if logprobs is not None:
            if self.logprobs_k is None:
                raise ValueError("engine was built without logprobs support "
                                 "(BatchEngine(..., logprobs=K))")
            if not 0 <= logprobs <= self.logprobs_k:
                raise ValueError(f"logprobs must be in [0, {self.logprobs_k}]"
                                 f" (the engine's top-K)")
        if len(req.prompt_ids) + req.max_new_tokens > self.args.max_seq_len:
            raise ValueError(
                f"request exceeds max_seq_len: prompt {len(req.prompt_ids)} "
                f"+ max_new_tokens {req.max_new_tokens} > {self.args.max_seq_len}")
        if self.paged:
            worst_pages = -(-(len(req.prompt_ids) + req.max_new_tokens)
                            // self.page_size)
            if worst_pages > self.allocator.num_pages - 1:
                raise MemoryError(f"request needs up to {worst_pages} pages; "
                                  f"pool has {self.allocator.num_pages - 1}")
        self._queue.append(req)
        self._admit()
        return req

    def _worst_case_pages(self, req: Request) -> int:
        return min(-(-(len(req.prompt_ids) + req.max_new_tokens)
                     // self.page_size), self.max_pages)

    def _reservation_fits(self, req: Request) -> bool:
        """Admission-time worst-case page reservation: every active request's
        not-yet-allocated tail pages count against the pool, so
        `_ensure_pages` never meets an exhausted pool mid-step."""
        n_needed = min(-(-(len(req.prompt_ids) + 1) // self.page_size),
                       self.max_pages)
        outstanding = int(sum(self._future_pages))
        return (self.allocator.available - outstanding
                >= max(self._worst_case_pages(req), n_needed))

    def _admit(self):
        if self._in_admission:
            return  # an interleaved step() during a chunked admission
        for slot in range(self.capacity):
            if not self._queue:
                return
            if self.slots[slot] is not None:
                continue
            if self.paged and not self._reservation_fits(self._queue[0]):
                return  # backpressure: admit again once pages free up
            self._prefill_into(slot, self._queue.pop(0))

    def _admit_row(self, slot: int, req: Request, padded, L: int):
        """Chunked admission: prefill the prompt in chunks against a row
        cache, with a decode step for the co-tenants between chunks, then
        copy the row into the slot's pages.  The slot is reserved
        (req.admitting) with an all-zero block table: interleaved decode
        writes for it land on the null page and its tokens are discarded, so
        live state is untouched until the final copy."""
        eng = self.engine
        page = self.page_size
        n_needed = min(-(-(L + 1) // page), self.max_pages)
        pages = self.allocator.alloc(n_needed)
        self._pages[slot] = pages
        self._future_pages[slot] = self._worst_case_pages(req) - n_needed
        self.block_tables[slot] = 0  # parked
        req.slot = slot
        req.admitting = True
        self.slots[slot] = req  # reserve: queued admissions skip this slot
        self.pos[slot] = 0
        M = self.max_pages * page
        row = _row_cache(self.cache, M, self._row_dt)
        self._in_admission = True
        try:
            logits0, start = None, 0
            while start < L:
                A = min(self.admit_chunk, M - start)  # never past M
                clen = min(A, L - start)
                cids = np.zeros((1, A), np.int64)
                cids[0, :clen] = padded[0, start : start + clen]
                logits0, row = prefill_row_chunk(
                    eng.params, self._dev(cids), start, clen, row, eng.cos,
                    eng.sin, self.cfg, first_chunk=start == 0)
                start += clen
                if start < L and any(r is not None and not r.admitting
                                     for r in self.slots):
                    self.step()  # co-tenants advance between chunks
        finally:
            self._in_admission = False
        idx = np.zeros(self.max_pages, np.int64)
        idx[:n_needed] = pages
        self.cache = scatter_row_paged(row, self._dev(idx), self.cache)
        self.block_tables[slot, :n_needed] = pages
        req.admitting = False
        return logits0

    def _prefill_into(self, slot: int, req: Request):
        eng = self.engine
        padded, L = pad_prompt(np.asarray([req.prompt_ids], np.int64),
                               self.args)
        if self.paged and self.admit_chunk and L > self.admit_chunk:
            logits0 = self._admit_row(slot, req, padded, L)
        elif self.paged:
            # Pages covering the prompt and tok0's upcoming write (L + 1 <=
            # max_seq_len, as submit validated); the worst-case tail stays
            # reserved as future pages.
            n_needed = min(-(-(L + 1) // self.page_size), self.max_pages)
            pages = self.allocator.alloc(n_needed)
            self._pages[slot] = pages
            self._future_pages[slot] = self._worst_case_pages(req) - n_needed
            self.block_tables[slot] = 0
            self.block_tables[slot, :n_needed] = pages
            idx = np.zeros(self.max_pages, np.int64)  # pad -> null page 0
            idx[:n_needed] = pages
            logits0, self.cache = admission_prefill_paged(
                eng.params, self._dev(padded), L, self._dev(idx), self.cache,
                eng.cos, eng.sin, self.cfg, self._row_dt)
        else:
            logits0, self.cache = admission_prefill_dense(
                eng.params, self._dev(padded), L, slot, self.cache, eng.cos,
                eng.sin, self.cfg, self._row_dt)
        tok0 = torch.argmax(logits0, dim=-1)
        first = int(tok0[0])
        req.slot = slot
        self.slots[slot] = req
        req.generated.append(first)
        if req.logprobs is not None:
            l1, i1, v1 = token_logprobs(logits0, tok0, self.logprobs_k)
            req._record_logprob(float(l1[0]), i1[0].tolist(), v1[0].tolist())
        self.tokens[slot] = first
        self.pos[slot] = L  # `first`'s own position; written by the next step
        self._maybe_finish(req, first)

    # -- stepping ------------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def _ensure_pages(self, horizon: int = 1):
        """Grow any active row whose writes within the next `horizon` steps
        (at pos .. pos+horizon-1) cross into unallocated pages.  The horizon
        is capped at the request's remaining budget: tokens past it are
        discarded, and their writes go through unallocated block-table
        entries to the null page."""
        for slot, req in enumerate(self.slots):
            if req is None or req.admitting:
                continue  # parked mid-admission: null-page writes, no growth
            remaining = max(req.max_new_tokens - len(req.generated), 0)
            h = max(min(horizon, remaining), 1)
            need = (int(self.pos[slot]) + h - 1) // self.page_size
            # Quantum overrun past max_seq_len clamps into the row's last
            # page; those slots are never attended.
            need = min(need, self.max_pages - 1)
            have = len(self._pages[slot])
            while have <= need:
                (pid,) = self.allocator.alloc(1)  # covered by the admission reservation
                self._pages[slot].append(pid)
                self.block_tables[slot, have] = pid
                self._future_pages[slot] = max(self._future_pages[slot] - 1, 0)
                have += 1

    def step(self, quantum: int = 1) -> List[Request]:
        """Decode up to `quantum` tokens for every active slot; returns the
        requests finished during the quantum.  A request that stops
        mid-quantum discards its tail tokens; their cache writes are never
        attended before they are written again."""
        if self.num_active == 0:
            return []
        bt = None
        if self.paged:
            self._ensure_pages(quantum)
            bt = self._dev(self.block_tables)
        eng = self.engine
        tokens, pos = self._dev(self.tokens), self._dev(self.pos)
        lp = None  # (chosen_lp [B, q], top_ids [B, q, K], top_lps [B, q, K])
        if quantum == 1:
            logits, self.cache = forward_ragged_decode(
                eng.params, tokens, pos, self.cache, eng.cos, eng.sin,
                self.cfg, block_table=bt)
            nxt = torch.argmax(logits, dim=-1)
            toks = nxt[:, None]
            if self.logprobs_k is not None:
                lp = tuple(x[:, None] for x in
                           token_logprobs(logits, nxt, self.logprobs_k))
        else:
            out = ragged_decode_steps(
                eng.params, tokens, pos, self.cache, eng.cos, eng.sin,
                self.cfg, quantum, block_table=bt,
                num_logprobs=self.logprobs_k)
            if self.logprobs_k is not None:
                toks, lp, self.cache = out
            else:
                toks, self.cache = out
        toks = toks.cpu().numpy()  # [B, quantum]
        if lp is not None:
            lp = tuple(x.cpu().numpy() for x in lp)
        finished = []
        for slot, req in enumerate(self.slots):
            if req is None or req.done or req.admitting:
                continue  # mid-admission slots discard their parked tokens
            for j, tok in enumerate(map(int, toks[slot])):
                req.generated.append(tok)
                if req.logprobs is not None and lp is not None:
                    req._record_logprob(lp[0][slot, j], lp[1][slot, j],
                                        lp[2][slot, j])
                self.tokens[slot] = tok
                self.pos[slot] += 1
                if self._maybe_finish(req, tok):
                    finished.append(req)
                    break
        self._admit()
        return finished

    def _maybe_finish(self, req: Request, tok: int) -> bool:
        hit_stop = tok in req.stop_ids
        over = len(req.generated) >= req.max_new_tokens
        full = len(req.prompt_ids) + len(req.generated) >= self.args.max_seq_len
        if hit_stop or over or full:
            if hit_stop:
                req.generated.pop()  # the stop token is not emitted
                if req.logprobs is not None and req.token_logprobs:
                    req.token_logprobs.pop()  # stay aligned with `generated`
                    req.top_logprobs.pop()
            self._release_slot(req)
            return True
        return False

    def _release_slot(self, req: Request) -> None:
        """Finish `req` and return its slot (and pages) to the engine."""
        req.done = True
        self.slots[req.slot] = None
        # An idle row still flows through each step: at position 0 its
        # paged attention reads one null page, not its old length.
        self.pos[req.slot] = 0
        if self.paged:
            self.allocator.free(self._pages[req.slot])
            self._pages[req.slot] = []
            self._future_pages[req.slot] = 0
            self.block_tables[req.slot] = 0

    def cancel(self, req: Request) -> bool:
        """Abort a queued or active request, freeing its slot and pages for
        the next admission.  Call it from the thread that owns the engine,
        as for step() and submit().  Returns True if the request was live
        and is now finished, False if it had already finished."""
        if req.done:
            return False
        if req in self._queue:
            self._queue.remove(req)
            req.done = True
            return True
        if req.slot is None or self.slots[req.slot] is not req:
            return False
        if req.admitting:
            raise RuntimeError("cancel during admission (engine thread "
                               "re-entrancy) is not supported")
        self._release_slot(req)
        self._admit()  # the freed slot can seat a queued request now
        return True

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.num_active == 0 and not self._queue:
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")
