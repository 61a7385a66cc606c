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
  * Any weight tree the engine holds serves: fused or split
    (`fuse_matmuls=False`), float, int8 or int4; only the forward's
    projections differ.

  * Sampling (`temperature > 0` a request): token j of request r is drawn
    under fold_in(fold_in(PRNGKey(sampling_seed), r), j), the JAX
    engine's schedule, so a sampled stream is the JAX engine's and does
    not depend on co-tenants, admission time or quantum.
  * A model of another block (`models/deepseek_v2.py`: latent attention
    and experts) brings its own pool and forward, which the engine takes
    from the model object (`init_paged_pool`, `prefill_paged`,
    `decode_paged`): the scheduler, page allocator and block tables are
    the same.  Paged only, one token a step; no int8 pools, prefix cache,
    chunked admission or adapters (`_refuse_for_own_block`).
  * The prefix cache (`prefix_cache=True`, paged): admission looks up the
    prompt's full pages in a `prefix.PrefixRegistry`, shares the hit
    pages into the slot's block table, gathers their K/V into the row
    cache (`gather_pool_row`) and prefills only the suffix; finished
    conversations stay registered for the next turn, and cached pages
    evict LRU under pool pressure.

  * Multi-LoRA (`adapters=[...]`, the split layout): a bank of adapters
    served at once (`lora.stack_adapters`, bank slot 0 the zero adapter);
    a request picks its adapter at submit(adapter=i), its admission
    prefills through that adapter, and co-tenant rows decode through
    different adapters in one ragged step (per-row low-rank deltas).

  * Tensor parallelism (an engine built with `mesh=`, ROADMAP A9): every
    rank runs this same scheduler (queue, block tables, sampling keys,
    quanta) over pools of its own KV heads; the model's collectives make
    every rank's logits the same, so every rank picks the same tokens and
    returns the same results.  The pools do not split over "dp": a whole
    engine is the unit of data parallelism
    (`parallel.sharding.serving_cache_pspecs`).
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
from .models.llama import (fold_row_keys, forward_hidden,
                           forward_ragged_decode, ragged_decode_steps,
                           sample_rows, sampled_ragged_decode_steps,
                           token_logprobs)
from .ops.core import quantize_kv_rows
from .prefix import PrefixRegistry
from .prng import prng_key


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
                            cos, sin, cfg, row_dtype=None, lora=None):
    """Prefill one request (padded [1, L'] ids) on a fresh single-row cache
    and copy its K/V into `slot` of the dense serving cache, in place
    (int8 caches quantize here, the single write point).  `lora`: the
    request's single-adapter tree, or None.  Returns (last-position logits
    [1, VS], cache)."""
    row = _row_cache(cache, cache["k"].shape[3], row_dtype)
    h, row = forward_hidden(params, padded, 0, row, cos, sin, cfg,
                            first_chunk=True, lora=lora)
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
                            row_dtype=None, lora=None):
    """Paged admission: prefill one request (through its adapter `lora`,
    if any) and copy its K/V rows into the page pool at `page_idx`.
    Returns (logits [1, VS], cache)."""
    row = _row_cache(cache, page_idx.shape[0] * cache["k"].shape[3], row_dtype)
    h, row = forward_hidden(params, padded, 0, row, cos, sin, cfg,
                            first_chunk=True, lora=lora)
    logits = _last_logits(params, h, true_len, cfg)
    return logits[:, -1, :], scatter_row_paged(row, page_idx, cache)


def gather_pool_row(cache, idx: torch.Tensor, row_dtype):
    """Gather pool pages `idx` ([max_pages], 0 = the null page) into a row
    cache [NL, 1, KVH, M, HD] of `row_dtype`: the prefix-cache admission
    copies a shared prefix's K/V from the pool instead of recomputing it.
    int8 pools dequantize here, (k.float() * scale) rounded to
    `row_dtype` as the JAX package rounds it; the suffix prefill then
    attends the values decode attention reconstructs."""
    nl, _, kvh, page, hd = cache["k"].shape
    idx = idx.long()

    def to_row(c):  # [NL, n, KVH, page, HD] -> [NL, 1, KVH, n*page, HD]
        return c.transpose(1, 2).reshape(nl, kvh, idx.shape[0] * page,
                                         hd)[:, None].contiguous()

    row = {}
    for name in ("k", "v"):
        c = cache[name][:, idx]
        if "k_s" in cache:
            c = c.float() * cache[name + "_s"][:, idx][..., None]
        row[name] = to_row(c.to(row_dtype))
    return row


def prefill_row_chunk(params, chunk_ids, start: int, chunk_len: int, row,
                      cos, sin, cfg, first_chunk: bool, lora=None):
    """One chunk of a chunked admission against the request's row cache.

    chunk_ids: [1, A] (a tail chunk padded); start: absolute position of
    the chunk's first token; chunk_len: its real tokens.  Returns
    (logits at the last real position [1, VS], row).  The first chunk goes
    through flash prefill on the card; later chunks attend the row-cache
    prefix through the model's chunked-prefill path (plain in both
    packages).  `lora`: the request's single-adapter tree, or None."""
    h, row = forward_hidden(params, chunk_ids, start, row, cos, sin, cfg,
                            first_chunk=first_chunk, lora=lora)
    return _last_logits(params, h, chunk_len, cfg)[:, -1, :], row


def _refuse_for_own_block(paged, kv_quant, admit_chunk, prefix_cache, adapters):
    """What a model with its own block (latent attention and experts) does
    not have built: each refusal names the missing piece."""
    missing = [(not paged, "a dense cache (it serves from its paged latent pool: "
                           "paged=True)"),
               (kv_quant is not None, f"kv_quant={kv_quant!r} (an int8 latent pool)"),
               (admit_chunk is not None, "admit_chunk (chunked admission)"),
               (prefix_cache, "prefix_cache (shared latent pages)"),
               (bool(adapters), "adapters (LoRA serving)")]
    for absent, what in missing:
        if absent:
            raise ValueError(f"not built for this model: {what}")


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    stop_ids: tuple = (1, 2)  # bos/eos, the reference's stop set (quirk Q6)
    temperature: float = 0.0  # 0 = greedy
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    admitting: bool = False  # mid chunked-admission: slot reserved, no decode
    # Multi-LoRA: the BANK index (0 = the base model; submit(adapter=i)
    # maps to i + 1, bank slot 0 being the zero adapter).
    adapter: int = 0
    # Per-token log-probabilities (None = not requested; k >= 0 = record the
    # chosen token's logprob plus the top-k alternatives), aligned with
    # `generated` (a popped stop token pops its entries too).
    logprobs: Optional[int] = None
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[List[tuple]] = dataclasses.field(default_factory=list)

    @property
    def text_ids(self) -> List[int]:
        return list(self.prompt_ids) + self.generated

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

    A request's temperature (submit) picks greedy (0) or sampled decoding
    for its row; top_k, top_p and sampling_seed are engine-wide.
    prefix_cache=True (paged only) shares full KV pages across requests
    with a common prompt prefix and keeps finished conversations for
    follow-up turns (`prefix.PrefixRegistry`); cached pages count as free
    for admission and evict LRU when the pool needs them.

    adapters=[lora trees] (the split layout, `fuse_matmuls=False`) serves
    those LoRA adapters beside the base model: submit(adapter=i) decodes a
    request through adapters[i], submit() through none.  It refuses the
    prefix cache: a prefix's K/V depends on the adapter that prefilled it.
    """

    def __init__(self, engine, capacity: int = 8, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0, sampling_seed: int = 0,
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
        # A model with a block of its own serves through its own pool and
        # forward (the module docstring).
        self._own_block = hasattr(engine, "decode_paged")
        if self._own_block:
            _refuse_for_own_block(paged, kv_quant, admit_chunk, prefix_cache, adapters)
        else:
            kv_quant = kv_quant or self.args.kv_quant
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        self.kv_quant = kv_quant
        # int8 caches: admission prefills in the activation dtype and its
        # rows quantize once, at the copy into the cache.
        self._row_dt = torch_dtype(self.args.dtype) if kv_quant else None
        if prefix_cache and not paged:
            # Sharing is block-table indirection; the dense layout has none.
            raise ValueError("prefix_cache requires paged=True")
        # Multi-LoRA: co-tenant rows decode through different adapters in
        # one ragged step (per-row low-rank deltas, gather_lora_rows).
        self.lora_bank = None
        if adapters:
            if self.cfg.fused:
                raise ValueError("multi-LoRA serving needs the unfused "
                                 "split layout (fuse_matmuls=False)")
            if prefix_cache:
                # Cross-adapter sharing would serve adapter A's K/V to
                # adapter B's request.
                raise ValueError("prefix_cache cannot compose with "
                                 "multi-LoRA serving (adapter-dependent KV)")
            from .lora import stack_adapters
            on_dev = [{**ad, "layers": {k: v.to(self.device) for k, v in ad["layers"].items()}}
                      for ad in adapters]
            self.lora_bank = stack_adapters(on_dev, self.args,
                                            rope_split=self.cfg.rope_split,
                                            dtype=self.args.dtype)
        # The factors the forward reads: under a mesh every rank holds the
        # whole bank and reads its shards' slices of it (views, in
        # `lora.shard_lora`'s layout).
        self._bank_view = self.lora_bank
        if adapters and self.cfg.mesh is not None:
            from .lora import local_lora_layers
            self._bank_view = {**self.lora_bank, "layers": local_lora_layers(
                self.lora_bank["layers"], self.cfg.mesh)}
        self.adapter_ids = np.zeros(capacity, np.int32)
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
            if self._own_block:
                self.cache = engine.init_paged_pool(num_pages, page_size)
            else:
                self.cache = init_paged_cache(self.args, num_pages, page_size,
                                              quant=kv_quant, device=self.device,
                                              kv_heads=self.cfg.kv_heads)
            self.block_tables = np.zeros((capacity, self.max_pages), np.int32)
            self._pages: List[List[int]] = [[] for _ in range(capacity)]
            # Reserved-but-unallocated worst-case tail pages per slot.
            self._future_pages = np.zeros(capacity, np.int64)
        else:
            self.cache = init_cache(self.args, capacity, quant=kv_quant,
                                    device=self.device, kv_heads=self.cfg.kv_heads)
        self._registry = PrefixRegistry(page_size) if prefix_cache else None
        self.pos = np.zeros(capacity, np.int32)     # next write position
        self.tokens = np.zeros(capacity, np.int32)  # last token per slot
        # Per-slot temperature (0 = greedy), request id and tokens drawn so
        # far: the sampling keys' inputs.
        self.temps = np.zeros(capacity, np.float32)
        self.rids = np.zeros(capacity, np.int32)
        self.sample_ctr = np.zeros(capacity, np.int32)
        self.top_k = top_k
        self.top_p = top_p
        # The keys are made on the host (fold_row_keys) and reach the device
        # once a step.
        self._base_key = prng_key(sampling_seed)
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

    def _sample_impl(self, logits, rids, ctrs, temps) -> torch.Tensor:
        """Each row's token under its key fold_row_keys(base, rid, ctr)."""
        keys = self._dev(fold_row_keys(self._base_key, rids, ctrs))
        return sample_rows(logits, keys, self._dev(temps), self.top_k,
                           self.top_p)

    def _sampling_active(self) -> bool:
        return bool((self.temps > 0).any())

    # -- admission -----------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, stop_ids=(1, 2),
               temperature: float = 0.0, logprobs: Optional[int] = None,
               adapter: Optional[int] = None) -> Request:
        if adapter is not None:
            if self.lora_bank is None:
                raise ValueError("engine was built without adapters "
                                 "(BatchEngine(..., adapters=[...]))")
            n = next(iter(self.lora_bank["layers"].values())).shape[1] - 1
            if not 0 <= adapter < n:
                raise ValueError(f"adapter must be in [0, {n})")
        req = Request(next(self._ids), list(prompt_ids), max_new_tokens,
                      tuple(stop_ids), temperature, logprobs=logprobs,
                      adapter=0 if adapter is None else adapter + 1)
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
                                 f" (the engine's static top-K)")
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
        `_ensure_pages` never meets an exhausted pool mid-step.  Pages only
        the prefix cache holds count as available: they evict on demand
        (`_alloc`)."""
        n_needed = min(-(-(len(req.prompt_ids) + 1) // self.page_size),
                       self.max_pages)
        outstanding = int(sum(self._future_pages))
        avail = self.allocator.available
        if self._registry is not None:
            avail += self._registry.evictable_pages(self.allocator)
        return avail - outstanding >= max(self._worst_case_pages(req), n_needed)

    def _alloc(self, n: int) -> list:
        """Allocate pages, evicting LRU prefix-cache entries when the free
        list alone cannot cover them (the reservation counted them)."""
        if self._registry is not None and self.allocator.available < n:
            self._registry.evict(n - self.allocator.available, self.allocator)
        return self.allocator.alloc(n)

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

    def _adm_lora(self, req: Request):
        """The single-adapter tree of the request's admission prefill (None
        when the engine has no bank)."""
        if self.lora_bank is None:
            return None
        from .lora import bank_adapter_slice
        return bank_adapter_slice(self._bank_view, req.adapter)

    def _admit_row(self, slot: int, req: Request, padded, L: int,
                   n_hit: int = 0, shared: Optional[list] = None):
        """Row-cache admission: prefill the prompt in chunks against a row
        cache, then copy the row into the slot's pages.  It serves two
        features:

        * chunked admission (admit_chunk set): a decode step for the
          co-tenants between chunks;
        * the prefix cache (n_hit > 0): the first `n_hit` pages' K/V is
          gathered from the pool (`shared`, computed by an earlier
          request) and only tokens from n_hit * page on are prefilled.
          Shared pages enter the slot's block table and are never
          rewritten: decode writes start at pos = L, past them.

        The slot is reserved (req.admitting) with an all-zero block table:
        interleaved decode writes for it land on the null page and its
        tokens are discarded, so live state is untouched until the final
        copy."""
        eng = self.engine
        page = self.page_size
        shared = list(shared or [])
        n_needed = min(-(-(L + 1) // page), self.max_pages)
        # Share before allocating: _alloc may evict registry leaves, and the
        # prefix pages just looked up must not be among them.
        self.allocator.share(shared)
        try:
            fresh = self._alloc(n_needed - n_hit)
        except MemoryError:
            self.allocator.free(shared)
            raise
        pages = shared + fresh
        self._pages[slot] = pages
        self._future_pages[slot] = self._worst_case_pages(req) - n_needed
        self.block_tables[slot] = 0  # parked
        req.slot = slot
        req.admitting = True
        self.slots[slot] = req  # reserve: queued admissions skip this slot
        self.temps[slot] = 0.0
        self.adapter_ids[slot] = req.adapter
        self.pos[slot] = 0
        M = self.max_pages * page
        row_dt = self._row_dt or self.cache["k"].dtype
        if n_hit:
            idx = np.zeros(self.max_pages, np.int64)
            idx[:n_hit] = shared
            row = gather_pool_row(self.cache, self._dev(idx), row_dt)
        else:
            row = _row_cache(self.cache, M, self._row_dt)
        base = self.admit_chunk or 512
        self._in_admission = True
        try:
            logits0, start = None, n_hit * page
            while start < L:
                A = min(base, M - start)  # never past M
                clen = min(A, L - start)
                cids = np.zeros((1, A), np.int64)
                cids[0, :clen] = padded[0, start : start + clen]
                logits0, row = prefill_row_chunk(
                    eng.params, self._dev(cids), start, clen, row, eng.cos,
                    eng.sin, self.cfg, first_chunk=start == 0,
                    lora=self._adm_lora(req))
                start += clen
                if self.admit_chunk and start < L and any(
                        r is not None and not r.admitting for r in self.slots):
                    self.step()  # co-tenants advance between chunks
        finally:
            self._in_admission = False
        idx = np.zeros(self.max_pages, np.int64)
        idx[n_hit:n_needed] = fresh  # shared prefix pages are never rewritten
        self.cache = scatter_row_paged(row, self._dev(idx), self.cache)
        self.block_tables[slot, :n_needed] = pages
        req.admitting = False
        return logits0

    def _prefill_into(self, slot: int, req: Request):
        eng = self.engine
        padded, L = pad_prompt(np.asarray([req.prompt_ids], np.int64),
                               self.args)
        n_hit, shared = 0, []
        if self._registry is not None and L > self.page_size:
            # Cap the hit so that one suffix token at least remains:
            # admission runs a real forward for tok0's logits.
            n_hit, shared = self._registry.lookup(
                req.prompt_ids, max_pages=(L - 1) // self.page_size)
        if self.paged and (n_hit or (self.admit_chunk and L > self.admit_chunk)):
            logits0 = self._admit_row(slot, req, padded, L, n_hit, shared)
        elif self.paged:
            # Pages covering the prompt and tok0's upcoming write (L + 1 <=
            # max_seq_len, as submit validated); the worst-case tail stays
            # reserved as future pages.
            n_needed = min(-(-(L + 1) // self.page_size), self.max_pages)
            pages = self._alloc(n_needed)
            self._pages[slot] = pages
            self._future_pages[slot] = self._worst_case_pages(req) - n_needed
            self.block_tables[slot] = 0
            self.block_tables[slot, :n_needed] = pages
            idx = np.zeros(self.max_pages, np.int64)  # pad -> null page 0
            idx[:n_needed] = pages
            if self._own_block:  # the prompt itself: no bucket to fill
                logits0 = eng.prefill_paged(self._dev(padded[:, :L]), self._dev(idx),
                                            self.cache)
            else:
                logits0, self.cache = admission_prefill_paged(
                    eng.params, self._dev(padded), L, self._dev(idx), self.cache,
                    eng.cos, eng.sin, self.cfg, self._row_dt, lora=self._adm_lora(req))
        else:
            logits0, self.cache = admission_prefill_dense(
                eng.params, self._dev(padded), L, slot, self.cache, eng.cos,
                eng.sin, self.cfg, self._row_dt, lora=self._adm_lora(req))
        if req.temperature > 0:  # token index 0 of the request's stream
            tok0 = self._sample_impl(
                logits0, np.asarray([req.request_id], np.int32),
                np.zeros(1, np.int32),
                np.asarray([req.temperature], np.float32))
        else:
            tok0 = torch.argmax(logits0, dim=-1)
        first = int(tok0[0])
        req.slot = slot
        self.slots[slot] = req
        self.temps[slot] = req.temperature
        self.adapter_ids[slot] = req.adapter
        self.rids[slot] = req.request_id
        self.sample_ctr[slot] = 1  # tok0 took token index 0
        req.generated.append(first)
        if req.logprobs is not None:
            l1, i1, v1 = token_logprobs(logits0, tok0, self.logprobs_k)
            req._record_logprob(float(l1[0]), i1[0].tolist(), v1[0].tolist())
        self.tokens[slot] = first
        self.pos[slot] = L  # `first`'s own position; written by the next step
        if self._registry is not None:
            # Cache the prompt's full pages for later admissions (entries
            # already registered are recognized and skipped).
            self._registry.register(req.prompt_ids, self._pages[slot],
                                    self.allocator)
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
                (pid,) = self._alloc(1)  # covered by the admission reservation
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
        if self._own_block and quantum != 1:
            raise ValueError(f"{type(self.engine).__name__} decodes one token a "
                             f"step; quantum {quantum} > 1 is not built for it")
        bt = None
        if self.paged:
            self._ensure_pages(quantum)
            bt = self._dev(self.block_tables)
        eng = self.engine
        tokens, pos = self._dev(self.tokens), self._dev(self.pos)
        bank = {}
        if self.lora_bank is not None:
            bank = {"lora": self._bank_view, "adapter_ids": self._dev(self.adapter_ids)}
        sampled = self._sampling_active()
        lp = None  # (chosen_lp [B, q], top_ids [B, q, K], top_lps [B, q, K])
        if quantum == 1:
            if self._own_block:
                # The pages in use: every row's position falls in the first n.
                n = min(int(self.pos.max()) // self.page_size + 1, self.max_pages)
                logits = eng.decode_paged(tokens, pos, self.cache, bt[:, :n])
            else:
                logits, self.cache = forward_ragged_decode(
                    eng.params, tokens, pos, self.cache, eng.cos, eng.sin,
                    self.cfg, block_table=bt, **bank)
            if sampled:
                nxt = self._sample_impl(logits, self.rids, self.sample_ctr,
                                        self.temps)
            else:
                nxt = torch.argmax(logits, dim=-1)
            toks = nxt[:, None]
            if self.logprobs_k is not None:
                lp = tuple(x[:, None] for x in
                           token_logprobs(logits, nxt, self.logprobs_k))
        else:
            if sampled:
                keys = fold_row_keys(self._base_key, self.rids[:, None],
                                     self.sample_ctr[:, None] + np.arange(quantum))
                out = sampled_ragged_decode_steps(
                    eng.params, tokens, pos, self.cache, eng.cos, eng.sin,
                    self._dev(keys), self._dev(self.temps), self.cfg, quantum,
                    self.top_k, self.top_p, block_table=bt,
                    num_logprobs=self.logprobs_k, **bank)
            else:
                out = ragged_decode_steps(
                    eng.params, tokens, pos, self.cache, eng.cos, eng.sin,
                    self.cfg, quantum, block_table=bt,
                    num_logprobs=self.logprobs_k, **bank)
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
            else:
                # The next token index of the request's sampled stream.
                self.sample_ctr[slot] = len(req.generated)
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
        self.temps[req.slot] = 0.0
        self.adapter_ids[req.slot] = 0  # no adapter leaks into the next request
        # An idle row still flows through each step: at position 0 its
        # paged attention reads one null page, not its old length.
        self.pos[req.slot] = 0
        if self.paged:
            if self._registry is not None:
                # Cache the conversation (prompt + generated) for a
                # follow-up turn.  The last generated token's K/V was never
                # written (it was not fed back), so only the first L+G-1
                # positions are valid.
                n_valid = len(req.prompt_ids) + len(req.generated) - 1
                self._registry.register(req.text_ids[:n_valid],
                                        self._pages[req.slot], self.allocator)
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

    @property
    def prefix_stats(self) -> Optional[dict]:
        """Prefix-cache counters (None when prefix_cache is off)."""
        return None if self._registry is None else self._registry.stats()

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.num_active == 0 and not self._queue:
                return
            self.step()
        raise RuntimeError("run_to_completion exceeded max_steps")
