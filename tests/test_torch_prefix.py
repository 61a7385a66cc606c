"""The port's prefix cache against the JAX package's (CPU).

The registry cases of tests/test_prefix.py run against the port's copy of
`PrefixRegistry` (and a seeded sequence of operations against both
copies), and every engine scenario of tests/test_prefix.py runs through
both `BatchEngine(paged=True, prefix_cache=True)`s on the same weights:
hit counts, page accounting and streams must be equal, and equal to the
solo streams where the JAX test holds them so.
"""

import numpy as np
import pytest
import torch

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.kvcache import PageAllocator as JPageAllocator
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.prefix import PrefixRegistry as JPrefixRegistry
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu.serving import gather_pool_row as j_gather_pool_row
from llama3np_tpu_torch import preset
from llama3np_tpu_torch.kvcache import PageAllocator
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.prefix import PrefixRegistry
from llama3np_tpu_torch.serving import BatchEngine, gather_pool_row

torch.set_num_threads(1)
PAGE = 8


# ---------------------------------------------------------------------------
# the registry (host code)
# ---------------------------------------------------------------------------

def test_registry_chain_lookup_and_register():
    alloc = PageAllocator(16)
    reg = PrefixRegistry(page_size=4)
    toks = list(range(100, 112))  # 3 full pages
    pages = alloc.alloc(3)
    assert reg.register(toks, pages, alloc) == 3
    assert all(alloc.refcount(p) == 2 for p in pages)
    assert reg.lookup(toks) == (3, pages)
    assert reg.lookup(toks[:8] + [7, 7, 7, 7]) == (2, pages[:2])
    assert reg.lookup(toks, max_pages=1) == (1, pages[:1])
    assert reg.lookup(toks[:7]) == (1, pages[:1])  # a partial page never matches
    dup = alloc.alloc(3)
    assert reg.register(toks, dup, alloc) == 0  # the same content: no entry
    assert all(alloc.refcount(p) == 1 for p in dup)


def test_registry_evicts_leaves_lru_only_when_unreferenced():
    alloc = PageAllocator(16)
    reg = PrefixRegistry(page_size=4)
    a = alloc.alloc(2)
    reg.register(list(range(8)), a, alloc)
    b = alloc.alloc(2)
    reg.register(list(range(50, 58)), b, alloc)
    alloc.free(a)
    alloc.free(b)
    assert reg.evictable_pages(alloc) == 4
    reg.lookup(list(range(8)))  # chain b is now the least recently used
    assert reg.evict(1, alloc) == 1
    assert reg.lookup(list(range(8)))[0] == 2
    assert reg.lookup(list(range(50, 58)))[0] == 1
    alloc.share([a[0], a[1]])  # a live block table holds chain a
    assert reg.evictable_pages(alloc) == 1
    assert reg.evict(10, alloc) == 1
    assert len(reg) == 2


def test_registry_parent_becomes_evictable_after_child():
    alloc = PageAllocator(16)
    reg = PrefixRegistry(page_size=4)
    pages = alloc.alloc(3)
    reg.register(list(range(12)), pages, alloc)
    alloc.free(pages)
    assert reg.evict(3, alloc) == 3
    assert len(reg) == 0 and alloc.available == 15
    reg.register(list(range(12)), alloc.alloc(3), alloc)
    reg.clear(alloc)
    assert len(reg) == 0 and alloc.available == 15 - 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_ops_equal_jax_copy(seed):
    """A seeded mix of register / lookup / evict / free / share on both
    copies gives the same results, stats and refcounts."""
    rng = np.random.default_rng(seed)
    ja, ta = JPageAllocator(40), PageAllocator(40)
    jr, tr = JPrefixRegistry(4), PrefixRegistry(4)
    held = []
    heads = [rng.integers(0, 6, size=12).tolist() for _ in range(3)]
    for _ in range(120):
        op = rng.integers(0, 5)
        toks = heads[rng.integers(0, 3)][: 4 * int(rng.integers(1, 4))] + \
            rng.integers(0, 3, size=int(rng.integers(0, 9))).tolist()
        if op == 0 and ta.available >= 5:
            n = len(toks) // 4
            jp, tp = ja.alloc(n), ta.alloc(n)
            assert jp == tp
            assert jr.register(toks, jp, ja) == tr.register(toks, tp, ta)
            held.append(tp)
        elif op == 1:
            cap = int(rng.integers(0, 4)) or None
            assert jr.lookup(toks, max_pages=cap) == tr.lookup(toks, max_pages=cap)
        elif op == 2:
            n = int(rng.integers(1, 4))
            assert jr.evict(n, ja) == tr.evict(n, ta)
        elif op == 3 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            ja.free(pages)
            ta.free(pages)
        else:
            assert jr.evictable_pages(ja) == tr.evictable_pages(ta)
        assert jr.stats() == tr.stats() and len(jr) == len(tr)
        assert ja.available == ta.available
        assert [ja.refcount(p) for p in range(40)] == [ta.refcount(p) for p in range(40)]


# ---------------------------------------------------------------------------
# gather_pool_row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_gather_pool_row_equals_jax(quant, rng):
    nl, n, kvh, hd, maxp = 2, 9, 2, 16, 4
    k = rng.standard_normal((nl, n, kvh, PAGE, hd)).astype(np.float32)
    v = rng.standard_normal((nl, n, kvh, PAGE, hd)).astype(np.float32)
    cache = {"k": k, "v": v}
    if quant:
        cache = {"k": rng.integers(-127, 128, size=k.shape).astype(np.int8),
                 "v": rng.integers(-127, 128, size=v.shape).astype(np.int8),
                 "k_s": rng.random(k.shape[:-1]).astype(np.float32),
                 "v_s": rng.random(v.shape[:-1]).astype(np.float32)}
    idx = np.array([3, 7, 0, 0], np.int32)
    want = j_gather_pool_row(cache, idx, np.float32)
    got = gather_pool_row({k: torch.tensor(a) for k, a in cache.items()},
                          torch.tensor(idx), torch.float32)
    for name in ("k", "v"):
        assert got[name].shape == (nl, 1, kvh, maxp * PAGE, hd)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    w = jsynth(jpreset("test-tiny"), seed=23)
    return (jpreset("test-tiny"), JLlama(w, jpreset("test-tiny")),
            Llama(w, preset("test-tiny"), device="cpu"))


def solo_stream(engine, prompt, n, stop_ids=(1, 2)):
    toks = np.asarray(engine.generate_tokens(np.array([prompt], np.int32), n))[0].tolist()
    out = []
    for t in toks:
        if t in stop_ids:
            break
        out.append(t)
    return out


def make(BE, eng, **kw):
    kw.setdefault("capacity", 2)
    kw.setdefault("page_size", PAGE)
    return BE(eng, paged=True, prefix_cache=True, **kw)


def both(setup, scenario):
    """Run `scenario(BatchEngine class, engine)` through both packages;
    its result (streams, stats, page counts) must be equal.  Returns the
    port's."""
    _, jeng, teng = setup
    got = scenario(BatchEngine, teng)
    assert got == scenario(JBatchEngine, jeng)
    return got


def accounting(be):
    return (be.prefix_stats, be.allocator.available, len(be._registry),
            [be.allocator.refcount(p) for p in range(be.allocator.num_pages)])


def test_prefix_requires_paged(setup):
    _, _, teng = setup
    with pytest.raises(ValueError, match="paged"):
        BatchEngine(teng, paged=False, prefix_cache=True)
    assert BatchEngine(teng, paged=True).prefix_stats is None


def test_identical_prompt(setup, rng):
    args, _, teng = setup
    prompt = rng.integers(3, args.vocab_size, size=3 * PAGE + 3).tolist()

    def run(BE, eng):
        be = make(BE, eng)
        r1 = be.submit(prompt, max_new_tokens=10, stop_ids=())
        be.run_to_completion()
        misses = be.prefix_stats["hits"]
        r2 = be.submit(prompt, max_new_tokens=10, stop_ids=())
        be.run_to_completion()
        return misses, r1.generated, r2.generated, accounting(be)

    misses, g1, g2, acc = both(setup, run)
    assert misses == 0 and acc[0]["hits"] == 1 and acc[0]["hit_tokens"] == 3 * PAGE
    assert g1 == g2 == solo_stream(teng, prompt, 10)


def test_partial_hit(setup, rng):
    args, _, teng = setup
    head = rng.integers(3, args.vocab_size, size=2 * PAGE).tolist()
    tails = [rng.integers(3, args.vocab_size, size=9).tolist() for _ in range(2)]

    def run(BE, eng):
        be = make(BE, eng)
        reqs = [be.submit(head + t, max_new_tokens=8, stop_ids=()) for t in tails]
        be.run_to_completion()
        return [r.generated for r in reqs], accounting(be)

    streams, acc = both(setup, run)
    assert acc[0]["hits"] == 1
    assert streams == [solo_stream(teng, head + t, 8) for t in tails]


def test_exact_page_multiple_prompt(setup, rng):
    """The hit is capped at (L - 1) // page: the last page recomputes."""
    args, _, teng = setup
    prompt = rng.integers(3, args.vocab_size, size=3 * PAGE).tolist()

    def run(BE, eng):
        be = make(BE, eng)
        r1 = be.submit(prompt, max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        r2 = be.submit(prompt, max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        return r1.generated, r2.generated, accounting(be)

    g1, g2, acc = both(setup, run)
    assert acc[0]["hit_tokens"] == 2 * PAGE
    assert g1 == g2 == solo_stream(teng, prompt, 6)


def test_multi_turn_continuation(setup, rng):
    args, _, teng = setup
    p1 = rng.integers(3, args.vocab_size, size=2 * PAGE + 2).tolist()
    more = rng.integers(3, args.vocab_size, size=5).tolist()

    def run(BE, eng):
        be = make(BE, eng)
        r1 = be.submit(p1, max_new_tokens=PAGE, stop_ids=())
        be.run_to_completion()
        p2 = p1 + r1.generated + more
        r2 = be.submit(p2, max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        return p2, r2.generated, accounting(be)

    p2, g2, acc = both(setup, run)
    assert acc[0]["hit_tokens"] >= ((len(p1) + PAGE - 1) // PAGE) * PAGE
    assert g2 == solo_stream(teng, p2, 6)


def test_shared_pages_never_rewritten(setup, rng):
    args, _, teng = setup
    prompt = rng.integers(3, args.vocab_size, size=3 * PAGE + 1).tolist()

    def run(BE, eng):
        be = make(BE, eng)
        be.submit(prompt, max_new_tokens=4, stop_ids=())
        be.run_to_completion()
        n_hit, pages = be._registry.lookup(prompt)
        before = [np.array(be.cache[n][:, pages]) for n in ("k", "v")]
        r = be.submit(prompt, max_new_tokens=4, stop_ids=())
        be.run_to_completion()
        for b, n in zip(before, ("k", "v")):
            np.testing.assert_array_equal(b, np.array(be.cache[n][:, pages]))
        return n_hit, pages, r.generated, accounting(be)

    n_hit, _, gen, _ = both(setup, run)
    assert n_hit == 3 and gen == solo_stream(teng, prompt, 4)


def test_eviction_under_pool_pressure(setup):
    args, _, teng = setup
    M = args.max_seq_len

    def run(BE, eng):
        rng = np.random.default_rng(7)
        be = make(BE, eng, capacity=1, num_pages=1 + M // PAGE + 2)
        out = []
        for i in range(4):
            prompt = rng.integers(3, args.vocab_size, size=2 * PAGE + i).tolist()
            r = be.submit(prompt, max_new_tokens=M - len(prompt), stop_ids=())
            be.run_to_completion()
            assert r.done
            out.append(r.generated)
        assert be.allocator.available + len(be._registry) == be.allocator.num_pages - 1
        return out, accounting(be)

    _, acc = both(setup, run)
    assert acc[0]["evictions"] > 0


def test_chunked_admission_with_cotenants(setup, rng):
    args, _, teng = setup
    head = rng.integers(3, args.vocab_size, size=2 * PAGE).tolist()
    tail = rng.integers(3, args.vocab_size, size=20).tolist()

    def run(BE, eng):
        be = make(BE, eng, admit_chunk=PAGE)
        r1 = be.submit(head + tail[:4], max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        r2 = be.submit(list(head), max_new_tokens=10, stop_ids=())
        r3 = be.submit(head + tail, max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        return [r.generated for r in (r1, r2, r3)], accounting(be)

    streams, acc = both(setup, run)
    assert streams == [solo_stream(teng, head + tail[:4], 6), solo_stream(teng, head, 10),
                       solo_stream(teng, head + tail, 6)]
    assert acc[0]["hits"] >= 2


@pytest.mark.parametrize("quantum", [1, 3])
def test_int8_pools_with_hits(setup, rng, quantum):
    """int8 pools: the gathered prefix is dequantized as the JAX engine
    dequantizes it; streams equal the JAX engine's, and repeat cached
    admissions are reproducible."""
    args, _, _ = setup
    prompt = rng.integers(3, args.vocab_size, size=3 * PAGE + 2).tolist()

    def run(BE, eng):
        be = make(BE, eng, kv_quant="int8")
        out = []
        for _ in range(3):
            r = be.submit(prompt, max_new_tokens=8, stop_ids=())
            while be.num_active or be._queue:
                be.step(quantum)
            out.append(r.generated)
        return out, accounting(be)

    streams, acc = both(setup, run)
    assert acc[0]["hits"] == 2 and streams[1] == streams[2]


def test_sampled_request_with_hit(setup, rng):
    """A sampled request through a prefix hit draws the same stream as the
    same request admitted cold (keys fold the request id and the token
    index), and the JAX engine's."""
    args, _, _ = setup
    prompt = rng.integers(3, args.vocab_size, size=2 * PAGE + 1).tolist()

    def run(BE, eng, prefix=True):
        be = BE(eng, capacity=2, paged=True, page_size=PAGE, prefix_cache=prefix,
                sampling_seed=5)
        be.submit(prompt, max_new_tokens=6, stop_ids=())
        be.run_to_completion()
        r2 = be.submit(prompt, max_new_tokens=6, stop_ids=(), temperature=0.8)
        be.run_to_completion()
        return r2.generated, be.prefix_stats

    gen, stats = both(setup, run)
    assert stats["hits"] >= 1
    _, _, teng = setup
    assert gen == run(BatchEngine, teng, prefix=False)[0]


def test_traffic_with_cotenant_hits_quantum(setup):
    """Several requests sharing a head, admitted while others decode, at
    quantum 3 with logprobs: streams, logprobs and accounting equal."""
    args, _, _ = setup

    def run(BE, eng):
        rng = np.random.default_rng(3)
        head = rng.integers(3, args.vocab_size, size=3 * PAGE).tolist()
        be = make(BE, eng, capacity=3, logprobs=2)
        reqs = [be.submit(head + rng.integers(3, 512, size=int(n)).tolist(), b,
                          stop_ids=(), logprobs=1)
                for n, b in ((3, 9), (5, 4))]
        be.step(3)
        reqs += [be.submit(head + rng.integers(3, 512, size=int(n)).tolist(), b,
                           stop_ids=(), logprobs=1)
                 for n, b in ((1, 7), (9, 5), (2, 6))]
        while be.num_active or be._queue:
            be.step(3)
        return [r.generated for r in reqs], accounting(be), reqs

    _, jeng, teng = setup
    streams, acc, got = run(BatchEngine, teng)
    j_streams, j_acc, want = run(JBatchEngine, jeng)
    assert (streams, acc) == (j_streams, j_acc) and acc[0]["hits"] >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, rtol=2e-4, atol=1e-4)
