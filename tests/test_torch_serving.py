"""The port's continuous-batching engine against the JAX `BatchEngine` and
against the port's own solo streams (CPU).

Every scenario of tests/test_serving.py that the port serves (greedy,
dense and paged, quanta, chunked admission, backpressure) is driven the
same way through both engines on the same weights: the served greedy
streams must be equal, and equal to each prompt's solo stream.  Logprobs
agree at rtol 2e-4 / atol 1e-4 with identical top ids.
"""

import numpy as np
import pytest
import torch

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    w = jsynth(jpreset("test-tiny"), seed=23)
    return (tpreset("test-tiny"), JLlama(w, jpreset("test-tiny")),
            Llama(w, tpreset("test-tiny"), device="cpu"))


def solo_stream(engine, prompt, n, stop_ids=(1, 2)):
    toks = engine.generate_tokens(np.array([prompt], np.int32), n)[0].tolist()
    out = []
    for t in toks:
        if t in stop_ids:
            break
        out.append(t)
    return out


def drain(be, quantum=1, limit=60):
    for _ in range(limit):
        if be.num_active == 0 and not be._queue:
            return
        be.step(quantum)
    raise AssertionError("engine did not drain")


def both(setup, scenario):
    """Run `scenario(BatchEngineClass, engine)` with both packages; returns
    the port's result after asserting it equals the JAX one."""
    _, jeng, teng = setup
    got = scenario(BatchEngine, teng)
    assert got == scenario(JBatchEngine, jeng)
    return got


def prompts(rng, *lens, vocab=512):
    return [rng.integers(3, vocab, size=n).tolist() for n in lens]


def test_single_request(setup, rng):
    args, _, teng = setup
    (p,) = prompts(rng, 6)

    def run(BE, eng):
        be = BE(eng, capacity=4)
        req = be.submit(p, max_new_tokens=10)
        be.run_to_completion()
        assert req.done
        return req.generated

    assert both(setup, run) == solo_stream(teng, p, 10)


def test_staggered_requests(setup, rng):
    _, _, teng = setup
    ps = prompts(rng, 4, 7, 5)

    def run(BE, eng):
        be = BE(eng, capacity=2)  # the third request must queue
        r0 = be.submit(ps[0], 8)
        be.step()
        be.step()
        r1 = be.submit(ps[1], 8)
        be.step()
        r2 = be.submit(ps[2], 8)
        be.run_to_completion()
        return [r.generated for r in (r0, r1, r2)]

    assert both(setup, run) == [solo_stream(teng, p, 8) for p in ps]


def test_slot_reuse_is_clean(setup, rng):
    _, _, teng = setup
    ps = prompts(rng, 5, 5)

    def run(BE, eng):
        be = BE(eng, capacity=1)
        r1 = be.submit(ps[0], 6)
        r2 = be.submit(ps[1], 6)  # queued until r1 finishes
        be.run_to_completion()
        return [r1.generated, r2.generated]

    assert both(setup, run) == [solo_stream(teng, p, 6) for p in ps]


@pytest.mark.parametrize("quantum,paged", [(4, False), (3, True)])
def test_quantum_steps(setup, rng, quantum, paged):
    _, _, teng = setup
    ps = prompts(rng, 4, 6, 5)

    def run(BE, eng):
        be = BE(eng, capacity=2, **(dict(paged=True, page_size=8) if paged else {}))
        r0 = be.submit(ps[0], 9)
        be.step(quantum)
        r1 = be.submit(ps[1], 9)
        be.step(quantum)
        r2 = be.submit(ps[2], 9)
        drain(be, quantum)
        return [r.generated for r in (r0, r1, r2)]

    assert both(setup, run) == [solo_stream(teng, p, 9) for p in ps]


def test_paged_matches_dense(setup, rng):
    _, _, teng = setup
    ps = prompts(rng, 4, 9)

    def run(BE, eng, paged):
        be = BE(eng, capacity=2, **(dict(paged=True, page_size=8) if paged else {}))
        r0 = be.submit(ps[0], 10)
        be.step()
        r1 = be.submit(ps[1], 10)
        be.run_to_completion()
        return [r0.generated, r1.generated]

    paged = both(setup, lambda BE, eng: run(BE, eng, True))
    assert paged == run(BatchEngine, teng, False)
    assert paged == [solo_stream(teng, p, 10) for p in ps]


@pytest.mark.parametrize("kind", ["reuse", "backpressure"])
def test_paged_tight_pool(setup, rng, kind):
    """A pool that fits one active sequence: pages are recycled; with two
    slots the second admission defers until pages free (worst-case
    reservation), and every page returns."""
    _, _, teng = setup
    ps = prompts(rng, 6, 6)

    def run(BE, eng):
        be = BE(eng, capacity=1 if kind == "reuse" else 2, paged=True,
                page_size=8, num_pages=4)
        r1 = be.submit(ps[0], 8)
        r2 = be.submit(ps[1], 8)
        assert be.num_active == 1 and len(be._queue) == 1
        be.run_to_completion()
        assert be.allocator.available == 3  # all pages returned
        return [r1.generated, r2.generated]

    assert both(setup, run) == [solo_stream(teng, p, 8) for p in ps]


def test_paged_pool_exhaustion(setup, rng):
    _, jeng, teng = setup
    (p,) = prompts(rng, 20)
    for BE, eng in ((JBatchEngine, jeng), (BatchEngine, teng)):
        be = BE(eng, capacity=2, paged=True, page_size=8, num_pages=2)
        with pytest.raises(MemoryError):
            be.submit(p, 8)


def test_max_seq_len_guard_and_submit_validation(setup, rng):
    args, jeng, teng = setup
    too_long = list(range(3, 3 + args.max_seq_len))
    for BE, eng in ((JBatchEngine, jeng), (BatchEngine, teng)):
        be = BE(eng, capacity=1)
        ok = be.submit(prompts(rng, 4)[0], 6)
        with pytest.raises(ValueError):  # while the only slot is busy
            be.submit(too_long, 10)
        with pytest.raises(ValueError):
            be.submit([5, 6], 0)
        be.run_to_completion()
        assert ok.done and len(ok.generated) == 6


def test_chunked_admission_stream_identity(setup, rng):
    (p,) = prompts(rng, 40)

    def run(BE, eng):
        plain = BE(eng, capacity=2, paged=True)
        r_plain = plain.submit(p, 6)
        plain.run_to_completion()
        chunked = BE(eng, capacity=2, paged=True, admit_chunk=16)
        r_chunked = chunked.submit(p, 6)
        chunked.run_to_completion()
        assert r_chunked.done and r_chunked.generated == r_plain.generated
        return r_chunked.generated

    both(setup, run)


def test_chunked_admission_co_tenants_progress(setup, rng):
    _, _, teng = setup
    short, long_p = prompts(rng, 4, 40)

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=True, admit_chunk=16)
        r_short = be.submit(short, 12)
        be.step()
        n_before = len(r_short.generated)
        r_long = be.submit(long_p, 4)  # 3 chunks, 2 interleaved steps
        assert len(r_short.generated) == n_before + 2
        be.run_to_completion()
        assert be.allocator.available == be.allocator.num_pages - 1
        return [r_short.generated, r_long.generated]

    got = both(setup, run)
    assert got[0] == solo_stream(teng, short, 12)
    assert got[1] == solo_stream(teng, long_p, 4)


def test_admit_chunk_validation(setup):
    _, _, teng = setup
    with pytest.raises(ValueError, match="requires paged"):
        BatchEngine(teng, paged=False, admit_chunk=16)
    with pytest.raises(ValueError, match="divide max_seq_len"):
        BatchEngine(teng, paged=True, admit_chunk=24)


def test_cancel_frees_slot_and_pages(setup, rng):
    _, _, teng = setup
    ps = prompts(rng, 5, 6, 4)
    be = BatchEngine(teng, capacity=1, paged=True, page_size=8)
    r0 = be.submit(ps[0], 20)
    r1 = be.submit(ps[1], 5)
    r2 = be.submit(ps[2], 5)
    be.step()
    assert be.cancel(r2) and r2.done  # queued
    assert be.cancel(r0) and r0.done  # active: r1 takes the slot
    assert not be.cancel(r0)
    be.run_to_completion()
    assert r1.generated == solo_stream(teng, ps[1], 5)
    assert be.allocator.available == be.allocator.num_pages - 1


def test_card_path_with_cpu_tensors(setup, rng):
    """The kernel path (`cfg.kernels`: flash prefill and the paged-attention
    wrapper) with CPU tensors runs the wrappers' plain versions and serves
    the same streams, with no launch counted."""
    args, _, _ = setup
    w = jsynth(jpreset("test-tiny"), seed=23)
    eng = Llama(w, args, device="cpu")
    plain = eng.cfg
    ps = prompts(rng, 4, 9)

    def serve():
        be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
        r0 = be.submit(ps[0], 8)
        be.step(2)
        r1 = be.submit(ps[1], 8)
        drain(be, 2)
        return [r0.generated, r1.generated]

    want = serve()
    eng.cfg = plain._replace(kernels=True)
    before = paged_attention.launches
    assert serve() == want
    assert paged_attention.launches == before


# ---------------------------------------------------------------------------
# logprobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantum,paged", [(1, False), (4, False), (3, True)])
def test_greedy_logprobs_match_jax(setup, rng, quantum, paged):
    _, jeng, teng = setup
    (p,) = prompts(rng, 5)
    K = 3
    out = []
    for BE, eng in ((JBatchEngine, jeng), (BatchEngine, teng)):
        be = BE(eng, capacity=2, logprobs=K, **(dict(paged=True, page_size=8) if paged else {}))
        req = be.submit(p, max_new_tokens=8, stop_ids=(), logprobs=K)
        while not req.done:
            be.step(quantum=quantum)
        assert len(req.token_logprobs) == len(req.generated) == 8
        out.append(req)
    want, got = out
    assert got.generated == want.generated
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs,
                               rtol=2e-4, atol=1e-4)
    for g, w in zip(got.top_logprobs, want.top_logprobs):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   rtol=2e-4, atol=1e-4)
    assert all(top[0][0] == tok for top, tok in zip(got.top_logprobs, got.generated))


def test_logprobs_do_not_change_streams(setup, rng):
    _, _, teng = setup
    (p,) = prompts(rng, 6)
    plain = BatchEngine(teng, capacity=2)
    r0 = plain.submit(p, max_new_tokens=10, stop_ids=())
    plain.run_to_completion()
    lp = BatchEngine(teng, capacity=2, logprobs=2)
    r1 = lp.submit(p, max_new_tokens=10, stop_ids=(), logprobs=2)
    r2 = lp.submit(p, max_new_tokens=10, stop_ids=())  # did not opt in
    lp.run_to_completion()
    assert r1.generated == r0.generated == r2.generated
    assert r2.token_logprobs == [] and len(r1.token_logprobs) == 10


def test_stop_token_pops_logprob_entries(setup, rng):
    _, _, teng = setup
    (p,) = prompts(rng, 4)
    be = BatchEngine(teng, capacity=1, logprobs=1)
    probe = be.submit(p, max_new_tokens=6, stop_ids=(), logprobs=0)
    be.run_to_completion()
    stop = probe.generated[2]
    req = be.submit(p, max_new_tokens=6, stop_ids=(stop,), logprobs=0)
    be.run_to_completion()
    assert req.done and stop not in req.generated
    assert len(req.token_logprobs) == len(req.top_logprobs) == len(req.generated)


def test_logprobs_validation(setup):
    _, _, teng = setup
    with pytest.raises(ValueError, match="without logprobs"):
        BatchEngine(teng, capacity=1).submit([5, 6], 3, logprobs=1)
    with pytest.raises(ValueError, match=">= 1"):
        BatchEngine(teng, capacity=1, logprobs=0)
    with pytest.raises(ValueError, match="logprobs must be in"):
        BatchEngine(teng, capacity=1, logprobs=2).submit([5, 6], 3, logprobs=3)


# ---------------------------------------------------------------------------
# seeded soak and refusals
# ---------------------------------------------------------------------------

def test_seeded_soak(setup):
    """Random lengths, budgets, admission times and quanta 1-4 over a tight
    paged pool: every stream equals its solo stream, and no page leaks."""
    _, _, teng = setup
    rng = np.random.default_rng(1234)
    be = BatchEngine(teng, capacity=3, paged=True, page_size=8, num_pages=12)
    pending = [(prompts(rng, int(rng.integers(2, 12)))[0], int(rng.integers(2, 14)))
               for _ in range(14)]
    reqs, submitted = [], 0
    for _ in range(300):
        while submitted < len(pending) and rng.random() < 0.5:
            reqs.append(be.submit(*pending[submitted]))
            submitted += 1
        if be.num_active == 0 and not be._queue and submitted == len(pending):
            break
        be.step(int(rng.integers(1, 5)))
    else:
        raise AssertionError("soak did not drain")
    for req, (p, budget) in zip(reqs, pending):
        assert req.done and req.generated == solo_stream(teng, p, budget), req.request_id
    assert be.allocator.available == 11


@pytest.mark.parametrize("kw,item", [
    (dict(prefix_cache=True), "A2"), (dict(adapters=[{}]), "A7")])
def test_unported_engine_options_raise(setup, kw, item):
    _, _, teng = setup
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        BatchEngine(teng, paged=True, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_kv_quant_engine_option(setup, paged):
    """kv_quant="int8" builds an int8 cache with scales; any other value is
    refused as the JAX engine refuses it."""
    _, jeng, teng = setup
    be = BatchEngine(teng, capacity=2, paged=paged, kv_quant="int8")
    assert be.cache["k"].dtype == torch.int8
    assert be.cache["k_s"].dtype == torch.float32
    assert tuple(be.cache["k_s"].shape) == tuple(be.cache["k"].shape[:-1])
    for BE, eng in ((JBatchEngine, jeng), (BatchEngine, teng)):
        with pytest.raises(ValueError, match="unsupported kv_quant"):
            BE(eng, capacity=1, paged=paged, kv_quant="int4")


@pytest.mark.parametrize("kw,item", [(dict(temperature=0.7), "A1"),
                                     (dict(adapter=0), "A7")])
def test_unported_request_options_raise(setup, kw, item):
    _, _, teng = setup
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        BatchEngine(teng, capacity=1).submit([5, 6, 7], 4, **kw)


@pytest.mark.parametrize("quantum", [1, 2])
def test_mha_paged_serving_matches_jax(rng, quantum):
    """test-tiny-mha (MHA, HD=16, max_seq_len 32): a request runs into
    max_seq_len mid-quantum while another is admitted."""
    w = jsynth(jpreset("test-tiny-mha"), seed=11)
    jeng = JLlama(w, jpreset("test-tiny-mha"))
    teng = Llama(w, tpreset("test-tiny-mha"), device="cpu")
    ps = prompts(rng, 20, 5, vocab=256)

    def run(BE, eng):
        be = BE(eng, capacity=2, paged=True, page_size=8)
        r0 = be.submit(ps[0], 12)  # ends at max_seq_len
        be.step(quantum)
        r1 = be.submit(ps[1], 9)
        drain(be, quantum)
        assert be.allocator.available == be.allocator.num_pages - 1
        return [r0.generated, r1.generated]

    got = both((None, jeng, teng), run)
    assert got == [solo_stream(teng, p, n) for p, n in zip(ps, (12, 9))]
