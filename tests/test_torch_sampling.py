"""Sampling in the port against the JAX package (CPU).

The port replays `jax.random`'s threefry key schedule (`prng`), so its
sampled tokens are the JAX package's for the same seed: keys bit-equal,
Gumbel noise within an ulp of `log` (1e-6), and the same tokens from
`sample_token` / `sample_rows`, from `Llama.generate` and from the
serving engine (streams equal, logprobs within rtol 2e-4 / atol 1e-4).
bf16 streams may part only at a near-tie of the perturbed logits.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.generate import Sampling as JSampling
from llama3np_tpu.generate import plan_decode_segments as j_plan_decode_segments
from llama3np_tpu.generate import sample_token as j_sample_token
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.models.llama import fold_row_keys as j_fold_row_keys
from llama3np_tpu.models.llama import sample_rows as j_sample_rows
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import preset, prng
from llama3np_tpu_torch.generate import (Sampling, decode_keys,
                                         plan_decode_segments, sample_scores,
                                         sample_token)
from llama3np_tpu_torch.models.llama import Llama, fold_row_keys, sample_rows
from llama3np_tpu_torch.observability import timed_generate
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)
TINY = float(np.finfo(np.float32).tiny)


def tkey(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


# ---------------------------------------------------------------------------
# the key schedule and the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 123456789])
def test_keys_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    assert torch.equal(tk, tkey(k))
    for d in (0, 1, 7, 65535, 2**31 + 3):
        assert torch.equal(prng.fold_in(tk, d), tkey(jax.random.fold_in(k, d)))
    for n in (2, 3, 8):
        assert torch.equal(prng.split(tk, n), tkey(jax.random.split(k, n)))
    # a key two folds and a split deep
    deep = jax.random.split(jax.random.fold_in(jax.random.fold_in(k, 5), 9))[1]
    assert torch.equal(prng.split(prng.fold_in(prng.fold_in(tk, 5), 9))[1], tkey(deep))


def test_batched_fold_in_and_row_keys_bit_equal():
    k = jax.random.PRNGKey(3)
    rids = np.array([0, 1, 17, 400, 9], np.int32)
    ctrs = np.array([0, 5, 2, 31, 1], np.int32)
    want = jax.vmap(lambda d: jax.random.fold_in(k, d))(rids)
    assert torch.equal(prng.fold_in(prng.prng_key(3), torch.tensor(rids)), tkey(want))
    got = fold_row_keys(prng.prng_key(3), rids, ctrs)  # on the host
    assert torch.equal(torch.as_tensor(got), tkey(j_fold_row_keys(k, rids, ctrs)))
    # a quantum's keys in one call: [B, q, 2], step s = ctrs + s
    q = fold_row_keys(prng.prng_key(3), rids[:, None], ctrs[:, None] + np.arange(3))
    for s in range(3):
        assert torch.equal(torch.as_tensor(q[:, s]), tkey(j_fold_row_keys(k, rids, ctrs + s)))


@pytest.mark.parametrize("shape", [(1000,), (3, 257), (2, 2, 5)])
def test_uniform_and_gumbel_match_jax(shape):
    k = jax.random.PRNGKey(11)
    tk = prng.prng_key(11)
    bits = jax.random.bits(k, shape, jnp.uint32)
    assert torch.equal(prng.random_bits(tk, shape), tkey(bits))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        prng.uniform(tk, shape, TINY).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=TINY)))
    np.testing.assert_allclose(prng.gumbel(tk, shape).numpy(),
                               np.asarray(jax.random.gumbel(k, shape)),
                               rtol=0, atol=1e-6)


def test_categorical_equal(rng):
    logits = (rng.standard_normal((4, 700)) * 2).astype(np.float32)
    for seed in range(20):
        k = jax.random.PRNGKey(seed)
        got = prng.categorical(prng.prng_key(seed), torch.tensor(logits))
        assert got.tolist() == np.asarray(jax.random.categorical(k, logits)).tolist()
        ks = jax.random.split(k, 4)
        rows = prng.categorical(tkey(ks), torch.tensor(logits))
        want = jax.vmap(jax.random.categorical)(ks, logits)
        assert rows.tolist() == np.asarray(want).tolist()


POLICIES = [dict(temperature=0.8), dict(temperature=1.3, top_k=5),
            dict(temperature=0.7, top_k=1), dict(temperature=0.9, top_p=0.9),
            dict(temperature=1.0, top_p=0.3), dict(temperature=0.6, top_k=40, top_p=0.8),
            dict(temperature=5.0, top_p=0.05)]


@pytest.mark.parametrize("pol", POLICIES)
def test_sample_token_equal(pol, rng):
    for seed in range(12):
        logits = (rng.standard_normal((2, 512)) * 3).astype(np.float32)
        want = j_sample_token(jnp.asarray(logits), jax.random.PRNGKey(seed),
                              JSampling(**pol))
        got = sample_token(torch.tensor(logits), prng.prng_key(seed), Sampling(**pol))
        assert got.tolist() == np.asarray(want).tolist(), seed


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (7, 1.0), (0, 0.85), (20, 0.6)])
def test_sample_rows_equal_with_greedy_rows(top_k, top_p, rng):
    """Mixed per-row temperatures, 0 rows greedy."""
    temps = np.array([0.0, 0.7, 1.0, 0.0, 1.6], np.float32)
    rids = np.array([4, 9, 0, 2, 31], np.int32)
    for step in range(8):
        logits = (rng.standard_normal((5, 384)) * 2.5).astype(np.float32)
        ctrs = np.full(5, step, np.int32)
        k = jax.random.PRNGKey(step)
        want = j_sample_rows(jnp.asarray(logits), j_fold_row_keys(k, rids, ctrs),
                             jnp.asarray(temps), top_k, top_p)
        keys = torch.as_tensor(fold_row_keys(prng.prng_key(step), rids, ctrs))
        got = sample_rows(torch.tensor(logits), keys, torch.tensor(temps), top_k, top_p)
        assert got.tolist() == np.asarray(want).tolist()
        assert got[[0, 3]].tolist() == np.argmax(logits[[0, 3]], -1).tolist()


@pytest.mark.parametrize("rest,L,M", [(530, 10, 1024), (1, 3, 64), (40, 20, 64),
                                      (1008, 3, 2048), (700, 300, 1024)])
def test_plan_decode_segments_equal(rest, L, M):
    assert plan_decode_segments(rest, L, M) == j_plan_decode_segments(rest, L, M)


def test_decode_keys_replay_the_segments():
    """Key 0 from the split of PRNGKey(seed), then per segment of
    plan_decode_segments a fold_in and a split a step (530 -> [512, 16,
    16], the last segment run 2 steps)."""
    s = Sampling(temperature=1.0, seed=7)
    keys = decode_keys(s, 530, 10, 1024)
    assert keys.shape == (531, 2)
    rng, first = jax.random.split(jax.random.PRNGKey(7))
    assert torch.equal(keys[0], tkey(first))
    at = 1
    for seg, steps in enumerate((512, 16, 2)):
        k = jax.random.fold_in(rng, seg)
        for j in range(steps):
            k, sub = jax.random.split(k)
            if j in (0, steps - 1):
                assert torch.equal(keys[at + j], tkey(sub)), (seg, j)
        at += steps


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

GEN_POLICIES = [dict(temperature=0.8, top_p=0.9, seed=0), dict(temperature=1.0, seed=3),
                dict(temperature=0.7, top_k=20, seed=5)]


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
@pytest.mark.parametrize("pol", GEN_POLICIES)
def test_generate_same_stream_as_jax(name, pol, rng):
    args = jpreset(name)
    w = jsynth(args, seed=9)
    jeng, teng = JLlama(w, args), Llama(w, preset(name), device="cpu")
    ids = rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32)
    n = args.max_seq_len - 6  # the longest run: two or more decode segments
    for count in (1, 9, n):
        want = np.asarray(jeng.generate_tokens(ids, count, sampling=JSampling(**pol)))
        got = teng.generate_tokens(ids, count, sampling=Sampling(**pol))
        assert got[0].tolist() == want[0].tolist(), count
    # Llama.generate: max_new_tokens bounds the total length (quirk Q2)
    steps = [int(t[0, 0]) for t in teng.generate(ids, 5 + 12, sampling=Sampling(**pol))]
    assert steps == np.asarray(jeng.generate_tokens(ids, 12, sampling=JSampling(**pol)))[0].tolist()
    # timed_generate draws the same tokens
    toks, stats = timed_generate(teng, ids, 12, sampling=Sampling(**pol))
    assert toks[0].tolist() == steps and stats.generated_tokens == 12


def test_generate_batch_rows_share_one_key(rng):
    """B > 1 under one key: the noise spans [B, VS] (JAX's sample_token)."""
    args = jpreset("test-tiny")
    w = jsynth(args, seed=9)
    ids = rng.integers(3, args.vocab_size, size=(3, 4)).astype(np.int32)
    pol = dict(temperature=0.9, seed=11)
    want = np.asarray(JLlama(w, args).generate_tokens(ids, 10, sampling=JSampling(**pol)))
    got = Llama(w, preset("test-tiny"), device="cpu").generate_tokens(
        ids, 10, sampling=Sampling(**pol))
    assert got.tolist() == want.tolist()


def test_temperature_zero_is_greedy_bit_for_bit(rng):
    args = jpreset("test-tiny")
    teng = Llama(jsynth(args, seed=9), preset("test-tiny"), device="cpu")
    ids = rng.integers(3, args.vocab_size, size=(1, 4)).astype(np.int32)
    greedy = teng.generate_tokens(ids, 12)
    assert torch.equal(teng.generate_tokens(ids, 12, sampling=Sampling(temperature=0.0, seed=3)),
                       greedy)
    k1 = teng.generate_tokens(ids, 12, sampling=Sampling(temperature=0.7, top_k=1, seed=5))
    assert torch.equal(k1, greedy)


def test_cli_sampled_text_matches_jax_cli(tmp_path, capsys):
    from llama3np_tpu.cli import main as jax_main
    from llama3np_tpu_torch.cli import main as port_main
    from test_torch_host import _strip_times, write_vocab

    vocab = write_vocab(tmp_path / "vocab.json", 512)
    argv = ["--synthetic", "--preset", "test-tiny", "--tokenizer", vocab,
            "--max-new-tokens", "12", "--temperature", "0.9", "--top-p", "0.95",
            "--seed", "4", "--stats-json", "abc dd eee"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert _strip_times("\n".join(got[:-1])) == _strip_times("\n".join(want[:-1]))
    assert json.loads(got[-1])["generated_tokens"] == 12


def test_bf16_sampled_stream_near_tie_rule(rng):
    """bf16: the port's and the JAX engine's logits differ by bf16
    rounding, so a sampled stream may part only where the top two
    perturbed logits (logits / T, masked, plus the Gumbel noise) are closer
    than twice the logits' max-abs difference over T."""
    args = jpreset("test-tiny", dtype="bfloat16")
    w = jsynth(args, seed=23)
    jeng = JLlama(w, args)
    teng = Llama(w, preset("test-tiny", dtype="bfloat16"), device="cpu")
    pol = dict(temperature=0.8, top_p=0.9, seed=0)
    for trial in range(3):
        ids = rng.integers(3, args.vocab_size, size=(1, 6)).astype(np.int32)
        n = 24
        want = np.asarray(jeng.generate_tokens(ids, n, sampling=JSampling(**pol)))[0].tolist()
        got = teng.generate_tokens(ids, n, sampling=Sampling(**pol))[0].tolist()
        d_logits = np.abs(teng(ids, 0) - np.asarray(jeng(ids, 0))).max()
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if i is None:
            continue
        keys = decode_keys(Sampling(**pol), n - 1, ids.shape[1], args.max_seq_len)
        ctx = np.array([ids[0].tolist() + want[:i]], np.int32)
        logits = torch.tensor(np.asarray(jeng(ctx, 0))[:, -1], dtype=torch.float32)
        top2 = sample_scores(logits, keys[i], Sampling(**pol))[0].topk(2).values
        assert float(top2[0] - top2[1]) < 2 * d_logits / pol["temperature"], (trial, i)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_engines():
    w = jsynth(jpreset("test-tiny"), seed=23)
    return JLlama(w, jpreset("test-tiny")), Llama(w, preset("test-tiny"), device="cpu")


def sampled_traffic(BE, eng, quantum, paged, **kw):
    """Mixed greedy and sampled requests, staggered, with logprobs."""
    rng = np.random.default_rng(5)
    work = [(rng.integers(3, 512, size=n).tolist(), b, t)
            for n, b, t in ((4, 10, 0.8), (9, 7, 0.0), (6, 12, 1.2), (12, 9, 0.0),
                            (3, 8, 0.5), (7, 6, 1.0))]
    be = BE(eng, capacity=3, paged=paged, page_size=8, logprobs=3,
            sampling_seed=kw.get("seed", 0), top_k=kw.get("top_k", 0),
            top_p=kw.get("top_p", 1.0))
    reqs = [be.submit(p, b, stop_ids=(), temperature=t, logprobs=2)
            for p, b, t in work[:3]]
    be.step(quantum)
    reqs += [be.submit(p, b, stop_ids=(), temperature=t, logprobs=2)
             for p, b, t in work[3:]]
    for _ in range(60):
        if be.num_active == 0 and not be._queue:
            break
        be.step(quantum)
    return reqs


@pytest.mark.parametrize("quantum,paged,kw", [
    (1, True, {}), (3, True, {}), (1, False, dict(seed=9, top_p=0.9)),
    (3, True, dict(seed=2, top_k=10))])
def test_sampled_serving_equals_jax(serve_engines, quantum, paged, kw):
    jeng, teng = serve_engines
    got = sampled_traffic(BatchEngine, teng, quantum, paged, **kw)
    want = sampled_traffic(JBatchEngine, jeng, quantum, paged, **kw)
    for g, w in zip(got, want):
        assert g.done and w.done
        assert g.generated == w.generated, g.request_id
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, rtol=2e-4, atol=1e-4)
        assert [[i for i, _ in t] for t in g.top_logprobs] == \
            [[i for i, _ in t] for t in w.top_logprobs]


def test_sampled_stream_independent_of_schedule(serve_engines):
    """A sampled request's stream is the same at quanta 1 and 3 and alone
    (token j of request r under fold_in(fold_in(base, r), j))."""
    _, teng = serve_engines
    q1 = sampled_traffic(BatchEngine, teng, 1, True)
    q3 = sampled_traffic(BatchEngine, teng, 3, True)
    assert [r.generated for r in q1] == [r.generated for r in q3]
