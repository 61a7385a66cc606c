"""The port's perplexity harness against the JAX package's (CPU).

The same engine weights (numpy, from a seed) and the same sequences go
through `llama3np_tpu.eval.Scorer` and `llama3np_tpu_torch.eval.Scorer`,
and both against the NumPy oracle forwarding each prefix from scratch:
per-sequence NLL and counts, padding and batching invariance, the
vocab-axis chunking, aggregation, the int8 perplexity envelope, and the
command line against the JAX one.  float32: rtol 2e-4 / atol 1e-4.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu.eval import Scorer as JScorer
from llama3np_tpu.eval import main as jmain
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu_torch import NumpyLlama, build_param_tree
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.eval import Scorer, main
from llama3np_tpu_torch.models.llama import Llama

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 1e-4


@pytest.fixture(scope="module", params=["test-tiny", "test-tiny-mha"])
def engines(request):
    name = request.param
    w = synthetic_weights(jpreset(name), seed=0)
    return name, w, JLlama(w, jpreset(name)), Llama(w, tpreset(name), device="cpu")


def seqs_for(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [[1] + rng.integers(3, vocab, size=n).tolist() for n in lens]


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def test_scores_match_jax_and_oracle(engines):
    """lp[t] is log P(ids[t+1] | ids[:t+1]) as the JAX Scorer computes it,
    and as the oracle computes it forwarding each prefix from scratch."""
    name, w, jeng, teng = engines
    args = tpreset(name)
    seqs = [[1, 17, 98, 45, 7, 200, 12]] + seqs_for(args.vocab_size, 5, (3, 9, 20))
    nll, cnt = Scorer(teng, batch_size=2).score(seqs)
    jnll, jcnt = JScorer(jeng, batch_size=2).score(seqs)
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_allclose(nll, jnll, rtol=RTOL, atol=ATOL)
    oracle = NumpyLlama(build_param_tree(w, args), args)
    seq = seqs[0]
    want = 0.0
    for t in range(len(seq) - 1):
        oracle.reset_cache()
        logits = np.asarray(oracle(np.asarray([seq[: t + 1]]), 0), np.float64)
        want -= _log_softmax(logits.reshape(-1, logits.shape[-1])[-1])[seq[t + 1]]
    assert cnt[0] == len(seq) - 1
    np.testing.assert_allclose(nll[0], want, rtol=RTOL, atol=ATOL)


def test_padding_and_batching_invariance(engines):
    """A sequence's score does not depend on its co-batched neighbours,
    the bucket padding after it, or the tail batch's row copies."""
    name, _, _, teng = engines
    seqs = seqs_for(tpreset(name).vocab_size, 5, (4, 9, 21, 30, 2))
    nll1, cnt1 = Scorer(teng, batch_size=1).score(seqs)
    nll4, cnt4 = Scorer(teng, batch_size=4).score(seqs)  # a padded tail batch
    np.testing.assert_array_equal(cnt1, cnt4)
    np.testing.assert_allclose(nll1, nll4, rtol=1e-5, atol=1e-5)


def test_vocab_chunks_give_the_same_numbers(engines, monkeypatch):
    """The vocab axis reduced a few positions at a time (3 positions a
    chunk here) gives each position's numbers of the whole reduction."""
    from llama3np_tpu_torch import eval as teval
    name, _, _, teng = engines
    seqs = seqs_for(tpreset(name).vocab_size, 8, (6, 13, 25))
    whole = Scorer(teng, batch_size=3).score(seqs)
    monkeypatch.setattr(teval, "CHUNK_BYTES", 3 * 4 * tpreset(name).vocab_size)
    chunked = Scorer(teng, batch_size=3).score(seqs)
    np.testing.assert_array_equal(chunked[1], whole[1])
    np.testing.assert_allclose(chunked[0], whole[0], rtol=1e-6, atol=1e-6)


def test_buckets(engines):
    name, _, _, teng = engines
    sc = Scorer(teng, max_len=24)
    assert [sc._bucket(n) for n in (1, 8, 9, 16, 17, 40)] == [8, 8, 16, 16, 24, 24]
    assert Scorer(teng).max_len == tpreset(name).max_seq_len


def test_perplexity_aggregation(engines):
    name, _, jeng, teng = engines
    seqs = [[1, 5, 9, 13], [1, 40, 80]]
    sc = Scorer(teng)
    nll, cnt = sc.score(seqs)
    out = sc.perplexity(seqs)
    assert out["tokens"] == int(cnt.sum()) == 5 and out["sequences"] == 2
    np.testing.assert_allclose(out["ppl"], np.exp(nll.sum() / cnt.sum()), rtol=1e-6)
    want = JScorer(jeng).perplexity(seqs)
    assert sorted(out) == sorted(want)
    for k in ("nll_per_token", "ppl"):
        np.testing.assert_allclose(out[k], want[k], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="no scorable"):
        sc.perplexity([[7]])


def test_int8_ppl_envelope(engines):
    """The int8 engine scores within 0.05 nats a token of the float32
    engine (tests/test_eval.py's envelope), and as the JAX int8 engine."""
    name, w, _, teng = engines
    q = Llama(w, tpreset(name, quant="int8"), device="cpu")
    seqs = seqs_for(tpreset(name).vocab_size, 9, (24,) * 4)
    base = Scorer(teng).perplexity(seqs)
    quant = Scorer(q).perplexity(seqs)
    assert abs(quant["nll_per_token"] - base["nll_per_token"]) < 0.05, (base, quant)
    jquant = JScorer(JLlama(w, jpreset(name, quant="int8"))).perplexity(seqs)
    np.testing.assert_allclose(quant["nll_per_token"], jquant["nll_per_token"],
                               rtol=RTOL, atol=ATOL)


def write_vocab(path, size, seed=3):
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    seen = set(tokens)
    while len(tokens) < size:
        piece = "".join(rng.choice(list("abcdefghij "), size=int(rng.integers(2, 5))))
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
    scores = [0.0, 0.0, 0.0] + np.round(-rng.random(size - 3) * 10, 3).tolist()
    path.write_text(json.dumps({"tokens": tokens, "scores": scores}))
    return str(path)


def test_cli_matches_jax_cli(tmp_path, capsys):
    """`python -m llama3np_tpu_torch.eval FILE --synthetic --device cpu`
    prints the JAX command line's JSON (the same counts; nll and ppl
    within the float32 tolerance)."""
    vocab = write_vocab(tmp_path / "vocab.json", 512)
    docs = tmp_path / "docs.txt"
    docs.write_text("I have a dream\n\nthe quick brown fox\nabc abc abc\n")
    argv = [str(docs), "--preset", "test-tiny", "--synthetic", "--tokenizer", vocab,
            "--batch-size", "2"]
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = subprocess.run([sys.executable, "-m", "llama3np_tpu_torch.eval", *argv,
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert (got["tokens"], got["sequences"]) == (want["tokens"], want["sequences"]) \
        and got["sequences"] == 3
    for k in ("nll_per_token", "ppl"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = tmp_path / "docs.txt"
    docs.write_text("abc\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(docs), "--preset", "test-tiny", "--synthetic",
              "--tokenizer", write_vocab(tmp_path / "v.json", 512)])
