"""The port's speculative decoding (`llama3np_tpu_torch.speculative`)
against the JAX package's, on the CPU.

Both packages get the same numpy weights.  The port's streams equal the
JAX target-only greedy streams token for token whatever the draft, and its
`last_stats` (tokens, rounds, accept_rate) equal the JAX
`SpeculativeGenerator`'s for the same engines and k: on the CPU the port's
draft runs the plain forward at L=1, as the JAX draft step does, so both
propose the same tokens.  The JAX int8 draft is built on the whole-layer
tree (`pallas_ffn_block=0`), whose codes and scales the port's
`quantize_param_tree` gives bit for bit.  `tests/test_speculative.py` is
slow-marked (one compile per loop shape), so each JAX generator here is
built once per module.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.speculative import SpeculativeGenerator as JSpec
from llama3np_tpu_torch import SpeculativeGenerator, quantized_draft
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.models.llama import Llama

torch.set_num_threads(1)

STATS = ("tokens", "rounds", "accept_rate")
WHOLE = dict(pallas_ffn_block=0)  # the JAX engine's whole-layer int8 tree


class Pair:
    """The JAX and port engines of one preset: target, int8 self-draft, an
    unrelated draft (other weights) and a perfect one (the target's own)."""

    def __init__(self, name, seed=7):
        self.name, self.args = name, tpreset(name)
        jargs = jpreset(name, attn_impl="xla")
        self.w = jsynth(jargs, seed)
        self.jt = JLlama(self.w, jargs)
        self.jd = JLlama(self.w, dataclasses.replace(jargs, quant="int8", **WHOLE))
        self.tt = Llama(self.w, self.args, device="cpu")
        self.td = quantized_draft(self.w, self.args, device="cpu")
        self._jspec = {}

    def jspec(self, k, draft="int8"):
        if (k, draft) not in self._jspec:
            d = {"int8": lambda: self.jd, "twin": lambda: self.jt,
                 "bad": lambda: JLlama(jsynth(self.jt.args, 99), self.jt.args)}[draft]()
            self._jspec[k, draft] = JSpec(self.jt, d, k=k)
        return self._jspec[k, draft]

    def jax_target_stream(self, ids, n):
        self.jt.reset()
        return np.asarray(self.jt.generate_tokens(ids, n)).tolist()


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(name) for name in ("test-tiny", "test-tiny-mha")}


def prompt(args, n, seed=0):
    return np.random.default_rng(seed).integers(3, args.vocab_size, size=(1, n))


def run_both(pair, ids, n, k, draft, tdraft):
    """(port tokens, port stats, JAX tokens, JAX stats) for one call."""
    spec = SpeculativeGenerator(pair.tt, tdraft, k=k)
    got = spec.generate_tokens(ids, n)
    js = pair.jspec(k, draft)
    want = np.asarray(js.generate_tokens(ids.astype(np.int32), n))
    return got, spec.last_stats, want, js.last_stats


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_self_draft_stream_and_stats_equal_jax(pairs, name):
    """int8 self-speculation: the port's stream is the JAX target-only
    stream and the port's own, and tokens / rounds / accept_rate equal the
    JAX generator's; one host read a round."""
    p = pairs[name]
    ids = prompt(p.args, 5)
    n = min(24, p.args.max_seq_len - 5 - 5)
    got, st, want, jst = run_both(p, ids, n, 4, "int8", p.td)
    assert got.shape == (1, n) and got.dtype == np.int32
    assert got.tolist() == want.tolist() == p.jax_target_stream(ids, n)
    assert got.tolist() == p.tt.generate_tokens(ids, n).tolist()
    assert {k: st[k] for k in STATS} == jst
    assert st["host_reads"] == st["rounds"] and st["accept_rate"] >= 0.5


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_k_and_lengths_equal_jax(pairs, k):
    p = pairs["test-tiny"]
    ids = prompt(p.args, 9, seed=1)
    for n in (1, 5, 17):
        got, st, want, jst = run_both(p, ids, n, k, "int8", p.td)
        assert got.tolist() == want.tolist() == p.jax_target_stream(ids, n), (k, n)
        assert {s: st[s] for s in STATS} == jst, (k, n)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_unrelated_draft_is_lossless(pairs, name):
    """A draft with other weights proposes garbage: the stream is still
    the target's, at one bonus token a round."""
    p = pairs[name]
    bad = Llama(jsynth(jpreset(name), 99), p.args, device="cpu")
    ids = prompt(p.args, 4, seed=2)
    got, st, want, jst = run_both(p, ids, 12, 3, "bad", bad)
    assert got.tolist() == want.tolist() == p.jax_target_stream(ids, 12)
    assert {s: st[s] for s in STATS} == jst
    assert st["accept_rate"] <= 0.5


def test_perfect_draft_accepts_everything(pairs):
    p = pairs["test-tiny"]
    twin = Llama(p.w, p.args, device="cpu")
    ids = prompt(p.args, 5, seed=3)
    got, st, want, jst = run_both(p, ids, 22, 4, "twin", twin)
    assert got.tolist() == want.tolist() == p.jax_target_stream(ids, 22)
    assert {s: st[s] for s in STATS} == jst
    assert st["accept_rate"] >= 0.95 and st["rounds"] <= -(-21 // 5) + 1


def test_validation(pairs):
    p = pairs["test-tiny"]
    spec = SpeculativeGenerator(p.tt, p.td, k=4)
    with pytest.raises(ValueError, match="single-stream"):
        spec.generate_tokens(np.ones((2, 4), np.int64), 4)
    with pytest.raises(ValueError, match="max_seq_len"):
        spec.generate_tokens(np.ones((1, 4), np.int64), p.args.max_seq_len)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeGenerator(p.tt, p.td, k=0)
    wide = p.args.replace(vocab_size=p.args.vocab_size * 2)
    other = Llama(jsynth(jpreset("test-tiny", vocab_size=wide.vocab_size), 1), wide,
                  device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeGenerator(p.tt, other)
    elsewhere = copy.copy(p.td)
    elsewhere.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        SpeculativeGenerator(p.tt, elsewhere)


def test_quantized_draft_is_the_int8_engine(pairs):
    p = pairs["test-tiny"]
    assert p.td.args.quant == "int8" and p.td.params["layers"]["wqkv"].dtype == torch.int8
    ref = Llama(p.w, p.args.replace(quant="int8"), device="cpu")
    ids = prompt(p.args, 6, seed=4)
    np.testing.assert_array_equal(p.td(ids, 0), ref(ids, 0))


def test_lazy_exports():
    import llama3np_tpu_torch as pkg

    assert pkg.SpeculativeGenerator is SpeculativeGenerator
    assert "quantized_draft" in pkg.__all__
    with pytest.raises(AttributeError):
        pkg.not_a_name  # noqa: B018


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_bf16_target_within_envelope(name):
    """A bf16 target with its int8 self-draft: the stream equals the bf16
    target-only stream of the port and of the JAX engine, or first parts
    from one at a near-tie of that engine's logits (a top-2 margin under
    the bf16 envelope of tests/test_dtype.py, 0.15 x max(1, max |logits|)):
    the verify pass's (k+1)-row products and the decode step's one-row
    products may round a near-tie apart in bf16."""
    targs = tpreset(name, dtype="bfloat16")
    w = jsynth(jpreset(name), 11)
    tgt = Llama(w, targs, device="cpu")
    jt = JLlama(w, jpreset(name, dtype="bfloat16", attn_impl="xla"))
    spec = SpeculativeGenerator(tgt, quantized_draft(w, targs, device="cpu"), k=4)
    ids = prompt(targs, 6, seed=5)
    got = spec.generate_tokens(ids, 16)[0].tolist()
    assert spec.last_stats["tokens"] >= 16

    def check(want, logits_of):
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if i is None:
            return
        lg = np.asarray(logits_of(np.array([ids[0].tolist() + want[:i]])), np.float32)[0, -1]
        top = np.sort(lg)[-2:]
        assert top[1] - top[0] < 0.15 * max(1.0, np.abs(lg).max()), (name, i)

    check(tgt.generate_tokens(ids, 16)[0].tolist(), lambda c: tgt(c, 0))
    jt.reset()
    check(np.asarray(jt.generate_tokens(ids.astype(np.int32), 16))[0].tolist(),
          lambda c: jt(c.astype(np.int32), 0))
