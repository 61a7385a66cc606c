"""The port's model and generation loop on the CPU against the JAX `Llama`
and the NumPy oracle, on the same synthetic weights.

fp32 logits agree at rtol 2e-4 / atol 1e-4 with equal top-5 tokens, and
greedy token streams are identical (the invariants the JAX package holds
itself to).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax

from llama3np_tpu import NumpyLlama
from llama3np_tpu import build_param_tree as j_build_param_tree
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.generate import Sampling
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu_torch import Llama, params_from_jax, preset
from llama3np_tpu_torch.generate import (decode_steps, kernel_decode_steps,
                                         pad_prompt, prefill_step)
from llama3np_tpu_torch.observability import timed_generate

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
PRESETS = ["test-tiny", "test-tiny-mha"]


def engines(name, seed=7, **kw):
    w = jsynth(jpreset(name), seed=seed)
    return (w, JLlama(w, jpreset(name, **kw)),
            Llama(w, preset(name, **kw), device="cpu"))


def assert_logits_match(got, want):
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    top = lambda a: np.argsort(-a[:, -1], axis=-1, kind="stable")[:, :5]  # noqa: E731
    np.testing.assert_array_equal(top(got), top(want))


@pytest.mark.parametrize("name", PRESETS)
def test_params_from_jax_equals_own_build(name):
    _, jeng, teng = engines(name)
    tree = jax.tree.map(np.asarray, jeng.params)
    carried = params_from_jax(tree, "cpu")
    assert carried.keys() == teng.params.keys()
    assert carried["layers"].keys() == teng.params["layers"].keys()
    for key, leaf in teng.params.items():
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                assert torch.equal(carried["layers"][k], v), k
        else:
            assert torch.equal(carried[key], leaf), key


def test_params_from_jax_refuses_tpu_layouts():
    args = jpreset("test-tiny", pallas_ffn_block=32, pallas_attn_group=True)
    jeng = JLlama(jsynth(args, seed=1), args)
    with pytest.raises(ValueError, match="whole-layer"):
        params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")


@pytest.mark.parametrize("name", PRESETS)
def test_call_logits_match_jax_and_oracle(name, rng):
    w, jeng, teng = engines(name)
    args = jpreset(name)
    oracle = NumpyLlama(j_build_param_tree(w, args), args)
    ids = rng.integers(3, args.vocab_size, size=(1, 6)).astype(np.int32)
    assert_logits_match(teng(ids, 0), jeng(ids, 0))
    assert_logits_match(teng(ids, 0), oracle(ids, 0))
    for step, tok in enumerate([5, 17, 99]):  # single-token decode forwards
        nxt = np.array([[tok]], np.int32)
        got = teng(nxt, 6 + step)
        assert_logits_match(got, jeng(nxt, 6 + step))
        assert_logits_match(got, oracle(nxt, 6 + step))


@pytest.mark.parametrize("name", PRESETS)
def test_chunked_and_blockwise_prefill_match_jax(name, rng):
    """prefill_kv_block=8 sends the 16-token first chunk and the 8-token
    chunk against the cache through the blockwise (flash-semantics) path."""
    _, jeng, teng = engines(name, prefill_kv_block=8)
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 24)).astype(np.int32)
    assert_logits_match(teng(ids[:, :16], 0), jeng(ids[:, :16], 0))
    assert_logits_match(teng(ids[:, 16:], 16), jeng(ids[:, 16:], 16))


@pytest.mark.parametrize("name", PRESETS)
def test_greedy_stream_matches_jax_and_oracle(name, rng):
    w, jeng, teng = engines(name)
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32)
    n = args.max_seq_len - 5  # up to the cache's last row
    got = teng.generate_tokens(ids, n)
    assert got.device.type == "cpu" and got.shape == (1, n)
    got = got[0].tolist()
    assert got == np.asarray(jeng.generate_tokens(ids, n))[0].tolist()
    oracle = NumpyLlama(j_build_param_tree(w, args), args)
    assert got[:12] == oracle.greedy_tokens(ids, 12)


def test_greedy_batch_matches_jax(rng):
    _, jeng, teng = engines("test-tiny")
    ids = rng.integers(3, 512, size=(3, 4)).astype(np.int32)
    assert teng.generate_tokens(ids, 9).tolist() == \
        np.asarray(jeng.generate_tokens(ids, 9)).tolist()


@pytest.mark.parametrize("max_new", [3, 4, 11])
def test_generate_count_quirk_q2(max_new, rng):
    """`generate` bounds the TOTAL length: it yields max_new_tokens - L
    tokens of shape [B, 1], as the reference and the JAX engine do."""
    _, jeng, teng = engines("test-tiny")
    ids = rng.integers(3, 512, size=(1, 4)).astype(np.int32)
    got = list(teng.generate(ids, max_new))
    want = list(jeng.generate(ids, max_new))
    assert len(got) == len(want) == max(max_new - 4, 0)
    assert all(t.shape == (1, 1) for t in got)
    assert [int(t[0, 0]) for t in got] == [int(t[0, 0]) for t in want]


@pytest.mark.parametrize("name", PRESETS)
def test_kernel_decode_loop_matches_plain_loop(name, rng):
    """The decode loop the card runs (decode_layers per token), here with
    CPU tensors (the wrapper's plain version), against the plain forward
    loop: same tokens and same cache rows."""
    _, _, teng = engines(name)
    args = teng.args
    ids = rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32)
    padded, L = pad_prompt(ids, args)
    cache = teng.init_cache(1)
    tok0, cache = prefill_step(teng.params, torch.as_tensor(padded), L, cache,
                               teng.cos, teng.sin, teng.cfg)
    other = {k: v.clone() for k, v in cache.items()}
    n = args.max_seq_len - L
    want, cache = decode_steps(teng.params, tok0, L, cache, teng.cos, teng.sin,
                               teng.cfg, n)
    got, other = kernel_decode_steps(teng.params, tok0, L, other, teng.cos,
                                     teng.sin, teng.cfg, n)
    assert got.tolist() == want.tolist()
    torch.testing.assert_close(other["k"], cache["k"], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(other["v"], cache["v"], rtol=RTOL, atol=ATOL)


def test_timed_generate_matches_generate_tokens(rng):
    _, _, teng = engines("test-tiny")
    ids = rng.integers(3, 512, size=(1, 4)).astype(np.int32)
    want = teng.generate_tokens(ids, 8)[0].tolist()
    toks, stats = timed_generate(teng, ids, 8)
    assert toks[0].tolist() == want
    assert stats.prompt_tokens == 4 and stats.generated_tokens == 8
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_cpu_engine_uses_plain_path():
    _, _, teng = engines("test-tiny")
    assert not teng.cfg.kernels
    assert teng.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in teng.params["layers"].values())


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    w = jsynth(jpreset("test-tiny"), seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(w, preset("test-tiny"))  # device defaults to "cuda"


def test_pallas_impl_raises_on_cpu():
    w = jsynth(jpreset("test-tiny"), seed=1)
    with pytest.raises(ValueError, match="pallas"):
        Llama(w, preset("test-tiny", attn_impl="pallas"), device="cpu")


@pytest.mark.parametrize("kw", [dict(quant="int4"), dict(fuse_matmuls=False)])
def test_unported_options_raise(kw):
    """Options the port once refused now behave as in the JAX engine:
    int4 on the fused default layout raises JAX's "unfused" ValueError;
    the split layout builds and computes the JAX engine's logits."""
    w = jsynth(jpreset("test-tiny"), seed=1)
    try:
        want = JLlama(w, jpreset("test-tiny", attn_impl="xla", **kw))
    except ValueError as e:
        with pytest.raises(ValueError, match="unfused"):
            Llama(w, preset("test-tiny", **kw), device="cpu")
        assert "unfused" in str(e)
        return
    got = Llama(w, preset("test-tiny", **kw), device="cpu")
    ids = np.array([[1, 5, 9, 14]])
    assert_logits_match(got(ids, 0), np.asarray(want(ids.astype(np.int32), 0)))


def test_sampling_matches_jax_and_temperature_zero_is_greedy(rng):
    """The JAX package's policy object drives the port's sampler (the same
    fields): the port draws the JAX engine's stream; temperature 0 is the
    greedy stream."""
    _, jeng, teng = engines("test-tiny")
    ids = rng.integers(3, 512, size=(1, 4)).astype(np.int32)
    pol = Sampling(temperature=0.8, seed=4)
    assert teng.generate_tokens(ids, 8, sampling=pol)[0].tolist() == \
        np.asarray(jeng.generate_tokens(ids, 8, sampling=pol))[0].tolist()
    greedy = teng.generate_tokens(ids, 4)[0].tolist()
    assert teng.generate_tokens(ids, 4, sampling=Sampling(temperature=0.0))[0].tolist() == greedy


def test_bf16_model_runs_plain_on_cpu(rng):
    """A bf16 model takes the plain path (the kernels are float32 only)."""
    w = jsynth(jpreset("test-tiny"), seed=2)
    eng = Llama(w, preset("test-tiny", dtype="bfloat16"), device="cpu")
    assert eng.params["layers"]["wqkv"].dtype == torch.bfloat16
    ids = rng.integers(3, 512, size=(1, 4)).astype(np.int32)
    logits = eng(ids, 0)
    assert logits.shape == (1, 1, 512) and np.isfinite(logits).all()
    ref = Llama(w, preset("test-tiny"), device="cpu")(ids, 0)
    assert_allclose(logits, ref, rtol=5e-2, atol=5e-2)
