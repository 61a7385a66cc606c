"""The port's int8 weights (`quant="int8"`) against the JAX package (CPU).

Both packages get the same numpy weights.  `quantize_param_tree` gives the
JAX function's int8 payloads and scales bit for bit; the scaled
projections, the int8 engine and its decode step agree with the JAX
package's at rtol 2e-4 / atol 1e-4 (f32 sums in another order) with
identical greedy streams.  The JAX engine runs the whole-layer layout
(`pallas_ffn_block=0`): its default int8 layout is the TPU's KV-head-grouped
and FFN-blocked plan, whose per-(block, column) scales the port does not
take over.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models import llama as jllama
from llama3np_tpu.ops import core as jops
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import params_from_jax
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.generate import (decode_steps, kernel_decode_steps,
                                         pad_prompt, prefill_step)
from llama3np_tpu_torch.models import llama as tllama
from llama3np_tpu_torch.ops import core as tops
from llama3np_tpu_torch.ops.kernels.decode_step import (decode_layers,
                                                        decode_layers_plain)
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
PRESETS = ["test-tiny", "test-tiny-mha"]
WHOLE = dict(pallas_ffn_block=0)  # the JAX engine's whole-layer int8 tree


def grid_weights(args, seed):
    """Synthetic weights snapped onto an exactly int8-representable grid per
    output channel (the rule of tests/test_quant.py): quantization then
    round-trips, and the int8 engine computes the fp32 engine's numbers."""
    out = {}
    for k, v in jsynth(args, seed).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 2:
            s = np.maximum(np.max(np.abs(v), axis=-1, keepdims=True) / 127.0, 1e-12)
            v = (np.clip(np.rint(v / s), -127, 127) * s).astype(np.float32)
        out[k] = v
    return out


def weights(name, kind, seed=5):
    args = jpreset(name)
    return grid_weights(args, seed) if kind == "grid" else jsynth(args, seed)


def engines(name, w, **kw):
    """The JAX whole-layer int8 engine (XLA) and the port's, on the CPU."""
    return (jllama.Llama(w, jpreset(name, attn_impl="xla", quant="int8", **WHOLE, **kw)),
            tllama.Llama(w, tpreset(name, quant="int8", **kw), device="cpu"))


def port_engine(name, kind="synthetic"):
    return tllama.Llama(weights(name, kind), tpreset(name, quant="int8"), device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# quantize_param_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("layout", ["fused", "split"])
def test_quantize_param_tree_equals_jax(name, layout):
    jargs, targs = jpreset(name), tpreset(name)
    w = jsynth(jargs, seed=3)
    jtree = jckpt.permute_rope_layout(jckpt.build_param_tree(w, jargs), jargs)
    ttree = tckpt.permute_rope_layout(tckpt.build_param_tree(w, targs), targs)
    if layout == "fused":
        jtree, ttree = jckpt.fuse_param_tree(jtree, 0), tckpt.fuse_param_tree(ttree)
    want = jax.tree.map(np.asarray, jckpt.quantize_param_tree(jtree))
    got = tckpt.quantize_param_tree(ttree)
    assert got.keys() == want.keys()
    assert got["layers"].keys() == want["layers"].keys()
    pairs = [(got[k], want[k], k) for k in want if k != "layers"]
    pairs += [(got["layers"][k], v, k) for k, v in want["layers"].items()]
    for g, wnt, k in pairs:
        assert g.dtype == wnt.dtype and g.shape == wnt.shape, k
        np.testing.assert_array_equal(g, wnt, err_msg=k)
    assert got["layers"]["wo"].dtype == np.int8
    assert got["tok_embedding_scale"].shape == (jargs.vocab_size, 1)


def test_quantize_param_tree_refuses_int4():
    tree = tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 0), tpreset("test-tiny"))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tckpt.quantize_param_tree(tree, bits=4)


def test_int8_memory_is_a_quarter():
    args = tpreset("test-tiny")
    fused = tckpt.fuse_param_tree(tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 0), args))
    q = tckpt.quantize_param_tree(fused)
    nbytes = lambda tree: sum(a.nbytes for a in tree.values())  # noqa: E731
    assert nbytes(q["layers"]) < 0.3 * nbytes(fused["layers"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_device_keeps_int8_and_f32_scales(dtype):
    args = tpreset("test-tiny")
    tree = tckpt.quantize_param_tree(tckpt.fuse_param_tree(
        tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 0), args)))
    dev = tckpt.params_to_device(tree, "cpu", dtype)
    assert dev["layers"]["wqkv"].dtype == torch.int8
    assert dev["layers"]["wqkv_scale"].dtype == torch.float32
    assert dev["lm_head_scale"].dtype == torch.float32
    assert dev["layers"]["attn_norm"].dtype == tckpt.torch_dtype(dtype)


# ---------------------------------------------------------------------------
# scaled ops
# ---------------------------------------------------------------------------

def _q8(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    s = np.maximum(np.abs(w).max(axis=0, keepdims=True) / 127, 1e-12).astype(np.float32)
    return np.clip(np.rint(w / s), -127, 127).astype(np.int8), s


@pytest.mark.parametrize("op", ["fused_qkv", "fused_o_proj", "fused_ffn", "swiglu",
                                "embed_tokens", "lm_logits"])
def test_scaled_ops_match_jax(rng, op):
    B, L, D, F, NH, KVH, HD = 2, 3, 32, 48, 4, 2, 8
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    J = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    T = lambda *a: [t(v) for v in a]  # noqa: E731
    if op == "fused_qkv":
        w, s = _q8(rng, D, (NH + 2 * KVH) * HD)
        want = jops.fused_qkv(*J(x, w), NH, KVH, HD, scale=jnp.asarray(s))
        got = tops.fused_qkv(*T(x, w), NH, KVH, HD, scale=t(s))
    elif op == "fused_o_proj":
        a = rng.standard_normal((B, L, NH, HD)).astype(np.float32)
        w, s = _q8(rng, NH * HD, D)
        want = [jops.fused_o_proj(*J(a, w), scale=jnp.asarray(s))]
        got = [tops.fused_o_proj(*T(a, w), scale=t(s))]
    elif op == "fused_ffn":
        wgu, sgu = _q8(rng, D, 2 * F)
        wd, sd = _q8(rng, F, D)
        want = [jops.fused_ffn(*J(x, wgu, wd), scale_gu=jnp.asarray(sgu),
                               scale_down=jnp.asarray(sd))]
        got = [tops.fused_ffn(*T(x, wgu, wd), t(sgu), t(sd))]
    elif op == "swiglu":
        (wg, sg), (wu, su), (wd, sd) = _q8(rng, D, F), _q8(rng, D, F), _q8(rng, F, D)
        want = [jops.swiglu(*J(x, wg, wu, wd), s_gate=jnp.asarray(sg),
                            s_up=jnp.asarray(su), s_down=jnp.asarray(sd))]
        got = [tops.swiglu(*T(x, wg, wu, wd), s_gate=t(sg), s_up=t(su), s_down=t(sd))]
    else:
        emb, emb_s = _q8(rng, D, 40)  # per-row scales of a [VS, D] table
        head, head_s = _q8(rng, D, 40)
        params = {"tok_embedding": emb.T.copy(), "tok_embedding_scale": emb_s.T.copy(),
                  "lm_head": head, "lm_head_scale": head_s,
                  "norm": np.ones(D, np.float32)}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: t(v) for k, v in params.items()}
        if op == "embed_tokens":
            ids = rng.integers(0, 40, size=(B, L))
            want = [jllama.embed_tokens(jp, jnp.asarray(ids))]
            got = [tllama.embed_tokens(tp, t(ids))]
        else:
            want = [jllama.lm_logits(jp, jnp.asarray(x), None)]
            got = [tllama.lm_logits(tp, t(x))]
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("kind", ["grid", "synthetic"])
def test_int8_engine_matches_jax(rng, name, kind):
    w = weights(name, kind)
    jeng, teng = engines(name, w)
    assert teng.params["layers"]["wqkv"].dtype == torch.int8
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32)
    assert_allclose(teng(ids, 0), jeng(ids, 0), rtol=RTOL, atol=ATOL)
    for step, tok in enumerate([7, 31]):  # single-token decode forwards
        nxt = np.array([[tok]], np.int32)
        assert_allclose(teng(nxt, 5 + step), jeng(nxt, 5 + step), rtol=RTOL, atol=ATOL)
    got = teng.generate_tokens(ids, 10)[0].tolist()
    assert got == np.asarray(jeng.generate_tokens(ids, 10))[0].tolist()


@pytest.mark.parametrize("name", PRESETS)
def test_int8_engine_on_grid_weights_matches_fp32(rng, name):
    """On grid weights quantization round-trips: the int8 engine computes
    the fp32 engine's numbers (post-scale instead of pre-scale)."""
    w = weights(name, "grid")
    fp = tllama.Llama(w, tpreset(name), device="cpu")
    q8 = tllama.Llama(w, tpreset(name, quant="int8"), device="cpu")
    ids = rng.integers(3, jpreset(name).vocab_size, size=(1, 5)).astype(np.int32)
    assert_allclose(q8(ids, 0), fp(ids, 0), rtol=RTOL, atol=ATOL)
    assert q8.generate_tokens(ids, 10).tolist() == fp.generate_tokens(ids, 10).tolist()


@pytest.mark.parametrize("name", PRESETS)
def test_params_from_jax_carries_int8_tree(name):
    jeng, teng = engines(name, weights(name, "synthetic"))
    carried = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    assert carried["layers"].keys() == teng.params["layers"].keys()
    assert "wgu_scale" in carried["layers"] and "lm_head_scale" in carried
    for k, v in teng.params["layers"].items():
        assert torch.equal(carried["layers"][k], v), k
    for k in ("tok_embedding", "tok_embedding_scale", "lm_head", "lm_head_scale", "norm"):
        assert torch.equal(carried[k], teng.params[k]), k


def test_params_from_jax_refuses_tpu_int8_layouts():
    """The JAX engine's default int8 tree is the TPU's grouped and blocked
    plan, with per-(block, column) scales."""
    args = jpreset("test-tiny", quant="int8", pallas_ffn_block=32, pallas_attn_group=True)
    jeng = jllama.Llama(jsynth(args, seed=1), args)
    with pytest.raises(ValueError, match="whole-layer"):
        params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")


def test_int8_first_token_equals_jax_streamed_kernel(rng):
    """The JAX streamed int8 kernel in interpret mode (the TPU layout the
    decode kernel's int8 mode replaces): the first token comes from the
    prefill and equals the port's; tests/test_quant.py holds the kernel's
    later tokens to the XLA path only within a bf16 envelope."""
    kw = dict(quant="int8", pallas_stream=(32, 16, 32, 32))
    args_p = jpreset("test-tiny", attn_impl="pallas", **kw)
    w = grid_weights(args_p, seed=5)
    ids = rng.integers(3, args_p.vocab_size, size=(1, 5)).astype(np.int32)
    jeng = jllama.Llama(w, args_p)
    assert jeng.cfg.stream_plan == (32, 16, 32, 32)
    teng = tllama.Llama(w, tpreset("test-tiny", **kw), device="cpu")
    want = np.asarray(jeng.generate_tokens(ids, 6))[0, 0]
    assert int(teng.generate_tokens(ids, 6)[0, 0]) == int(want)


def test_int8_bf16_engine_matches_jax_streamed_engine(rng):
    """int8 weights under bf16 activations (the JAX engine's llama3-8b
    `quant="int8"` configuration) against the JAX engine on its streamed
    kernel in interpret mode: the first token (from the prefill) equal,
    then three decode tokens through the port's decode step (CPU: the
    plain version of the int8/bf16 mode) whose logits stay within the
    bf16 envelope of the JAX engine's, 2e-2 x max(1, max |logits|)
    (tests/test_torch_bf16.py), with top-1 equal."""
    kw = dict(quant="int8", dtype="bfloat16", pallas_stream=(32, 16, 32, 32))
    args_p = jpreset("test-tiny", attn_impl="pallas", **kw)
    w = grid_weights(args_p, seed=5)
    ids = rng.integers(3, args_p.vocab_size, size=(1, 5)).astype(np.int32)
    jeng = jllama.Llama(w, args_p)
    assert jeng.cfg.stream_plan == (32, 16, 32, 32)
    teng = tllama.Llama(w, tpreset("test-tiny", **kw), device="cpu")
    assert teng.params["layers"]["wqkv"].dtype == torch.int8
    assert teng.params["layers"]["attn_norm"].dtype == torch.bfloat16
    want = np.asarray(jeng.generate_tokens(ids, 6))[0, 0]
    assert int(teng.generate_tokens(ids, 6)[0, 0]) == int(want)

    jeng.reset()
    teng.reset()
    jeng(ids, 0)
    teng(ids, 0)
    p, L = teng.params, ids.shape[1]
    kc, vc = teng.cache["k"][:, 0], teng.cache["v"][:, 0]
    dkw = dict(n_heads=args_p.n_heads, kv_heads=args_p.kv_heads,
               head_dim=args_p.head_dim, norm_eps=args_p.norm_eps)
    for i, tok in enumerate([11, 300, 42]):
        want = np.asarray(jeng(np.array([[tok]], np.int32), L + i), np.float32)[0, -1]
        x = tllama.embed_tokens(p, torch.tensor([tok]))
        h, kc, vc = decode_layers(p["layers"], x, L + i, kc, vc, teng.cos[L + i : L + i + 1],
                                  teng.sin[L + i : L + i + 1], **dkw)
        got = tllama.lm_logits(p, tops.rms_norm(h, p["norm"], args_p.norm_eps))[0].float()
        assert np.abs(got.numpy() - want).max() <= 2e-2 * max(1.0, np.abs(want).max())
        assert int(got.argmax()) == int(want.argmax())


@pytest.mark.parametrize("name", PRESETS)
def test_decode_layers_plain_int8_matches_jax_decode_step(rng, name):
    """One decode token through `decode_layers` (CPU: its plain version) on
    the int8 tree equals the JAX engine's XLA int8 decode step."""
    jeng, teng = engines(name, weights(name, "synthetic"))
    args = jpreset(name)
    ids = rng.integers(3, args.vocab_size, size=(1, 6)).astype(np.int32)
    jeng(ids, 0)
    teng(ids, 0)
    tok, L = 11, ids.shape[1]
    want = jeng(np.array([[tok]], np.int32), L)[0, -1]
    p = teng.params
    x = tllama.embed_tokens(p, torch.tensor([tok]))
    kc, vc = teng.cache["k"][:, 0], teng.cache["v"][:, 0]
    kw = dict(n_heads=args.n_heads, kv_heads=args.kv_heads, head_dim=args.head_dim,
              norm_eps=args.norm_eps)
    before = decode_layers.launches
    h, _, _ = decode_layers(p["layers"], x, L, kc, vc, teng.cos[L : L + 1],
                            teng.sin[L : L + 1], **kw)
    assert decode_layers.launches == before  # CPU: the plain version
    got = tllama.lm_logits(p, tops.rms_norm(h, p["norm"], args.norm_eps))[0]
    assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    h2, _, _ = decode_layers_plain(p["layers"], x, L, kc.clone(), vc.clone(),
                                   teng.cos[L : L + 1], teng.sin[L : L + 1], **kw)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


@pytest.mark.parametrize("name", PRESETS)
def test_int8_kernel_decode_loop_matches_plain_loop(rng, name):
    """The decode loop the card runs (decode_layers per token, the int8
    scales passed through) against the plain forward loop on CPU tensors."""
    teng = port_engine(name)
    args = teng.args
    ids = rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32)
    padded, L = pad_prompt(ids, args)
    cache = teng.init_cache(1)
    tok0, cache = prefill_step(teng.params, torch.as_tensor(padded), L, cache,
                               teng.cos, teng.sin, teng.cfg)
    other = {k: v.clone() for k, v in cache.items()}
    n = 12
    want, cache = decode_steps(teng.params, tok0, L, cache, teng.cos, teng.sin,
                               teng.cfg, n)
    got, other = kernel_decode_steps(teng.params, tok0, L, other, teng.cos,
                                     teng.sin, teng.cfg, n)
    assert got.tolist() == want.tolist()
    torch.testing.assert_close(other["k"], cache["k"], rtol=RTOL, atol=ATOL)


def test_decode_layers_int8_refuses_missing_scales():
    teng = port_engine("test-tiny")
    args = teng.args
    layers = dict(teng.params["layers"])
    layers.pop("wo_scale")
    kc = torch.zeros(args.n_layers, args.kv_heads, args.max_seq_len, args.head_dim)
    row = torch.zeros(1, args.head_dim // 2)
    with pytest.raises(ValueError, match="wo_scale"):
        decode_layers(layers, torch.zeros(1, args.dim), 0, kc, kc.clone(), row, row,
                      n_heads=args.n_heads, kv_heads=args.kv_heads,
                      head_dim=args.head_dim, norm_eps=args.norm_eps)


def test_config_quant_values():
    assert tpreset("test-tiny", quant="int8", kv_quant="int8").quant == "int8"
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tpreset("test-tiny", quant="int4")
    with pytest.raises(ValueError, match="unsupported quant"):
        tpreset("test-tiny", quant="fp8")
    with pytest.raises(ValueError, match="unsupported kv_quant"):
        tpreset("test-tiny", kv_quant="int4")
    assert dataclasses.asdict(tpreset("test-tiny", quant="int8")) == \
        dataclasses.asdict(jpreset("test-tiny", quant="int8"))


# ---------------------------------------------------------------------------
# serving with int8 weights, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged,quantum", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_int8_serving_matches_jax_and_solo(rng, paged, quantum):
    """tests/test_quant.py's serving scenario (two staggered requests on an
    int8 model) through both `BatchEngine`s: the streams are equal, and
    equal each prompt's solo int8 stream."""
    jeng, teng = engines("test-tiny", weights("test-tiny", "grid"))
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 7)]

    def run(BE, eng):
        be = BE(eng, capacity=2, **(dict(paged=True, page_size=8) if paged else {}))
        r0 = be.submit(prompts[0], 8)
        be.step(quantum)
        r1 = be.submit(prompts[1], 8)
        while be.num_active or be._queue:
            be.step(quantum)
        return [r0.generated, r1.generated]

    got = run(BatchEngine, teng)
    assert got == run(JBatchEngine, jeng)
    for p, g in zip(prompts, got):
        solo = teng.generate_tokens(np.array([p]), 8)[0].tolist()
        cut = next((i for i, x in enumerate(solo) if x in (1, 2)), len(solo))
        assert g == solo[:cut]


def test_cli_quant_int8_on_cpu(tmp_path, capsys):
    from llama3np_tpu_torch.cli import main

    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    tokens += [f"<{i}>" for i in range(512 - len(tokens))]
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({"tokens": tokens, "scores": [0.0] * 512}))
    vocab = str(vocab)
    base = ["--synthetic", "--preset", "test-tiny", "--tokenizer", vocab,
            "--max-new-tokens", "8", "--stats-json", "--device", "cpu", "abc dd"]
    assert main(base + ["--quant", "int8"]) == 0
    out = capsys.readouterr().out
    assert "Token count:" in out
    assert '"generated_tokens": 8' in out.splitlines()[-1]
    assert main(base + ["--quant", "int4"]) == 2
    assert "ROADMAP A5" in capsys.readouterr().err
