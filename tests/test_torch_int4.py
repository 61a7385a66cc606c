"""The port's split-weight layout, int4 and mixed-bit weights and quantized
checkpoints against the JAX package (CPU).

Both packages get the same numpy weights.  `quantize_param_tree(bits=4)`
gives the JAX function's int4 codes (the port packs them two a byte) and
its scales bit for bit; the split engines (float32, bf16, int8) and the
int4 engine agree with the JAX engines of `fuse_matmuls=False` at rtol
2e-4 / atol 1e-4 in float32 (bf16: the tests/test_dtype.py envelope) with
identical greedy streams.  On weights snapped to the int4 grid (the rule
of tests/test_int4.py) the int4 engine computes the float32 engine's
numbers.  Quantized `.npz` checkpoints written by either package boot in
the other with equal streams.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax

from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import generate as tgen
from llama3np_tpu_torch import params_from_jax
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.generate import Generator
from llama3np_tpu_torch.models import llama as tllama
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.ops import core as tops
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
PRESETS = ["test-tiny", "test-tiny-mha"]
SPLIT = dict(fuse_matmuls=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grid4_weights(args, seed):
    """Synthetic weights snapped onto the int4 lattice (qmax 7) per output
    channel, as tests/test_int4.py snaps them."""
    out = {}
    for k, v in jsynth(args, seed).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 2:
            s = np.maximum(np.max(np.abs(v), axis=-1, keepdims=True) / 7.0, 1e-12)
            v = (np.clip(np.rint(v / s), -7, 7) * s).astype(np.float32)
        out[k] = v
    return out


def engines(name, w, **kw):
    """The JAX engine (XLA) and the port's on the CPU, both split."""
    return (JLlama(w, jpreset(name, attn_impl="xla", **SPLIT, **kw)),
            Llama(w, tpreset(name, **SPLIT, **kw), device="cpu"))


def stream(eng, ids, n):
    if hasattr(eng, "reset"):
        eng.reset()
    return np.asarray(eng.generate_tokens(ids, n)).tolist()


def prompt(args, n, seed=0):
    return np.random.default_rng(seed).integers(3, args.vocab_size, size=(1, n))


def host(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# packing and quantize_param_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 48, 129])
def test_pack_int4_roundtrip(n):
    codes = np.random.default_rng(n).integers(-8, 8, size=(3, 2, n)).astype(np.int8)
    packed = tckpt.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 2, (n + 1) // 2)
    assert np.array_equal(tckpt.unpack_int4(packed, n).numpy(), codes)
    assert torch.equal(tckpt.pack_int4(torch.from_numpy(codes)), packed)
    if n % 2:  # the padding nibble is zero
        assert int((packed[..., -1] >> 4).max()) == 0


def test_pack_int4_nibble_order():
    p = tckpt.pack_int4(np.array([-7, 1, 7, -1, 0], np.int8))
    assert p.tolist() == [0x19, 0xF7, 0x00]


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("head_bits", [None, 8])
def test_quantize_int4_equals_jax(name, layout, head_bits):
    """int4 codes value-equal to JAX's (its host tree: one ml_dtypes.int4
    a byte), scales bit-equal; bits=4, head_bits=8 keeps an int8 head."""
    jargs, targs = jpreset(name), tpreset(name)
    w = jsynth(jargs, seed=3)
    jtree = jckpt.permute_rope_layout(jckpt.build_param_tree(w, jargs), jargs)
    ttree = tckpt.permute_rope_layout(tckpt.build_param_tree(w, targs), targs)
    if layout == "fused":
        jtree, ttree = jckpt.fuse_param_tree(jtree, 0), tckpt.fuse_param_tree(ttree)
    want = host(jckpt.quantize_param_tree(jtree, bits=4, head_bits=head_bits))
    got = tckpt.quantize_param_tree(ttree, bits=4, head_bits=head_bits)
    assert got.keys() == want.keys() and got["layers"].keys() == want["layers"].keys()
    items = [(k, got[k], want[k]) for k in want if k != "layers"]
    items += [(f"layers.{k}", got["layers"][k], v) for k, v in want["layers"].items()]
    for key, g, wnt in items:
        if wnt.dtype.name == "int4":
            assert g.dtype == np.uint8, key
            codes = tckpt.unpack_int4(torch.from_numpy(g), tckpt.int4_width(got, key))
            np.testing.assert_array_equal(codes.numpy(), wnt.astype(np.int8), err_msg=key)
        else:
            assert g.dtype == wnt.dtype and g.shape == wnt.shape, key
            np.testing.assert_array_equal(g, wnt, err_msg=key)
    head = np.int8 if head_bits == 8 else np.uint8
    assert got["lm_head"].dtype == head and got["tok_embedding"].dtype == head


def test_int4_bytes_are_half_int8():
    args = tpreset("test-tiny")
    tree = tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 0), args)
    q8 = tckpt.quantize_param_tree(tree, bits=8)
    q4 = tckpt.quantize_param_tree(tree, bits=4)
    payload = lambda q: sum(q["layers"][k].nbytes for k in  # noqa: E731
                            ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) \
        + q["lm_head"].nbytes + q["tok_embedding"].nbytes
    assert payload(q4) * 2 == payload(q8)
    w32 = tree["layers"]["wq"].nbytes + tree["lm_head"].nbytes
    assert (q4["layers"]["wq"].nbytes + q4["lm_head"].nbytes) * 8 == w32


@pytest.mark.parametrize("bits,head_bits", [(8, None), (4, None), (4, 8)])
def test_quantize_on_device_matches_host(bits, head_bits):
    """`device=` quantizes with torch on that device: codes within 1 of the
    host path's and under 1e-3 of them apart (the JAX test's rule for its
    `device=True`), scales within an f32 rounding."""
    args = tpreset("test-tiny")
    tree = tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 4), args)
    h = tckpt.quantize_param_tree(tree, bits=bits, head_bits=head_bits)
    d = tckpt.quantize_param_tree(tree, bits=bits, head_bits=head_bits, device="cpu")
    for key, hv in tckpt._flat_items(h):
        dv = dict(tckpt._flat_items(d))[key]
        if key.endswith("_scale"):
            assert isinstance(dv, torch.Tensor)
            assert_allclose(dv.numpy(), hv, rtol=1e-6, atol=0)
        elif hv.dtype in (np.int8, np.uint8):
            n = tckpt.int4_width(h, key) if hv.dtype == np.uint8 else None
            a = tops.unpack_int4(torch.from_numpy(hv), n) if n else torch.from_numpy(hv)
            b = tops.unpack_int4(dv, n) if n else dv
            diff = (a.int() - b.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3, key


def test_quantize_refuses_other_widths():
    tree = tckpt.build_param_tree(jsynth(jpreset("test-tiny"), 0), tpreset("test-tiny"))
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tckpt.quantize_param_tree(tree, bits=3)
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tckpt.quantize_param_tree(tree, bits=4, head_bits=2)


def test_int4_product_equals_widened_f32():
    """`_scaled_dot` on a packed weight: the f32 product of the unpacked,
    exactly widened codes, post-scaled."""
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(-7, 8, (2, 64, 33), generator=g, dtype=torch.int8)
    s = torch.rand(2, 1, 33, generator=g) + 0.5
    x = torch.randn(2, 3, 64, generator=g)
    got = tops._scaled_dot(x, tckpt.pack_int4(codes), s)
    torch.testing.assert_close(got, torch.matmul(x, codes.float()) * s, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# engines against the JAX engines
# ---------------------------------------------------------------------------

def assert_logits_match(got, want):
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    top = lambda a: np.argsort(-a[:, -1], axis=-1, kind="stable")[:, :5]  # noqa: E731
    np.testing.assert_array_equal(top(got), top(want))


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_split_engine_matches_jax(name, quant):
    w = (grid4_weights if quant == "int4" else jsynth)(jpreset(name), 5)
    jeng, teng = engines(name, w, quant=quant)
    assert not teng.cfg.fused and "wq" in teng.params["layers"]
    if quant == "int4":
        assert teng.params["layers"]["wq"].dtype == torch.uint8
    ids = prompt(teng.args, 6)
    assert_logits_match(teng(ids, 0), np.asarray(jeng(ids.astype(np.int32), 0)))
    # a chunked step against the cache (first_chunk=False)
    more = prompt(teng.args, 3, seed=1)
    assert_logits_match(teng(more, 6), np.asarray(jeng(more.astype(np.int32), 6)))
    n = min(10, teng.args.max_seq_len - 6)
    assert stream(teng, ids, n) == stream(jeng, ids.astype(np.int32), n)


@pytest.mark.parametrize("name", PRESETS)
def test_split_fp32_equals_fused(name):
    w = jsynth(jpreset(name), 8)
    split = Llama(w, tpreset(name, **SPLIT), device="cpu")
    fused = Llama(w, tpreset(name), device="cpu")
    ids = prompt(split.args, 5)
    assert_allclose(split(ids, 0), fused(ids, 0), rtol=RTOL, atol=ATOL)
    assert stream(split, ids, 8) == stream(fused, ids, 8)


@pytest.mark.parametrize("name", PRESETS)
def test_int4_on_grid_equals_fp32_split(name):
    """tests/test_int4.py's greedy identity: on int4-grid weights the int4
    engine computes the float32 engine's numbers."""
    w = grid4_weights(jpreset(name), 5)
    f32 = Llama(w, tpreset(name, **SPLIT), device="cpu")
    q4 = Llama(w, tpreset(name, quant="int4", **SPLIT), device="cpu")
    ids = prompt(f32.args, 5, seed=2)
    assert_allclose(q4(ids, 0), f32(ids, 0), rtol=RTOL, atol=ATOL)
    assert stream(q4, ids, 10) == stream(f32, ids, 10)


@pytest.mark.parametrize("name", PRESETS)
def test_bf16_split_engine_within_envelope(name):
    """bf16 split engines: logits within tests/test_dtype.py's envelope of
    the JAX bf16 split engine's, top-1 equal."""
    w = jsynth(jpreset(name), 6)
    jeng, teng = engines(name, w, dtype="bfloat16")
    assert teng.params["layers"]["wq"].dtype == torch.bfloat16
    ids = prompt(teng.args, 6, seed=3)
    got = teng(ids, 0).astype(np.float32)
    want = np.asarray(jeng(ids.astype(np.int32), 0), np.float32)
    assert np.abs(got - want).max() < 0.15 * max(1.0, np.abs(want).max())
    assert got[0, -1].argmax() == want[0, -1].argmax()


def test_int4_rejects_fused_layout():
    w = jsynth(jpreset("test-tiny"), 0)
    with pytest.raises(ValueError, match="unfused") as got:
        Llama(w, tpreset("test-tiny", quant="int4"), device="cpu")
    with pytest.raises(ValueError, match="unfused"):
        JLlama(w, jpreset("test-tiny", quant="int4"))
    assert "fuse_matmuls=False" in str(got.value)


@pytest.mark.parametrize("fused", [True, False])
def test_use_kernels_refuses_split_tree(monkeypatch, fused):
    """A split engine whose config says it is on the card (the kernels on)
    still decodes through the plain forward: the decode kernel's wrapper
    is never reached.  The fused engine, as the control, reaches it."""
    name = "test-tiny"
    w = jsynth(jpreset(name), 9)
    eng = Llama(w, tpreset(name, fuse_matmuls=fused), device="cpu")
    want = stream(eng, prompt(eng.args, 4), 6)
    calls, real = [], tgen.decode_layers

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tgen, "decode_layers", counting)
    eng.cfg = eng.cfg._replace(kernels=True)
    eng._gen = None
    assert Generator(eng).use_kernels(1) is fused
    assert stream(eng, prompt(eng.args, 4), 6) == want
    assert len(calls) == (5 if fused else 0)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("paged,quantum", [(False, 1), (True, 1), (True, 4)])
def test_int4_serving_matches_jax_and_solo(name, paged, quantum):
    """tests/test_int4.py's serving scenario (int4 weights, int8 KV)
    through both `BatchEngine`s, with a second request: equal streams, each
    equal to its solo stream (a capacity-1 engine over the same int8
    pools: int8 KV rounds the cache, so the dense float stream may part
    from it)."""
    w = grid4_weights(jpreset(name), 3)
    jeng, teng = engines(name, w, quant="int4")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, teng.args.vocab_size, size=n).tolist() for n in (4, 7)]

    def run(BE, eng, ps, capacity=2):
        be = BE(eng, capacity=capacity, kv_quant="int8",
                **(dict(paged=True, page_size=8) if paged else {}))
        reqs = []
        for p in ps:
            reqs.append(be.submit(p, 8, stop_ids=()))
            be.step(quantum)
        while be.num_active or be._queue:
            be.step(quantum)
        return [r.generated for r in reqs]

    got = run(BatchEngine, teng, prompts)
    assert got == run(JBatchEngine, jeng, prompts)
    for p, g in zip(prompts, got):
        assert [g] == run(BatchEngine, teng, [p], capacity=1)


# ---------------------------------------------------------------------------
# quantized checkpoints, across the packages
# ---------------------------------------------------------------------------

def jax_host_tree(jeng):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else np.asarray(v)) for k, v in jeng.params.items()}


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("case", ["int4", "int4-bf16", "mixed"])
def test_jax_checkpoint_boots_in_port_and_back(tmp_path, name, case):
    """A quantized tree written by the JAX package boots in the port
    (`Llama.from_quantized`), and the port's own file of the same tree
    boots in the JAX package: the same leaves (int4 codes by value, bf16
    norms bit for bit) and equal streams."""
    jargs = jpreset(name, attn_impl="xla", **SPLIT, quant="int4",
                    **(dict(dtype="bfloat16") if case == "int4-bf16" else {}))
    targs = tpreset(name, **SPLIT, quant="int4", dtype=jargs.dtype)
    w = grid4_weights(jargs, 9)
    if case == "mixed":
        tree = jckpt.quantize_param_tree(jckpt.build_param_tree(w, jargs),
                                         bits=4, head_bits=8)
        jtree, rope_split = host(tree), False
    else:
        jtree, rope_split = jax_host_tree(JLlama(w, jargs)), True
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_quantized_npz(jtree, jpath, rope_split=rope_split)
    port = Llama.from_quantized(jpath, targs, device="cpu")
    assert port.cfg.rope_split == rope_split and not port.cfg.fused
    assert port.params["layers"]["wq"].dtype == torch.uint8
    if case == "int4-bf16":
        assert port.params["norm"].dtype == torch.bfloat16
        assert torch.equal(port.params["norm"].view(torch.int16),
                           torch.from_numpy(jtree["norm"].view(np.int16)))
    tckpt.save_quantized_npz(port.params, tpath, rope_split=rope_split)
    back, rs = jckpt.load_quantized_npz(tpath)
    want, _ = jckpt.load_quantized_npz(jpath)
    assert rs == rope_split
    for (k, a), (k2, b) in zip(sorted(tckpt._flat_items(back)), sorted(tckpt._flat_items(want))):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8) if a.dtype.kind == "V"
                                      else a, np.asarray(b).view(np.uint8)
                                      if b.dtype.kind == "V" else b, err_msg=k)
    jeng = JLlama.from_quantized(jpath, jargs)
    jback = JLlama.from_quantized(tpath, jargs)
    ids = prompt(targs, 5, seed=6)
    n = 8
    s_port = stream(port, ids, n)
    assert s_port == stream(jback, ids.astype(np.int32), n) == \
        stream(jeng, ids.astype(np.int32), n)
    if case == "mixed":  # the mixed tree boots and generates the same twice
        assert port.params["lm_head"].dtype == torch.int8
        assert stream(port, ids, n) == s_port


def test_port_checkpoint_roundtrip_keeps_tensors(tmp_path):
    """save_quantized_npz of an engine's device tree, then from_quantized:
    the same leaves, the same stream, and the file holds one byte a value
    for int4 (the JAX layout), so its int4 bytes are twice the packed."""
    args = tpreset("test-tiny", **SPLIT, quant="int4")
    eng = Llama(grid4_weights(jpreset("test-tiny"), 2), args, device="cpu")
    path = str(tmp_path / "q.npz")
    tckpt.save_quantized_npz(eng.params, path)
    booted = Llama.from_quantized(path, args, device="cpu")
    for (k, a), (_, b) in zip(sorted(tckpt._flat_items(eng.params)),
                              sorted(tckpt._flat_items(booted.params))):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    raw = np.load(path)
    assert raw["layers.wq"].dtype == np.int8 and raw["layers.wq"].min() >= 0
    assert raw["layers.wq"].nbytes == 2 * eng.params["layers"]["wq"].numel()
    ids = prompt(args, 4)
    assert stream(booted, ids, 8) == stream(eng, ids, 8)


# ---------------------------------------------------------------------------
# params_from_jax on split and int4 trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("quant", [None, "int4"])
def test_params_from_jax_split_and_int4(name, quant):
    w = grid4_weights(jpreset(name), 12)
    jeng, teng = engines(name, w, quant=quant)
    got = params_from_jax(jax_host_tree(jeng), "cpu")
    for (k, a), (_, b) in zip(sorted(tckpt._flat_items(got)),
                              sorted(tckpt._flat_items(teng.params))):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    ids = prompt(teng.args, 5, seed=7)
    out, _ = tllama.forward(got, torch.as_tensor(ids), 0, teng.init_cache(1), teng.cos,
                            teng.sin, teng.cfg, first_chunk=True)
    assert_logits_match(out.numpy(), np.asarray(jeng(ids.astype(np.int32), 0)))


# ---------------------------------------------------------------------------
# the CLI and the server
# ---------------------------------------------------------------------------

def test_cli_quant_int4_raises_as_jax(tmp_path):
    """`--quant int4` on the fused default layout raises the engine's
    "unfused" ValueError, as the JAX CLI does."""
    from llama3np_tpu_torch.cli import main

    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    tokens += [f"<{i}>" for i in range(512 - len(tokens))]
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({"tokens": tokens, "scores": [0.0] * 512}))
    with pytest.raises(ValueError, match="unfused"):
        main(["--synthetic", "--preset", "test-tiny", "--tokenizer", str(vocab),
              "--device", "cpu", "--quant", "int4", "abc"])


def test_server_quant_int4_serves_the_split_engine():
    """`python -m llama3np_tpu_torch.server --quant int4` sets
    fuse_matmuls=False, as the JAX server does, and answers as the int4
    split engine computes."""
    import http.client

    args = tpreset("test-tiny", quant="int4", **SPLIT)
    eng = Llama(jsynth(jpreset("test-tiny"), seed=0), args, device="cpu")
    want = eng.generate_tokens(np.array([[1, 4, 5, 6]]), 7)[0].tolist()
    proc = subprocess.Popen(
        [sys.executable, "-m", "llama3np_tpu_torch.server", "--preset", "test-tiny",
         "--synthetic", "--device", "cpu", "--port", "0", "--paged", "--no-tokenizer",
         "--quant", "int4", "--quantum", "3"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt_ids": [1, 4, 5, 6], "max_tokens": 7, "stop_ids": []}))
        out = json.loads(c.getresponse().read())
        c.close()
        assert out["choices"][0]["token_ids"] == want
    finally:
        proc.kill()
        proc.communicate(timeout=60)


def test_config_accepts_int4():
    assert dataclasses.asdict(tpreset("test-tiny", quant="int4", **SPLIT)) == \
        dataclasses.asdict(jpreset("test-tiny", quant="int4", **SPLIT))
