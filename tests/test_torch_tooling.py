"""The port's host tooling on the CPU against the JAX package: checkpoint
converters and loaders, the tokenizer converter, generation state, the
debug tensor-stats traces, the profiler trace, the numerics checks, the
run log and the CLI's flags.

Every file is written by the test (a llama2.c `.bin`, an HF directory as
`pytorch_model.bin` and as `.safetensors` written by a few-line writer
here, `config.json`, a llama2.c tokenizer); nothing is downloaded.  The
converters' outputs are equal arrays and equal `ModelArgs` fields; debug
traces have the same line names with values within fp32's rtol 2e-4 /
atol 1e-4 and the same tokens.
"""

import dataclasses
import json
import re
import struct
import sys

import numpy as np
import pytest
import torch

import llama3np_tpu as J
import llama3np_tpu_torch as T
from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import observability as jobs
from llama3np_tpu import tokenizer as jtok
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import observability as tobs
from llama3np_tpu_torch import tokenizer as ttok
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.ops.kernels import decode_step

torch.set_num_threads(1)

TINY = "test-tiny"


def weights(seed=3, name=TINY):
    return J.synthetic_weights(J.preset(name), seed=seed)


def assert_same_weights(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def assert_same_args(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def stream(eng, ids, n=8):
    return np.asarray(eng.generate_tokens(ids, n).cpu() if isinstance(
        eng, Llama) else eng.generate_tokens(ids, n))[0].tolist()


IDS = np.array([[1, 17, 99, 5, 203]], np.int32)


# ---------------------------------------------------------------------------
# loaders and llama2.c
# ---------------------------------------------------------------------------

def test_load_param_tree_and_infer_args_match_jax(tmp_path):
    path = str(tmp_path / "m.npz")
    T.save_npz(weights(), path)
    jt, tt = J.load_param_tree(path, J.preset(TINY)), T.load_param_tree(path, T.preset(TINY))
    for k in ("tok_embedding", "norm", "lm_head"):
        np.testing.assert_array_equal(tt[k], jt[k])
    for k, v in jt["layers"].items():
        np.testing.assert_array_equal(tt["layers"][k], v)
    bf = T.load_param_tree(path, T.preset(TINY), dtype="bfloat16")
    assert bf["lm_head"].dtype == torch.bfloat16
    w = T.load_parameters(path)
    assert_same_args(tckpt.infer_args_from_weights(w, T.preset(TINY)),
                     jckpt.infer_args_from_weights(w, J.preset(TINY)))
    assert_same_args(tckpt.infer_args_from_weights(w, n_heads=2),
                     jckpt.infer_args_from_weights(w, n_heads=2))
    with pytest.raises(ValueError) as te:
        tckpt.infer_args_from_weights(w)
    with pytest.raises(ValueError) as je:
        jckpt.infer_args_from_weights(w)
    assert str(te.value) == str(je.value)


def test_param_tree_to_weights_matches_jax():
    args = J.preset(TINY)
    w = weights()
    jtree = jckpt.build_param_tree(w, args)
    ttree = tckpt.params_to_device(tckpt.build_param_tree(w, T.preset(TINY)), "cpu")
    got = tckpt.param_tree_to_weights(ttree, T.preset(TINY))
    assert_same_weights(got, jckpt.param_tree_to_weights(jtree, args))
    assert_same_weights(got, w)
    fused = tckpt.fuse_param_tree(tckpt.build_param_tree(w, T.preset(TINY)))
    with pytest.raises(ValueError) as te:
        tckpt.param_tree_to_weights(fused, T.preset(TINY))
    with pytest.raises(ValueError) as je:
        jckpt.param_tree_to_weights(jckpt.fuse_param_tree(jtree), args)
    assert str(te.value) == str(je.value)


def write_llama2c_bin(path, w, args, shared: bool):
    """A llama2.c v0 export of HF-schema weights `w`."""
    L = args.n_layers

    def stack(fmt):
        return np.stack([w[fmt.format(i=i)] for i in range(L)])

    p = "model.layers.{i}."
    parts = [w["model.embed_tokens.weight"], stack(p + "input_layernorm.weight"),
             stack(p + "self_attn.q_proj.weight"), stack(p + "self_attn.k_proj.weight"),
             stack(p + "self_attn.v_proj.weight"), stack(p + "self_attn.o_proj.weight"),
             stack(p + "post_attention_layernorm.weight"), stack(p + "mlp.gate_proj.weight"),
             stack(p + "mlp.down_proj.weight"), stack(p + "mlp.up_proj.weight"),
             w["model.norm.weight"],
             np.zeros(2 * args.max_seq_len * args.head_dim // 2, np.float32)]
    if not shared:
        parts.append(w["lm_head.weight"])
    vocab = args.vocab_size if shared else -args.vocab_size
    with open(path, "wb") as f:
        np.array([args.dim, args.hidden_dim, L, args.n_heads, args.kv_heads, vocab,
                  args.max_seq_len], np.int32).tofile(f)
        for a in parts:
            np.asarray(a, np.float32).tofile(f)


@pytest.mark.parametrize("shared", [True, False])
def test_convert_llama2c_bin_matches_jax_and_boots(tmp_path, shared):
    args = T.preset(TINY)
    w = weights()
    if shared:
        w["lm_head.weight"] = w["model.embed_tokens.weight"]
    path = str(tmp_path / "m.bin")
    write_llama2c_bin(path, w, args, shared)
    tw, targs = tckpt.convert_llama2c_bin(path, str(tmp_path / "t.npz"))
    jw, jargs = jckpt.convert_llama2c_bin(path)
    assert_same_weights(tw, jw)
    assert_same_args(targs, jargs)
    assert_same_weights(T.load_parameters(str(tmp_path / "t.npz")), jw)
    booted = Llama(tw, targs.replace(max_seq_len=args.max_seq_len), device="cpu")
    assert stream(booted, IDS) == stream(Llama(w, args, device="cpu"), IDS)


# ---------------------------------------------------------------------------
# HuggingFace directories
# ---------------------------------------------------------------------------

def hf_layout(w, args):
    """HF-schema weights with q/k rows in HF's rotate-half layout (what
    `convert_hf_model` undoes)."""
    from llama3np_tpu_torch.ops.core import rope_split_permutation
    out = dict(w)
    q_perm = rope_split_permutation(args.n_heads, args.head_dim)
    k_perm = rope_split_permutation(args.kv_heads, args.head_dim)
    for key in w:
        if key.endswith("q_proj.weight"):
            out[key] = w[key][q_perm]
        elif key.endswith("k_proj.weight"):
            out[key] = w[key][k_perm]
    return out


def write_config(d, args, rope_scaling=None, torch_dtype="float32"):
    cfg = {"hidden_size": args.dim, "num_hidden_layers": args.n_layers,
           "num_attention_heads": args.n_heads, "num_key_value_heads": args.kv_heads,
           "vocab_size": args.vocab_size, "max_position_embeddings": args.max_seq_len,
           "rope_theta": args.rope_theta, "rms_norm_eps": args.norm_eps,
           "intermediate_size": args.hidden_dim, "torch_dtype": torch_dtype}
    if rope_scaling is not None:
        cfg["rope_scaling"] = rope_scaling
    (d / "config.json").write_text(json.dumps(cfg))


def write_safetensors(path, tensors):
    """A few-line .safetensors writer: 8-byte little-endian header length,
    JSON header, raw little-endian data."""
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, blobs, off = {}, [], 0
    for k, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("fmt", ["bin", "safetensors-f32", "safetensors-f16",
                                 "safetensors-bf16"])
def test_convert_hf_model_matches_jax(tmp_path, fmt):
    args = T.preset(TINY)
    w = weights()
    hf = {k: torch.from_numpy(v) for k, v in hf_layout(w, args).items()}
    d = tmp_path / "hf"
    d.mkdir()
    write_config(d, args)
    if fmt == "bin":
        torch.save(hf, d / "pytorch_model.bin")
    else:
        dt = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}[fmt[-3:].lstrip("-")]
        keys = sorted(hf)
        half = len(keys) // 2  # two shards, read in sorted order
        write_safetensors(d / "model-00001-of-00002.safetensors",
                          {k: hf[k].to(dt) for k in keys[:half]})
        write_safetensors(d / "model-00002-of-00002.safetensors",
                          {k: hf[k].to(dt) for k in keys[half:]})
    got = tckpt.convert_hf_model(str(d), str(tmp_path / "t.npz"))
    want = jckpt.convert_hf_model(str(d))
    assert_same_weights(got, want)
    if fmt in ("bin", "safetensors-f32"):
        assert_same_weights(got, w)  # the rotate-half layout undone
    booted = Llama(got, args, device="cpu")
    assert stream(booted, IDS) == stream(JLlama(want, J.preset(TINY)), IDS)
    with pytest.raises(FileNotFoundError):
        (d / "config.json").unlink()
        tckpt.convert_hf_model(str(d))


@pytest.mark.parametrize("scaling", [None, "llama3", "linear"])
def test_args_from_hf_config_matches_jax(tmp_path, scaling):
    args = T.preset("llama3-8b")
    rs = None if scaling is None else {"rope_type": scaling, "factor": 8.0,
                                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                        "original_max_position_embeddings": 8192}
    write_config(tmp_path, args, rs, torch_dtype="bfloat16")
    if scaling == "linear":
        with pytest.raises(ValueError) as te:
            tckpt.args_from_hf_config(str(tmp_path))
        with pytest.raises(ValueError) as je:
            jckpt.args_from_hf_config(str(tmp_path))
        assert str(te.value) == str(je.value)
        return
    got = tckpt.args_from_hf_config(str(tmp_path), max_seq_len=4096)
    assert_same_args(got, jckpt.args_from_hf_config(str(tmp_path), max_seq_len=4096))
    assert got.dtype == "bfloat16" and (got.rope_scaling is None) == (scaling is None)


def test_convert_llama2c_tokenizer_matches_jax(tmp_path):
    pieces = [b"<unk>", b"<s>", b"</s>", b" the", "été".encode(), b"\x80", b"\xff",
              b"a"]
    path = tmp_path / "tokenizer.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 8))
        for i, p in enumerate(pieces):
            f.write(struct.pack("<fi", -float(i) / 2, len(p)) + p)
    got = ttok.convert_llama2c_tokenizer(str(path), str(tmp_path / "t.json"))
    want = jtok.convert_llama2c_tokenizer(str(path), str(tmp_path / "j.json"))
    assert open(got, "rb").read() == open(want, "rb").read()
    tok = json.loads(open(got, encoding="utf-8").read())
    assert tok["tokens"][5] == "\u0080" and tok["tokens"][6] == "ÿ"
    assert ttok.Tokenizer(got, backend="python").vocab_size == len(pieces)


# ---------------------------------------------------------------------------
# generation state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generation_state_crosses_packages(tmp_path, dtype):
    """A state saved by the JAX engine resumes in the port (and the port's
    own state, first + rest, equals the uninterrupted stream); the port's
    file holds the JAX file's arrays (the same names, dtypes and shapes; a
    bf16 cache as the same 2-byte payload; the rows before the saved
    position within the dtype's tolerance, position and tokens equal).  A
    float32 state saved by the port resumes in the JAX engine; a bf16 one
    cannot, as the JAX engine cannot resume its own (`jnp.asarray` refuses
    the 2-byte void array numpy stores for an ml_dtypes bfloat16)."""
    w = weights(seed=5)
    jeng = JLlama(w, J.preset(TINY, dtype=dtype))
    teng = Llama(w, T.preset(TINY, dtype=dtype), device="cpu")
    full = stream(teng, IDS, 10)
    assert full == stream(jeng, IDS, 10)
    first = stream(teng, IDS, 4)
    jeng.generate_tokens(IDS, 4)
    jeng.save_generation_state(str(tmp_path / "j.npz"))
    teng.save_generation_state(str(tmp_path / "t.npz"))
    js, ts = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(js.files) == sorted(ts.files) == ["cache_k", "cache_v", "last_tokens", "pos"]
    for k in js.files:
        assert js[k].dtype == ts[k].dtype and js[k].shape == ts[k].shape, k
    for k in ("pos", "last_tokens"):
        np.testing.assert_array_equal(ts[k], js[k])
    pos = int(ts["pos"])  # rows past it are scratch (the JAX loop runs whole segments)
    for k in ("cache_k", "cache_v"):  # bf16: the 2-byte payloads, as bits
        a, b = (torch.from_numpy(np.ascontiguousarray(z[k]).view(np.int16)).view(
            torch.bfloat16).float() if dtype == "bfloat16" else torch.from_numpy(z[k])
            for z in (ts, js))
        a, b = a[..., :pos, :], b[..., :pos, :]
        torch.testing.assert_close(a, b, rtol=2e-4 if dtype == "float32" else 1e-2,
                                   atol=1e-4 if dtype == "float32" else 1e-2)
    rest = Llama(w, T.preset(TINY, dtype=dtype), device="cpu").resume_generate(
        str(tmp_path / "j.npz"), 6)
    assert first + rest[0].tolist() == full
    assert first + teng.resume_generate(str(tmp_path / "t.npz"), 6)[0].tolist() == full
    if dtype == "float32":
        back = JLlama(w, J.preset(TINY)).resume_generate(str(tmp_path / "t.npz"), 6)
        assert first + np.asarray(back)[0].tolist() == full
    else:
        with pytest.raises(TypeError):
            JLlama(w, J.preset(TINY, dtype=dtype)).resume_generate(str(tmp_path / "j.npz"), 6)


def test_resume_runs_the_decode_step_over_a_restored_cache(tmp_path):
    """float32 over a bf16 cache, on the kernel path (the wrappers' plain
    versions on the CPU): the resumed tokens come through the decode step,
    and first + rest equals the uninterrupted stream."""
    args = T.preset(TINY, kv_dtype="bfloat16")
    eng = Llama(weights(seed=5), args, device="cpu")
    eng.cfg = eng.cfg._replace(kernels=True)
    full = stream(eng, IDS, 9)
    first = stream(eng, IDS, 3)
    eng.save_generation_state(str(tmp_path / "s.npz"))
    eng.reset()
    calls = []
    real = decode_step.decode_layers_plain
    decode_step.decode_layers_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        rest = eng.resume_generate(str(tmp_path / "s.npz"), 6)[0].tolist()
    finally:
        decode_step.decode_layers_plain = real
    assert len(calls) == 6 and eng.cache["k"].dtype == torch.bfloat16
    assert first + rest == full
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.resume_generate(str(tmp_path / "s.npz"), args.max_seq_len)
    with pytest.raises(ValueError, match="no generation"):
        Llama(weights(seed=5), args, device="cpu").save_generation_state(
            str(tmp_path / "x.npz"))


# ---------------------------------------------------------------------------
# debug traces, profiler, numerics checks, run log
# ---------------------------------------------------------------------------

STAT = re.compile(r"^(\w+): dtype=(\w+), shape=(\([0-9, ]*\)), min=(\S+), max=(\S+), "
                  r"mean=(\S+)$")


def assert_same_trace(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        mg, mw = STAT.match(g), STAT.match(w)
        assert (mg is None) == (mw is None), (g, w)
        if mg is None:
            assert g == w
            continue
        assert mg.groups()[:3] == mw.groups()[:3], (g, w)
        np.testing.assert_allclose([float(x) for x in mg.groups()[3:]],
                                   [float(x) for x in mw.groups()[3:]],
                                   rtol=2e-4, atol=1e-4, err_msg=g)


@pytest.mark.parametrize("name", [TINY, "test-tiny-mha"])
def test_debug_traces_match_jax(name):
    w = weights(seed=7, name=name)
    jeng, teng = JLlama(w, J.preset(name)), Llama(w, T.preset(name), device="cpu")
    got, want = [], []
    tl = tobs.debug_trace_forward(teng, IDS, 0, emit=got.append)
    jl = jobs.debug_trace_forward(jeng, IDS, 0, emit=want.append)
    assert got[0].startswith("input_ids:") and got[-1].startswith("logits:")
    assert_same_trace(got, want)
    np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=1e-4)
    got, want = [], []
    toks = tobs.debug_trace_generate(teng, IDS, 5, emit=got.append)
    jtoks = jobs.debug_trace_generate(jeng, IDS, 5, emit=want.append)
    assert_same_trace(got, want)
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert toks[0].tolist() == stream(teng, IDS, 5)


def test_trace_writes_a_chrome_trace(tmp_path):
    eng = Llama(weights(), T.preset(TINY), device="cpu")
    with tobs.trace(str(tmp_path / "tr")) as d:
        eng.generate_tokens(IDS, 3)
    assert d == str(tmp_path / "tr") and tobs.trace.last.startswith(d)
    events = json.loads(open(tobs.trace.last).read())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_debug_mode_raises_on_non_finite_logits():
    w = weights()
    w["model.norm.weight"] = w["model.norm.weight"].copy()
    w["model.norm.weight"][3] = np.nan
    eng = Llama(w, T.preset(TINY), device="cpu")
    eng.generate_tokens(IDS, 2)  # outside the context nothing is checked
    with tobs.debug_mode():
        with pytest.raises(FloatingPointError, match="logits"):
            eng.generate_tokens(IDS, 2)
    assert tobs._DEBUG == {"nans": False, "checks": False}
    good = Llama(weights(), T.preset(TINY), device="cpu")
    with tobs.debug_mode():
        assert len(stream(good, IDS, 3)) == 3


def test_run_log_and_debug_logger(tmp_path):
    log = tobs.RunLog(str(tmp_path / "runs" / "log.jsonl"))
    log.append({"a": 1})
    log.append({"b": 2})
    rows = [json.loads(x) for x in open(tmp_path / "runs" / "log.jsonl")]
    assert [r.get("a", r.get("b")) for r in rows] == [1, 2] and "ts" in rows[0]
    logger = tobs.make_debug_logger(str(tmp_path / "dbg"))
    assert tobs.make_debug_logger(str(tmp_path / "dbg")) is logger
    logger.debug("hello")
    logger.handlers[0].flush()
    files = list((tmp_path / "dbg").iterdir())
    assert len(files) == 1 and "hello" in files[0].read_text()


# ---------------------------------------------------------------------------
# the CLI, precision, exports
# ---------------------------------------------------------------------------

def test_cli_flags_match_jax_cli(tmp_path, capsys):
    from llama3np_tpu.cli import main as jax_main
    from llama3np_tpu_torch.cli import main as port_main
    from tests.test_torch_host import write_vocab

    vocab = write_vocab(tmp_path / "vocab.json", 512)
    argv = ["--synthetic", "--preset", TINY, "--tokenizer", vocab, "--max-new-tokens",
            "6", "--debug-stats", "--debug-tokens", "2", "--precision", "highest",
            "abc dd eee"]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    port = argv + ["--device", "cpu", "--trace", str(tmp_path / "tr"),
                   "--debug-log-dir", str(tmp_path / "dbg"),
                   "--run-log", str(tmp_path / "run.jsonl")]
    assert port_main(port) == 0
    got = capsys.readouterr()
    stats = [ln for ln in got.err.splitlines() if STAT.match(ln) or ln.startswith("===")]
    assert_same_trace(stats, [ln for ln in want.err.splitlines()
                              if STAT.match(ln) or ln.startswith("===")])
    assert got.out.split("Token count")[0] == want.out.split("Token count")[0]
    run = json.loads(open(tmp_path / "run.jsonl").read())
    assert run["preset"] == TINY and run["generated_tokens"] == 6
    assert list((tmp_path / "tr").glob("trace_*.json"))
    log = next((tmp_path / "dbg").iterdir()).read_text()
    assert "=== decode token 1" in log and "logits: dtype=float32" in log


def test_precision_values():
    w = weights()
    logits = {p: Llama(w, T.preset(TINY), device="cpu", precision=p)(IDS, 0)
              for p in (None, "default", "highest")}
    assert all(np.array_equal(v, logits[None]) for v in logits.values())
    with pytest.raises(ValueError, match="precision"):
        Llama(w, T.preset(TINY), device="cpu", precision="tf32")


def test_exports_match_the_jax_package():
    for name in J.__all__:
        assert getattr(T, name) is not None, name
    assert T.BatchEngine.__module__ == "llama3np_tpu_torch.serving"
    assert T.StaticConfig._fields[:4] == ("n_heads", "kv_heads", "head_dim", "norm_eps")


def test_tooling_runs_without_jax_ml_dtypes_or_safetensors(tmp_path):
    """A bf16 safetensors directory converts and boots, and a bf16 cache's
    generation state saves and resumes, in a fresh interpreter with jax,
    the JAX package, ml_dtypes and safetensors unimportable (the card's
    machine has none of the last two)."""
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    args = T.preset(TINY)
    hf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in hf_layout(weights(), args).items()}
    d = tmp_path / "hf"
    d.mkdir()
    write_config(d, args, torch_dtype="bfloat16")
    write_safetensors(d / "model.safetensors", hf)
    code = f"""
import sys
for name in ('jax', 'jaxlib', 'llama3np_tpu', 'ml_dtypes', 'safetensors'):
    sys.modules[name] = None
import numpy as np
from llama3np_tpu_torch import Llama
from llama3np_tpu_torch.checkpoint import args_from_hf_config, convert_hf_model
d = {str(d)!r}
args = args_from_hf_config(d, kv_dtype='bfloat16')
eng = Llama(convert_hf_model(d), args, device='cpu')
ids = np.array([[1, 5, 9, 14]])
full = eng.generate_tokens(ids, 8)[0].tolist()
first = eng.generate_tokens(ids, 3)[0].tolist()
eng.save_generation_state({str(tmp_path / 's.npz')!r})
rest = Llama(convert_hf_model(d), args, device='cpu').resume_generate(
    {str(tmp_path / 's.npz')!r}, 5)[0].tolist()
assert first + rest == full, (first, rest, full)
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
