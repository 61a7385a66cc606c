"""Host-side parity of the port: config, tokenizer, checkpoint, cache and
CLI against the JAX package; the port's import boundary; and its refusal to
run without a card unless asked for the CPU."""

import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import llama3np_tpu as J
import llama3np_tpu_torch as T
from llama3np_tpu import checkpoint as jckpt
from llama3np_tpu import kvcache as jkv
from llama3np_tpu import tokenizer as jtok
from llama3np_tpu_torch import checkpoint as tckpt
from llama3np_tpu_torch import kvcache as tkv
from llama3np_tpu_torch import tokenizer as ttok

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "llama3np_tpu_torch"


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_model_args_defaults_equal():
    assert dataclasses.asdict(T.ModelArgs()) == dataclasses.asdict(J.ModelArgs())
    assert [f.name for f in dataclasses.fields(T.ModelArgs)] == \
        [f.name for f in dataclasses.fields(J.ModelArgs)]


@pytest.mark.parametrize("name", sorted(J.PRESETS))
def test_presets_equal_field_for_field(name):
    assert T.PRESETS[name] == J.PRESETS[name]
    t, j = T.preset(name), J.preset(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.kv_heads, t.n_rep) == (j.head_dim, j.kv_heads, j.n_rep)


def test_preset_set_and_overrides():
    assert sorted(T.PRESETS) == sorted(J.PRESETS)
    kw = dict(max_seq_len=1024, attn_impl="xla", dtype="bfloat16")
    assert dataclasses.asdict(T.preset("stories15M", **kw)) == \
        dataclasses.asdict(J.preset("stories15M", **kw))
    with pytest.raises(KeyError):
        T.preset("no-such-model")
    with pytest.raises(ValueError):
        T.ModelArgs(dim=64, n_heads=5).validate()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def write_vocab(path, size, seed=0):
    """A synthetic tokenizer model: markers, printable ASCII, then random
    multi-character pieces with random scores."""
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    seen = set(tokens)
    letters = list("abcdefghijklmnop ")
    while len(tokens) < size:
        piece = "".join(rng.choice(letters, size=int(rng.integers(2, 5))))
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
    scores = [0.0, 0.0, 0.0] + np.round(-rng.random(size - 3) * 10, 3).tolist()
    path.write_text(json.dumps({"tokens": tokens, "scores": scores}))
    return str(path)


TEXTS = ["I have a dream", "", "abc", "a b c dd eee", "hello, world!",
         "unknown ☃ chars dropped", "abab" * 40, "  leading and trailing  "]


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("size", [200, 2000])
def test_tokenizer_matches_jax(tmp_path, backend, size):
    if backend == "native":
        from llama3np_tpu_torch.native import native_available
        if not native_available():
            pytest.skip("no C++ compiler for the native BPE core")
    path = write_vocab(tmp_path / "vocab.json", size, seed=size)
    t = ttok.Tokenizer(path, backend=backend)
    j = jtok.Tokenizer(path, backend="python")
    for text in TEXTS:
        for bos, eos in [(True, False), (False, True)]:
            assert t.encode(text, bos, eos) == j.encode(text, bos, eos), text
        ids = t.encode(text, add_bos=False)
        assert t.decode(ids) == j.decode(ids)
    assert t.encode_batch(TEXTS) == j.encode_batch(TEXTS)
    assert t.vocab_size == j.vocab_size == size
    assert t.str_lookup("ab") == j.str_lookup("ab")


def test_tokenizer_quirks(tmp_path):
    tokens = ["<unk>", "<s>", "</s>", "a", "b", "c", "ab", "bc", "abc", "s", ">"]
    scores = [0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -5.0, -4.0, -2.0, -1.0, -1.0]
    path = tmp_path / "tok.json"
    path.write_text(json.dumps({"tokens": tokens, "scores": scores}))
    t = ttok.Tokenizer(str(path), backend="python")
    assert t.encode("abc", add_bos=False) == [8]  # a + bc -> abc
    # Quirk Q3: the character set {<, s, /, >} is stripped from both ends.
    assert t.decode([9, 3, 10]) == "a"
    assert ttok.Tokenizer(str(path), fix_decode=True).decode([1, 3]) == "a"


def test_native_build_dir_is_the_ports_own():
    from llama3np_tpu.native import _LIB_CACHE as jax_cache
    from llama3np_tpu_torch.native import _LIB_CACHE as port_cache
    assert port_cache != jax_cache
    assert Path(port_cache) == REPO / "build" / "torch_native"


# ---------------------------------------------------------------------------
# checkpoint and cache
# ---------------------------------------------------------------------------

def test_checkpoint_trees_match_jax(tmp_path):
    args = J.preset("test-tiny")
    w = J.synthetic_weights(args, seed=3)
    tw = T.synthetic_weights(T.preset("test-tiny"), seed=3)
    assert w.keys() == tw.keys()
    assert all(np.array_equal(w[k], tw[k]) for k in w)
    path = str(tmp_path / "m.npz")
    T.save_npz(tw, path)
    loaded = T.load_parameters(path)
    jtree = jckpt.fuse_param_tree(jckpt.permute_rope_layout(
        jckpt.build_param_tree(w, args), args))
    ttree = tckpt.fuse_param_tree(tckpt.permute_rope_layout(
        tckpt.build_param_tree(loaded, T.preset("test-tiny")), args))
    for k in ("tok_embedding", "norm", "lm_head"):
        np.testing.assert_array_equal(ttree[k], jtree[k])
    for k, v in jtree["layers"].items():
        np.testing.assert_array_equal(ttree["layers"][k], v)


def test_engine_loads_from_a_checkpoint_path(tmp_path, rng):
    path = str(tmp_path / "tiny.npz")
    tckpt.write_synthetic_checkpoint(path, T.preset("test-tiny"), seed=4)
    ids = rng.integers(3, 512, size=(1, 4)).astype(np.int32)
    a = T.Llama(path, T.preset("test-tiny"), device="cpu")(ids, 0)
    b = T.Llama(T.synthetic_weights(T.preset("test-tiny"), 4),
                T.preset("test-tiny"), device="cpu")(ids, 0)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_init_cache_layout(dtype):
    args = T.preset("test-tiny")
    cache = tkv.init_cache(args, batch_size=3, dtype=dtype, device="cpu")
    jcache = jkv.init_cache(J.preset("test-tiny"), batch_size=3, dtype=dtype)
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    assert cache["k"].dtype == tckpt.torch_dtype(dtype or "float32")
    assert not cache["k"].any() and not cache["v"].any()
    assert tkv.cache_nbytes(args, 3) == jkv.cache_nbytes(J.preset("test-tiny"), 3)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _strip_times(text):
    return re.sub(r"elapsed: [0-9.]+s, [0-9]+ tokens/s", "elapsed: <t>", text)


@pytest.mark.parametrize("extra", [[], ["--no-stream", "--fixed-decode"]])
def test_cli_text_matches_jax_cli(tmp_path, capsys, extra):
    from llama3np_tpu.cli import main as jax_main
    from llama3np_tpu_torch.cli import main as port_main

    vocab = write_vocab(tmp_path / "vocab.json", 512)
    argv = ["--synthetic", "--preset", "test-tiny", "--tokenizer", vocab,
            "--max-new-tokens", "10", "--stats-json", *extra, "abc dd eee"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    # Same streamed text and Token count; the timings and stats differ.
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert _strip_times("\n".join(got_lines[:-1])) == _strip_times("\n".join(want_lines[:-1]))
    assert "Token count:" in got
    stats = json.loads(got_lines[-1])
    assert stats["generated_tokens"] == 10 and stats["prompt_tokens"] > 1


def test_cli_defaults_to_the_card():
    from llama3np_tpu_torch.cli import build_parser
    assert build_parser().parse_args([]).device == "cuda"


# ---------------------------------------------------------------------------
# import boundary and the chip smoke without a card
# ---------------------------------------------------------------------------

def _imported_modules(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    # The rank functions of the multi-process tests too: spawned ranks
    # import that module.
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tests" / "torch_parallel_workers.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "llama3np_tpu", "ml_dtypes", "safetensors",
                            "optax"), \
            f"{path.relative_to(REPO)} imports {mod}"


def test_port_modules_import_without_jax():
    """Import every module of the port (lora, train, eval and data among
    them) in a fresh interpreter with jax, the JAX package, optax,
    ml_dtypes and safetensors (which the card's machine lacks) made
    unimportable."""
    mods = sorted({".".join(p.relative_to(REPO).with_suffix("").parts)
                   .removesuffix(".__init__") for p in PORT.rglob("*.py")})
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'llama3np_tpu', 'ml_dtypes', 'safetensors',\n"
            "             'optax'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert {'llama3np_tpu_torch.lora', 'llama3np_tpu_torch.train',\n"
            "        'llama3np_tpu_torch.eval', 'llama3np_tpu_torch.data'} <= set(sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_int4_and_speculative_run_without_ml_dtypes(tmp_path):
    """int4 quantization, a quantized checkpoint's save and load, a bf16
    split engine and speculative decoding, run in a fresh interpreter with
    jax, the JAX package and ml_dtypes unimportable."""
    code = f"""
import sys
for name in ('jax', 'jaxlib', 'llama3np_tpu', 'ml_dtypes'):
    sys.modules[name] = None
import numpy as np
import torch
from llama3np_tpu_torch import (Llama, SpeculativeGenerator, preset,
                                quantized_draft, synthetic_weights)
from llama3np_tpu_torch.checkpoint import save_quantized_npz
args = preset('test-tiny', quant='int4', fuse_matmuls=False, dtype='bfloat16')
w = synthetic_weights(args, seed=0)
eng = Llama(w, args, device='cpu')
save_quantized_npz(eng.params, {str(tmp_path / 'q.npz')!r})
booted = Llama.from_quantized({str(tmp_path / 'q.npz')!r}, args, device='cpu')
ids = np.array([[1, 5, 9, 14]])
assert booted.generate_tokens(ids, 6).tolist() == eng.generate_tokens(ids, 6).tolist()
t_args = preset('test-tiny')
spec = SpeculativeGenerator(Llama(w, t_args, device='cpu'),
                            quantized_draft(w, t_args, device='cpu'))
assert spec.generate_tokens(ids, 9).shape == (1, 9)
assert 'ml_dtypes' not in sys.modules or sys.modules['ml_dtypes'] is None
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
