"""Model and runtime configuration.

`ModelArgs` is a field-for-field copy of `llama3np_tpu.config.ModelArgs`
(same names, same defaults, same presets), so one configuration means the
same model in both packages.  The port keeps its own copy because it never
imports the JAX package.

How the port reads the fields that select code paths:

* `attn_impl`: "auto" runs the hand-written CUDA kernels when the engine's
  device is CUDA and the plain PyTorch path on the CPU; "xla" runs the plain
  PyTorch path everywhere (the name is kept for parity with the JAX
  package, where it meant XLA-compiled jnp); "pallas" asks for the kernels
  and raises on the CPU.
* `pallas_ffn_block`, `pallas_attn_group`, `pallas_stream`,
  `decode_token_unroll` and `layer_unroll` are TPU planner knobs.  They stay
  as fields so that a `ModelArgs` compares equal across packages; the port
  does not read them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def ffn_hidden_dim(dim: int, multiple_of: int = 32, ffn_dim_multiplier: Optional[float] = None) -> int:
    """Llama FFN sizing rule: 2/3 * 4 * dim, optionally scaled, rounded up to a
    multiple of `multiple_of`.  stories15M: dim=288 -> 768."""
    hidden = int(2 * (4 * dim) / 3)
    if ffn_dim_multiplier is not None:
        hidden = int(ffn_dim_multiplier * hidden)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


@dataclass
class ModelArgs:
    # --- reference-compatible fields (defaults = stories15M) ---------------
    dim: int = 288  # D
    n_layers: int = 6
    n_heads: int = 6  # QHN; HD = dim // n_heads
    n_kv_heads: Optional[int] = None  # KVHN (None -> n_heads, i.e. MHA)
    vocab_size: int = 32000  # VS
    max_seq_len: int = 256  # M
    max_new_tokens: int = 150
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    max_batch_size: int = 1
    dtype: str = "float32"  # parameter/compute dtype: float32 | bfloat16 | float16

    # --- extensions (shared with the JAX package) --------------------------
    # Llama-3.1 long-context RoPE frequency remap (HF rope_type "llama3"):
    # {"factor", "low_freq_factor", "high_freq_factor",
    #  "original_max_position_embeddings"}.  None = unscaled.
    rope_scaling: Optional[dict] = None
    hidden_dim: Optional[int] = None  # FFN dim; None -> ffn_hidden_dim(dim)
    multiple_of: int = 32
    ffn_dim_multiplier: Optional[float] = None
    tie_word_embeddings: bool = False
    # KV cache dtype (defaults to `dtype`); fp32 keeps greedy parity.
    kv_dtype: Optional[str] = None
    # Mesh axes sizes (tensor/data parallelism: not ported yet).
    mesh_dp: int = 1
    mesh_tp: int = 1
    # Kernel selection: "auto", "xla" (plain PyTorch) or "pallas" (the
    # hand-written kernels); see the module docstring.
    attn_impl: str = "auto"
    # Fuse Q|K|V and gate|up into one weight each (the port runs only the
    # fused layout); layer_unroll is a TPU knob the port does not read.
    fuse_matmuls: bool = True
    layer_unroll: Optional[int] = None
    # Permute wq/wk columns at load so RoPE runs in split-halves layout
    # (exact transformation; the decode kernel expects it).
    rope_split_layout: bool = True
    # Blockwise (flash-semantics) prefill attention block size on the plain
    # path; prefills of >= 2 blocks accumulate over KV blocks instead of
    # materializing the dense score tensor.  0 disables.
    prefill_kv_block: int = 512
    # TPU planner knobs, kept for parity and not read by the port.
    decode_token_unroll: int = 1
    pallas_ffn_block: Optional[int] = None
    pallas_attn_group: bool = False
    pallas_stream: Optional[tuple] = None
    # Weight-only quantization: None or "int8" (per-output-channel scales);
    # "int4" needs the split-weight layout and is still to port.
    quant: Optional[str] = None
    # KV-cache quantization for the serving engine: None or "int8".
    kv_quant: Optional[str] = None
    # Prompt-length padding buckets for prefill (static shapes).
    prefill_buckets: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

    def __post_init__(self):
        if self.hidden_dim is None:
            self.hidden_dim = ffn_hidden_dim(self.dim, self.multiple_of, self.ffn_dim_multiplier)
        if self.kv_dtype is None:
            self.kv_dtype = self.dtype

    # Derived quantities --------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.kv_heads

    def validate(self) -> "ModelArgs":
        if self.dim % self.n_heads:
            raise ValueError(f"n_heads ({self.n_heads}) must divide dim ({self.dim})")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"kv_heads ({self.kv_heads}) must divide n_heads ({self.n_heads}) (GQA)")
        if self.quant == "int4":
            raise NotImplementedError("quant='int4' runs the split-weight layout, "
                                      "which is still to port (ROADMAP A5)")
        if self.quant not in (None, "int8"):
            raise ValueError(f"unsupported quant {self.quant!r}")
        if self.kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {self.kv_quant!r}")
        return self

    def replace(self, **kw) -> "ModelArgs":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets: the config ladder (stories15M ... llama3-70B), as in the JAX
# package.
# ---------------------------------------------------------------------------

PRESETS = {
    "stories15M": dict(
        dim=288, n_layers=6, n_heads=6, n_kv_heads=None, vocab_size=32000,
        max_seq_len=256, rope_theta=10000.0,
    ),
    "stories110M": dict(
        dim=768, n_layers=12, n_heads=12, n_kv_heads=None, vocab_size=32000,
        max_seq_len=1024, rope_theta=10000.0,
    ),
    "tinyllama-1.1b": dict(
        dim=2048, n_layers=22, n_heads=32, n_kv_heads=4, vocab_size=32000,
        max_seq_len=2048, hidden_dim=5632, rope_theta=10000.0, norm_eps=1e-5,
    ),
    # llama3.2 checkpoints ship with the llama3.1 rope remap (HF config
    # rope_scaling factor 32): it changes frequencies at ALL positions.
    "llama3.2-1b": dict(
        dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, vocab_size=128256,
        max_seq_len=8192, hidden_dim=8192, rope_theta=500000.0, norm_eps=1e-5,
        dtype="bfloat16", tie_word_embeddings=True,
        rope_scaling=dict(factor=32.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "llama3.2-3b": dict(
        dim=3072, n_layers=28, n_heads=24, n_kv_heads=8, vocab_size=128256,
        max_seq_len=8192, hidden_dim=8192, rope_theta=500000.0, norm_eps=1e-5,
        dtype="bfloat16", tie_word_embeddings=True,
        rope_scaling=dict(factor=32.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "llama3-8b": dict(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, vocab_size=128256,
        max_seq_len=8192, hidden_dim=14336, rope_theta=500000.0, norm_eps=1e-5,
        dtype="bfloat16",
    ),
    "llama3.1-8b": dict(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, vocab_size=128256,
        max_seq_len=16384, hidden_dim=14336, rope_theta=500000.0,
        norm_eps=1e-5, dtype="bfloat16",
        rope_scaling=dict(factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "llama3-70b": dict(
        dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, vocab_size=128256,
        max_seq_len=8192, hidden_dim=28672, rope_theta=500000.0, norm_eps=1e-5,
        dtype="bfloat16", mesh_tp=8,
    ),
    # Tiny configs for tests (synthetic checkpoints; no downloads).
    "test-tiny": dict(
        dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
        max_seq_len=64, max_new_tokens=16, hidden_dim=128,
    ),
    "test-tiny-mha": dict(
        dim=48, n_layers=2, n_heads=3, n_kv_heads=None, vocab_size=256,
        max_seq_len=32, max_new_tokens=8, hidden_dim=96,
    ),
}


def preset(name: str, **overrides) -> ModelArgs:
    """Build a `ModelArgs` from a named preset, with overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return ModelArgs(**kw).validate()
