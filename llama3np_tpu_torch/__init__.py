"""llama3np_tpu_torch: the PyTorch + CUDA port of `llama3np_tpu`.

A second package beside the JAX one, with the same module names and the
reference's public surface: `ModelArgs`, `Tokenizer`, `load_parameters`,
`Llama(model_path, args)`, `model(ids, start_pos)`, `model.generate(...)`
and the `python -m llama3np_tpu_torch.cli "prompt"` entry point, and the
continuous-batching engine `serving.BatchEngine` over the dense or paged
KV cache, in float32 or bf16 (the Llama-3 presets, llama3-8b among them),
with int8 weights (`quant="int8"`) and int8 KV (`kv_quant="int8"`).  The
kernels of these paths (flash prefill attention, the fused batch-1 decode
step, the greedy lm_head + argmax and paged decode attention, each in
float32 and bf16, the decode step and paged attention also int8) are
hand-written CUDA for Hopper (`csrc/`), built at first use.  Entry points
run on the card unless the caller asks for the CPU.

The port imports torch and numpy, never jax or the JAX package;
`params_from_jax` takes the JAX package's parameter tree as numpy arrays.
"""

from .checkpoint import (build_param_tree, load_parameters, params_from_jax,
                         quantize_param_tree, save_npz, synthetic_weights)
from .config import PRESETS, ModelArgs, preset
from .kvcache import init_cache
from .models.llama import Llama
from .ops.kernels.greedy_head import argmax_head
from .reference_numpy import NumpyLlama
from .tokenizer import Tokenizer

__version__ = "0.1.0"

__all__ = [
    "ModelArgs", "PRESETS", "preset", "Tokenizer",
    "load_parameters", "build_param_tree", "quantize_param_tree",
    "synthetic_weights", "save_npz",
    "init_cache", "Llama", "NumpyLlama", "params_from_jax", "argmax_head",
]
