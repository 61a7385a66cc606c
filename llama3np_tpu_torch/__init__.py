"""llama3np_tpu_torch: the PyTorch + CUDA port of `llama3np_tpu`.

A second package beside the JAX one, with the same module names and the
reference's public surface: `ModelArgs`, `Tokenizer`, `load_parameters`,
`Llama(model_path, args)`, `model(ids, start_pos)`, `model.generate(...)`
and the `python -m llama3np_tpu_torch.cli "prompt"` entry point, and the
continuous-batching engine `serving.BatchEngine` over the dense or paged
KV cache, in float32 or bf16 (the Llama-3 presets, llama3-8b among them),
with int8 or int4 weights (`quant="int8"`, `quant="int4"` on the split
layout of `fuse_matmuls=False`, quantized checkpoints in the JAX package's
format) and int8 KV (`kv_quant="int8"`), and greedy speculative decoding
(`SpeculativeGenerator`, with an int8 self-draft from `quantized_draft`),
a KV cache of another float dtype than the activations' (`kv_dtype`), and
the host tooling: checkpoint converters (`checkpoint.convert_llama2c_bin`,
`convert_hf_model`, `args_from_hf_config`), generation state
(`Llama.save_generation_state` / `resume_generate`), the profiler trace
and the debug tensor-stats trace (`observability`), LoRA adapters with
multi-LoRA serving (`lora`, `BatchEngine(adapters=...)`), training
(`train`), perplexity (`eval`) and token shards (`data`), and tensor-,
data- and pipeline-parallel engines over `torch.distributed`
(`parallel`: `Llama(mesh=)`, `PipelinedLlama`, one process a rank).  The kernels of these
paths (flash prefill attention, the fused batch-1 decode step, the greedy
lm_head + argmax and paged decode attention, in float32, bf16 and float16,
the decode step and paged attention also int8 and over caches of another
float dtype) are hand-written CUDA for Hopper (`csrc/`), built at first
use.  Entry points run on the card unless the caller asks for the CPU.

The port imports torch and numpy, never jax or the JAX package;
`params_from_jax` takes the JAX package's parameter tree as numpy arrays.
"""

from .checkpoint import (build_param_tree, load_param_tree, load_parameters,
                         params_from_jax, quantize_param_tree, save_npz,
                         synthetic_weights, write_synthetic_checkpoint)
from .config import PRESETS, ModelArgs, preset
from .kvcache import PageAllocator, init_cache, init_paged_cache
from .models.llama import Llama, StaticConfig, forward, forward_hidden
from .ops.kernels.greedy_head import argmax_head
from .reference_numpy import NumpyLlama
from .tokenizer import Tokenizer

__version__ = "0.1.0"

__all__ = [
    "ModelArgs", "PRESETS", "preset", "Tokenizer",
    "load_parameters", "load_param_tree", "build_param_tree",
    "quantize_param_tree", "synthetic_weights", "write_synthetic_checkpoint",
    "save_npz", "init_cache", "init_paged_cache", "PageAllocator",
    "Llama", "StaticConfig", "forward", "forward_hidden", "NumpyLlama",
    "params_from_jax", "argmax_head", "BatchEngine", "SpeculativeGenerator",
    "quantized_draft",
]


def __getattr__(name):
    # Lazy, as in the JAX package: serving and speculative pull in the
    # Generator.
    if name == "BatchEngine":
        from .serving import BatchEngine
        return BatchEngine
    if name in ("SpeculativeGenerator", "quantized_draft"):
        from . import speculative
        return getattr(speculative, name)
    raise AttributeError(name)
