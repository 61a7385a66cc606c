"""Hand-written Hopper kernels (CUDA C++ under `llama3np_tpu_torch/csrc/`),
each beside its plain PyTorch version.  Nothing is built on import: the
shared library is compiled at the first launch (`_build.KernelLibrary.get`)."""
