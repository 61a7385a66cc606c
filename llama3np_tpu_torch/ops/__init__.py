"""Plain PyTorch ops (`ops.core`) and the hand-written CUDA kernels
(`ops.kernels`)."""
