"""Fused lm_head + argmax (a greedy head): one row's greedy token without a
logits tensor, as a hand-written CUDA kernel (`csrc/greedy_head.cu`) beside
its plain PyTorch version.

Counterpart of `llama3np_tpu.ops.kernels.greedy_head.argmax_head`: the
same function, argmax(x.astype(w.dtype) @ w) with f32 sums and the lowest
index winning a tie.  The JAX package kept it off its decode loop for TPU
reasons (an M=1 matvec cannot feed the MXU, and XLA hoisted a bf16 copy of
the fp32 lm_head); on the H100 an M=1 GEMV is a memory-bound stream
whoever writes it, and fusing the argmax removes the [1, VS] logits write,
its read and a launch a token, so the port's batch-1 greedy decode loop
(`generate.kernel_decode_steps`) takes its token from here for a float32,
bf16 or float16 lm_head.  `argmax_head` launches the kernel for CUDA tensors and
runs `argmax_head_plain` for CPU tensors; there is no fallback from one to
the other.  `argmax_head.launches` counts launches (one per call).
"""

from __future__ import annotations

import torch

from . import _build

_ENTRIES = {torch.float32: "l3t_argmax_head_f32",
            torch.bfloat16: "l3t_argmax_head_bf16",
            torch.float16: "l3t_argmax_head_f16"}


def argmax_head_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: x [1, D] cast to w's dtype, the
    product in f32, torch.argmax's lowest-index tie order.  Returns [1]
    int64."""
    return torch.argmax(x.to(w.dtype).float() @ w.float(), dim=-1)


def argmax_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Greedy token for one row: argmax(x @ w) -> [1] int64.

    x: [1, D] (the final-norm hidden state, any float dtype; cast to w's
    dtype as the TPU kernel casts it); w: [D, VS] lm_head.  CUDA tensors:
    w float32 (VS % 4 == 0), bf16 or float16 (VS % 8 == 0), contiguous.
    """
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"argmax_head takes x [1, D] and w [D, VS]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if x.device.type == "cpu":
        return argmax_head_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"argmax_head runs on CUDA or CPU tensors, not {x.device}")
    if w.dtype not in _ENTRIES:
        raise NotImplementedError(
            f"the argmax_head kernel takes a float32, bf16 or float16 lm_head, "
            f"not {w.dtype}; an int8 head keeps lm_logits + argmax (the TPU "
            "kernel has no int8 mode)")
    D, VS = w.shape
    vec = 16 // w.element_size()
    if VS % vec or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"the argmax_head kernel takes a contiguous, 16-byte "
                         f"aligned lm_head whose vocab is a multiple of {vec}; "
                         f"got VS={VS}")
    xs = x.to(w.dtype).contiguous()
    lib = _build.KernelLibrary.get()
    nb = -(-VS // (32 * vec))  # blocks of 32 lanes x one 16-byte vector
    # One allocation: the token (int64), then each block's (max, index).
    buf = torch.empty(2 + 2 * nb, dtype=torch.int32, device=w.device)
    out = buf[:2].view(torch.int64)
    rc = getattr(lib, _ENTRIES[w.dtype])(
        xs.data_ptr(), w.data_ptr(), out.data_ptr(), buf[2:].data_ptr(),
        buf[2 + nb :].data_ptr(), D, VS, w.device.index,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(rc, "argmax_head")
    argmax_head.launches += 1
    return out


argmax_head.launches = 0
