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

The kernel is one launch over a grid of (column strips x D splits);
`head_plan` sizes it from static shapes and the SM count, and the last
block to arrive folds the splits and the strips (`csrc/greedy_head.cu`).
"""

from __future__ import annotations

import torch

from . import _build

_ENTRIES = {torch.float32: "l3t_argmax_head_f32",
            torch.bfloat16: "l3t_argmax_head_bf16",
            torch.float16: "l3t_argmax_head_f16"}


HEAD_BLOCKS_PER_SM = 4   # __launch_bounds__(256, 4) in csrc/greedy_head.cu
HEAD_ROW_STEP = 64       # rows a block step: 8 warps x 8 loads in flight a lane
HEAD_MAX_SPLIT = 16
HEAD_MIN_SPLIT_ROWS = 256  # a split's rows: shorter ones pay more in the fold than they save


def head_plan(D: int, VS: int, itemsize: int, sm_count: int) -> tuple:
    """(cols, strips, rows, splits) of the kernel's grid: strips of `cols`
    vocab columns (32 lanes x one 16-byte vector), D cut into `splits`
    ranges of `rows` rows (a multiple of HEAD_ROW_STEP; the last may be
    shorter).  The fewest splits within 2 % of the best fill of whole waves
    of HEAD_BLOCKS_PER_SM blocks an SM, D cut only into splits of at least
    HEAD_MIN_SPLIT_ROWS rows.  A pure function of its arguments."""
    cols = 32 * (16 // itemsize)
    strips = -(-VS // cols)
    slots = HEAD_BLOCKS_PER_SM * sm_count
    steps = -(-D // HEAD_ROW_STEP)
    best, best_fill = None, -1.0
    for want in range(1, max(1, min(HEAD_MAX_SPLIT, D // HEAD_MIN_SPLIT_ROWS)) + 1):
        rows = -(-steps // want) * HEAD_ROW_STEP
        splits = -(-D // rows)
        blocks = strips * splits
        fill = blocks / (-(-blocks // slots) * slots)
        if fill > best_fill + 0.02:
            best, best_fill = (cols, strips, rows, splits), fill
    return best


def scratch_words(VS: int, plan: tuple) -> tuple:
    """(scratch words, ticket words) of a call planned as `plan`
    (`head_plan`): the splits' column sums (when D is split) and each
    strip's (max, index) pair; a ticket a strip and one for the fold."""
    _, strips, _, splits = plan
    return (splits * VS if splits > 1 else 0) + 2 * strips, strips + 1


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
    plan = head_plan(D, VS, w.element_size(), _build.sm_count(w.device.index))
    stream = torch.cuda.current_stream(w.device).cuda_stream
    words, n_tickets = scratch_words(VS, plan)
    tickets = _build.tickets("argmax_head", w.device, stream, n_tickets)
    # One allocation, never read before written: the token, then the scratch.
    buf = torch.empty(2 + words, dtype=torch.int32, device=w.device)
    out = buf[:2].view(torch.int64)
    rc = getattr(lib, _ENTRIES[w.dtype])(
        xs.data_ptr(), w.data_ptr(), out.data_ptr(), buf[2:].data_ptr(),
        tickets.data_ptr(), D, VS, plan[2], w.device.index, stream)
    _build.check(rc, "argmax_head")
    argmax_head.launches += 1
    return out


argmax_head.launches = 0
