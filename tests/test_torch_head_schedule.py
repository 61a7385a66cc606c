"""The schedule of the port's greedy-head kernel (`csrc/greedy_head.cu`),
modelled in plain PyTorch on the CPU and held against the JAX kernel
(`argmax_head`, in interpret mode) and the port's plain version, on inputs
made with numpy from a seed.

(a) One launch over (column strips x D splits): each split's column sums in
    f32, summed in split order by the strip's last block; the strip reduced
    to its (max, lowest index) pair; the strips' pairs folded by "greater
    value, then lower index".  fp32, bf16 and fp16 heads; VS of 32,000,
    128,256, one strip, and one not a multiple of a strip; a small SM
    count, so that D is split.
(b) Planted ties across a split boundary and across a strip boundary: the
    lower column wins, as np.argmax / torch.argmax order them.
(c) The grid planner (`head_plan`) is a pure function of (D, VS, element
    size, SM count) that fills whole waves of equal blocks.

The model lives here, not in the package: the kernel is its
implementation on the card.  Tokens are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3np_tpu.ops.kernels.greedy_head import argmax_head as j_argmax_head
from llama3np_tpu_torch.ops.kernels.greedy_head import (
    HEAD_BLOCKS_PER_SM, HEAD_MAX_SPLIT, HEAD_MIN_SPLIT_ROWS, HEAD_ROW_STEP, argmax_head,
    argmax_head_plain, head_plan, scratch_words)

torch.set_num_threads(1)

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
SMS = 4  # a small card: the test widths get several D splits


def scheduled_argmax_head(x, w, sm_count=SMS):
    """The kernel's schedule: returns (token, plan)."""
    D, VS = w.shape
    plan = head_plan(D, VS, w.element_size(), sm_count)
    cols, strips, rows, splits = plan
    xf, wf = x.to(w.dtype).float()[0], w.float()
    total = torch.zeros(VS)
    for s in range(splits):  # each split's column sums, added in split order
        r = slice(s * rows, min(D, (s + 1) * rows))
        total = total + xf[r] @ wf[r]
    best = (-float("inf"), 2**31 - 1)
    for st in range(strips):
        seg = total[st * cols : min(VS, (st + 1) * cols)]
        m = float(seg.max())
        i = st * cols + int(torch.nonzero(seg == m)[0])  # the strip's lowest index
        if m > best[0] or (m == best[0] and i < best[1]):
            best = (m, i)
    return best[1], plan


def j_token(x, w, jdt):
    """The JAX kernel's token, in interpret mode, on the same values."""
    return int(j_argmax_head(jnp.asarray(x.float().numpy(), jdt),
                             jnp.asarray(w.float().numpy(), jdt), interpret=True)[0])


def head_inputs(rng, D, VS, dtype, n_x=3):
    w = torch.from_numpy((rng.standard_normal((D, VS)) * 0.02).astype(np.float32)).to(dtype)
    xs = [torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).to(dtype)
          for _ in range(n_x)]
    return w, xs


# D splits in every case but the 128,256-column one (kept narrow: a CPU
# test), at the H100's 132 SMs or a small card's 4.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D,VS,sms", [(520, 32000, 132), (96, 128256, 132), (600, 256, SMS),
                                      (530, 1000, SMS)],
                         ids=["vs32000", "vs128256", "one-strip", "partial-strip"])
def test_scheduled_head_matches_jax_and_plain(rng, dtype, D, VS, sms):
    tdt, jdt = DTYPES[dtype]
    cols = head_plan(D, VS, tdt.itemsize, sms)[0]
    if VS == 256:
        VS = cols  # exactly one strip in this dtype
    w, xs = head_inputs(rng, D, VS, tdt)
    for x in xs:
        got, plan = scheduled_argmax_head(x, w, sms)
        assert got == int(argmax_head_plain(x, w)[0]) == int(argmax_head(x, w)[0])
        assert got == j_token(x, w, jdt)
    if VS > cols:
        assert plan[1] > 1
    if VS == 1000:
        assert VS % cols != 0
    assert (plan[3] > 1) == (VS != 128256)  # D is split where it is wide enough


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("where", ["split", "strip", "both"])
def test_scheduled_head_ties_go_to_the_lower_column(rng, dtype, where):
    tdt, jdt = DTYPES[dtype]
    D, VS = 530, 1024
    cols, strips, rows, splits = head_plan(D, VS, tdt.itemsize, SMS)
    assert splits > 1 and strips > 2
    w, xs = head_inputs(rng, D, VS, tdt, n_x=1)
    x = xs[0].clone()
    # Two columns whose sums are exactly 32, each from one row (x = 4 there,
    # w = 8): a tie across the split boundary puts the lower column's 8 in
    # split 1 and the higher's in split 0; across a strip boundary the two
    # columns are the last of strip 0 and the first of strip 1.
    lo, hi = {"split": (3, 40), "strip": (cols - 1, cols), "both": (cols - 1, cols)}[where]
    r_lo, r_hi = (rows + 5, 7) if where != "strip" else (7, 7)
    w[:, [lo, hi]] = 0
    w[r_lo, lo] = 8.0
    w[r_hi, hi] = 8.0
    x[0, r_lo] = 4.0
    x[0, r_hi] = 4.0
    got, _ = scheduled_argmax_head(x, w)
    assert got == lo == int(argmax_head_plain(x, w)[0]) == j_token(x, w, jdt)


@pytest.mark.parametrize("D,VS,itemsize,want", [
    (2048, 32000, 2, (256, 125, 512, 4)),      # tinyllama-1.1b fp16 / bf16
    (2048, 32000, 4, (128, 250, 1024, 2)),     # tinyllama-1.1b fp32
    (288, 32000, 4, (128, 250, 320, 1)),       # stories15M fp32: too short to split
    (4096, 128256, 2, (256, 501, 4096, 1)),    # llama3-8b bf16 / fp16
])
def test_head_plan_at_the_main_path_shapes(D, VS, itemsize, want):
    """On the H100's 132 SMs every shape that splits fills at least 94 % of
    a wave of four blocks an SM, each block the same rows of its strip."""
    plan = head_plan(D, VS, itemsize, 132)
    assert plan == want
    cols, strips, rows, splits = plan
    blocks = strips * splits
    assert blocks <= HEAD_BLOCKS_PER_SM * 132
    assert blocks / (HEAD_BLOCKS_PER_SM * 132) > 0.94 or D < 2 * HEAD_MIN_SPLIT_ROWS
    words, tickets = scratch_words(VS, plan)
    assert words == (splits * VS if splits > 1 else 0) + 2 * strips and tickets == strips + 1


@pytest.mark.parametrize("D", [1, 63, 64, 288, 1000, 2048, 4096, 8192])
@pytest.mark.parametrize("VS", [8, 1000, 32000, 128256])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_head_plan_is_a_pure_function_of_static_shapes(D, VS, itemsize, sms):
    plan = head_plan(D, VS, itemsize, sms)
    assert plan == head_plan(D, VS, itemsize, sms)
    cols, strips, rows, splits = plan
    assert cols == 32 * 16 // itemsize and strips == -(-VS // cols)
    assert rows % HEAD_ROW_STEP == 0 and splits == -(-D // rows) <= HEAD_MAX_SPLIT
    assert (splits - 1) * rows < D <= splits * rows  # no empty split
    assert splits == 1 or rows >= HEAD_MIN_SPLIT_ROWS

    def fill(n):
        blocks = strips * n
        slots = HEAD_BLOCKS_PER_SM * sms
        return blocks / (-(-blocks // slots) * slots)

    # No split count the planner could take fills the waves 2 % better.
    steps = -(-D // HEAD_ROW_STEP)
    others = {-(-D // (-(-steps // s) * HEAD_ROW_STEP))
              for s in range(1, max(1, min(HEAD_MAX_SPLIT, D // HEAD_MIN_SPLIT_ROWS)) + 1)}
    assert all(fill(s) <= fill(splits) + 0.02 for s in others)
