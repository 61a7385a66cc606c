"""The classes `trace.kind` gives device operations by name: cuBLAS's
Hopper GEMMs (`nvjet_*`) and its split-K reduction are products; the
program's kernels keep their own classes.  A profiler window lies between
its two device markers, on the operations' own timeline: what lies
outside it is cut and counted, and the host's clocks never stretch or
shrink it."""

import pytest

from benchmark.harness import readers
from benchmark.harness.trace import (MARKER, WINDOW, Profile, device_window, kind,
                                     profile_window, read_profile)

KINDS = [
    ("nvjet_tss_64x16_64x16_4x1_v_bz_NNT", "matmul"),
    ("nvjet_tss_64x64_64x13_2x1_v_bz_splitK_NNT", "matmul"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, "
     "__nv_bfloat16, false, false, false>(cublasLt::cublasSplitKParams<float>, float const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float const*, float const*, __nv_bfloat16 const*, "
     "float const*, __nv_bfloat16*, void*, long, float*, int*)", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("paged_attn_kernel", "paged_attention"),
    ("decode_gemv_kernel", "decode_layers"),
    ("decode_attn_kernel", "decode_layers"),
    ("argmax_head_kernel", "argmax_head"),
    ("flash_prefill_tc_kernel", "flash_prefill"),
    ("void at::native::elementwise_kernel<128, 2, ...>", "other"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
     "copy_cast"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
]


@pytest.mark.parametrize("name,want", KINDS)
def test_kind(name, want):
    assert kind(name) == want


class Run:
    def __init__(self, profile):
        self.profile = profile


def test_window_is_its_own_range():
    ops = [("decode_gemv_kernel", 10.1, 10.9), ("decode_attn_kernel", 10.9, 11.4)]
    p = Profile(ops, [], host_s=1.2, window=(10.0, 11.5))
    assert p.window_s == pytest.approx(1.5) and p.busy_s == pytest.approx(1.3)
    assert readers.idle_share(Run(p)) == pytest.approx(100 * 0.2 / 1.5)
    c = p.clock()
    assert (c["host_s"], c["cut_ops"], c["cut_s"]) == (1.2, 0, 0.0)
    assert c["ops_start_after_s"] == pytest.approx(0.1)
    assert c["ops_end_before_s"] == pytest.approx(0.1)


def test_operations_outside_the_window_are_cut_and_counted():
    ops = [("a", 9.8, 10.2), ("b", 10.2, 11.0), ("c", 11.0, 11.6), ("d", 12.0, 12.5)]
    p = Profile(ops, [], host_s=1.0, window=(10.0, 11.5))
    assert p.window_s == pytest.approx(1.5) and p.busy_s == pytest.approx(1.5)
    assert [n for n, _, _ in p.ops] == ["a", "b", "c"]
    assert p.cut_n == 3 and p.cut_s == pytest.approx(0.2 + 0.1 + 0.5)
    assert readers.idle_share(Run(p)) == pytest.approx(0.0, abs=1e-9)


def test_without_a_range_the_host_clock_is_the_window():
    ops = [("a", 1.0, 1.5)]
    p = Profile(ops, [], host_s=2.0)
    assert p.window_s == 2.0 and p.busy_s == 0.5 and p.cut_n == 0
    assert "ops_start_after_s" not in p.clock()


def test_profile_window_records_its_range_on_the_cpu():
    import torch

    out, read = profile_window(torch, lambda: torch.ones(64, 64).sum().item())
    p = read()
    assert out == 4096.0 and p.window is not None
    assert p.window_s >= 0.0 and p.host_s >= 0.0
    assert all(name != WINDOW for name, *_ in p.host)


class Event:
    def __init__(self, name, device, start_us, end_us, parent=None):
        from torch.autograd import DeviceType

        self.name, self.cpu_parent, self.is_user_annotation = name, parent, False
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU

        class Range:
            start, end = start_us, end_us
        self.time_range = Range()


def test_window_lies_between_the_device_markers():
    rng = Event(WINDOW, False, 9.0e6, 11.6e6)
    events = [rng, Event("aten::mm", False, 9.5e6, 9.6e6, rng),
              Event(f"void at::cuda::(anonymous namespace)::{MARKER}(long)", True, 10.0e6, 10.001e6),
              Event("nvjet_tss_64x16", True, 10.2e6, 10.5e6),
              Event("decode_gemv_kernel", True, 10.5e6, 11.7e6),  # stamped past the end marker
              Event(f"void at::cuda::(anonymous namespace)::{MARKER}(long)", True, 11.5e6, 11.501e6)]

    class Prof:
        def events(self):
            return events
    p = read_profile(Prof(), host_s=2.5)
    assert p.window == pytest.approx((10.0, 11.501)) and p.window_s == pytest.approx(1.501)
    assert [n for n, _, _ in p.ops] == ["nvjet_tss_64x16", "decode_gemv_kernel"]
    assert p.busy_s == pytest.approx(1.301) and p.cut_n == 1 and p.cut_s == pytest.approx(0.199)
    assert [h[0] for h in p.host] == ["aten::mm"] and p.host[0][3] == 1
    c = p.clock()
    assert c["host_range_s"] == pytest.approx(2.6) and c["host_s"] == 2.5
    assert c["ops_start_after_s"] == pytest.approx(0.2)
    assert c["ops_end_before_s"] == pytest.approx(-0.199)
    assert c["device_start_after_host_s"] == pytest.approx(1.0)
    assert c["device_end_before_host_s"] == pytest.approx(0.099)


@pytest.mark.parametrize("marks,want", [
    ([(1.0, 1.001), (3.0, 3.001)], (1.0, 3.001)),
    ([(3.0, 3.001)], (0.5, 3.001)),  # the start marker's record lost
    ([(1.0, 1.001)], (1.0, 3.5)),    # the end marker's record lost
    ([], (0.5, 3.5)),
])
def test_each_end_of_the_window_is_its_marker_or_the_host_range(marks, want):
    ops = [("a", 1.5, 2.0), ("b", 2.5, 3.0)]
    assert device_window(ops, marks, (0.5, 3.5)) == pytest.approx(want)
    assert device_window(ops, marks, None) == (
        pytest.approx(want) if len(marks) == 2 else None)
