"""The trace reading: device time charged to the span that launched it,
busy time as the union of device intervals, idle gaps named by the span
the host was in."""

import pytest

from harness import manifest, trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary_of_a_small_trace():
    events = [
        _x("user_annotation", "window", 0, 100),
        _x("user_annotation", "backbones", 0, 50),
        _x("user_annotation", "peel", 50, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _x("kernel", "void conv_rows_kernel<96, false>(ConvRows)", 20, 20, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=2),
        _x("kernel", "void fill", 30, 15, corr=2),     # overlaps the first
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        _x("kernel", "argmax", 70, 20, corr=3),
        _x("kernel", "outside", 150, 10, corr=4),      # after the window
    ]
    s = trace.summarize(events, ("backbones", "peel"))
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(45e-6)
    assert s.span_device_s["backbones"] == pytest.approx(35e-6)
    assert s.span_kernels == {"backbones": 2, "peel": 1}
    assert s.launches_matching(("conv_rows_kernel",), "backbones") == 1
    assert s.seconds_matching(("argmax",)) == pytest.approx(20e-6)
    assert s.seconds_matching(("conv_rows",), "backbones") == pytest.approx(20e-6)
    assert s.seconds_matching(("conv_rows",), "peel") == 0.0
    gaps = dict((round(g * 1e6), n) for n, g in s.idle_gaps)
    assert gaps == {20: "backbones", 25: "peel", 10: "peel"}


def test_conv_roofline_reads_the_conv_kernels_alone():
    events = [
        _x("user_annotation", "window", 0, 100),
        _x("user_annotation", "backbones", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        _x("kernel", "void conv_rows_kernel<96, false>(ConvRows)", 10, 20, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
        _x("kernel", "split_reduce_kernel", 30, 5, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=3),
        _x("kernel", "void at::native::FillFunctor<float>", 40, 50, corr=3),
    ]
    s = trace.summarize(events, ("backbones",))
    read = manifest.metric_reader("conv_roofline")
    got = read({"trace": s, "profiled_conv_least_s": 5e-6})
    assert got == pytest.approx(100.0 * 5e-6 / 25e-6)    # the fill is not a conv's
    assert read({"trace": s, "profiled_conv_least_s": 0.0}) is None


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([_x("kernel", "k", 0, 1, corr=1)], ())
