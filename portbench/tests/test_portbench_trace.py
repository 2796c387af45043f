"""The trace readers on a recorded list of events."""
import pytest

from portbench import trace

# (name, kind, start_ns, end_ns): a 1000 ns job; kernels at 100-300 and 250-400
# (overlapping), a copy at 600-700, a kernel after the job
EVENTS = [
    ("portbench.job", "annotation", 0, 1000),
    ("portbench.job", "annotation", 100, 1100),        # the span's copy on the device
    ("aten::mul", "host", 10, 60),
    ("cudaLaunchKernel", "host", 50, 90),
    ("k_a", "kernel", 100, 300),
    ("match_top2_wgmma", "kernel", 250, 400),
    ("aten::item", "host", 390, 620),
    ("Memcpy DtoH", "memcpy", 600, 700),
    ("aten::add", "host", 800, 810),
    ("k_a", "kernel", 1200, 1300),
]


def test_span_is_the_hosts():
    assert trace.span(EVENTS, "portbench.job") == (0, 1000)


def test_busy_is_the_union_and_launches_are_counted():
    s = trace.summarize(EVENTS)
    assert s["window_ns"] == 1000
    assert s["busy_ns"] == (400 - 100) + (700 - 600)
    assert s["launches"] == 2
    assert trace.kernel_times_ns(EVENTS, 0, 1000, "match_top2") == [150]


def test_idle_gaps_are_named_by_the_host():
    s = trace.summarize(EVENTS)
    gaps = dict(s["idle_gaps"])
    # 0-100: the host had begun nothing; 400-600 and 700-1000: aten::item
    assert gaps["(before any host event)"] == pytest.approx(100e-9)
    assert gaps["aten::item"] == pytest.approx(500e-9)
    assert sum(gaps.values()) == pytest.approx(600e-9)
    ops = dict(s["device_ops"])
    assert ops["k_a"] == pytest.approx(200e-9) and ops["Memcpy DtoH"] == pytest.approx(100e-9)


def test_idle_share_and_launch_readers():
    from portbench.run import load_module

    ctx = {"trace": trace.summarize(EVENTS), "events": EVENTS,
           "span": trace.span(EVENTS, "portbench.job"), "jobs": [],
           "calls": {"match_top2": [(1, 256, 256)]}}
    assert load_module("metrics", "device.idle_share").read(ctx) == pytest.approx(60.0)
    assert load_module("metrics", "device.launches_per_job").read(ctx) == 2.0
    share = load_module("metrics", "k1_roofline").read(ctx)
    from portbench.roofline import k1_bound_s
    assert share == pytest.approx(100 * k1_bound_s(1, 256, 256) / 150e-9)
    # K1 launches that do not pair with the recorded calls read nothing
    assert load_module("metrics", "k1_roofline").read(dict(ctx, calls={})) is None
    two = dict(ctx, calls={"match_top2": [(1, 256, 256)] * 2})
    assert load_module("metrics", "k1_roofline").read(two) is None
    assert load_module("metrics", "device.idle_share").read(dict(ctx, trace=None)) is None
