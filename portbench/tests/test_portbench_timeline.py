"""The trace arithmetic on synthetic event lists: busy time as the union of
device intervals, the idle gaps and what the host was doing in each, the
per-layer readers over a synthetic traced window."""

import types

import pytest

from portbench.harness import registry, timeline
from portbench.harness.cell import TracedWindow
from portbench.work import attention


def test_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38), (50, 60)]
    assert timeline.merge(spans) == [(0, 20), (30, 40), (50, 60)]
    assert timeline.busy_ns(spans, 0, 60) == 40
    assert timeline.busy_ns(spans, 10, 55) == 10 + 10 + 5
    assert timeline.gaps(spans, 0, 60) == [(20, 30), (40, 50)]
    assert timeline.gaps(spans, -5, 65) == [(-5, 0), (20, 30), (40, 50), (60, 65)]


def test_gap_labels_take_the_innermost_host_event():
    host = [("portbench.batch", 0, 100), ("aten::conv2d", 10, 30), ("aten::add", 40, 45),
            ("portbench.guide", 50, 90), ("aten::mul", 60, 70)]
    gaps = [(12, 14), (47, 49), (65, 66), (95, 96), (120, 130)]
    assert timeline.label_gaps(gaps, host) == [
        "aten::conv2d", "portbench.batch", "aten::mul", "portbench.batch",
        "(host between operations)"]


def test_slice_busy_idle_and_breakdown():
    dev = [("flash::fwd_kernel", "kernel", 100, 200, True),
           ("gn::gn_fused_kernel", "kernel", 250, 300, True),
           ("sm90_xmma_gemm", "kernel", 300, 400, True),
           ("Memcpy DtoH", "gpu_memcpy", 450, 500, True),
           ("old_kernel", "kernel", 0, 120, False)]
    host = [("aten::matmul", 190, 240), ("portbench.span_decode", 90, 600)]
    sl = timeline.Slice(dev, host, images=4)
    assert (sl.lo, sl.hi) == (100, 500)
    assert sl.busy_s == pytest.approx(300e-9) and sl.wall_s == pytest.approx(400e-9)
    assert len(sl.kernels) == 3
    assert sl.kernel_seconds(("flash::",)) == pytest.approx(100e-9)
    b = sl.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(100e-9)
    assert [g[0] for g in b["idle_gaps"]] == ["aten::matmul (1 gaps)",
                                              "portbench.span_decode (1 gaps)"]
    assert sl.by_category()["groupnorm kernels (port)"] == pytest.approx(50e-9)


class Ev:
    """A CUDA event stand-in: a device timestamp in ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_readers_on_a_synthetic_window():
    cell = registry.find_cell("sd15_guided_b8")
    recs = []
    for i in range(4):
        t = 1000.0 * i
        recs.append(types.SimpleNamespace(
            start=Ev(t), end=Ev(t + 900), units=[None] * 8,
            spans={"init_span": [(Ev(t), Ev(t + 100))], "guide": [(Ev(t + 100), Ev(t + 500))],
                   "span_decode": [(Ev(t + 500), Ev(t + 900))]}))
    dev = [("void flash::a", "kernel", 0, 10 ** 8, True),
           ("gn::b", "kernel", 2 * 10 ** 8, 3 * 10 ** 8, True),
           ("void pytorch_flash::flash_fwd_kernel", "kernel", 3 * 10 ** 8, 4 * 10 ** 8, True)]
    sl = timeline.Slice(dev, [], images=8)
    shape = (128, 4096, 4096, 40)
    tw = TracedWindow(cfg=cell.config, traffic=cell.traffic, batch=8, records=recs,
                      first_profiled=3, profiled=1, slice=sl, flops_per_image=lambda: 1e12,
                      flash_launches={("flash_fwd", shape): 290.0})
    read = {m["name"]: registry.load_metric(m["name"]).read(tw) for m in cell.per_layer}
    assert read["between_batch_ms"] == pytest.approx(100.0)
    assert read["denoise_ms_per_image"] == pytest.approx(3 * 500 / 24)
    assert read["guidance_ms_per_image"] == pytest.approx(3 * 400 / 24)
    assert read["mfu"] == pytest.approx(100 * 1e12 * 24 / 2.9 / 989e12)
    assert read["kernels_per_image"] == pytest.approx(3 / 8)
    assert read["idle_share"] == pytest.approx(100 * (1 - 3 / 4))
    # the port's flash time alone (0.1 s), against its own launches' bound
    assert read["attn_roofline"] == pytest.approx(
        100 * 290 * attention.bound_s("flash_fwd", *shape) / 0.1)
    assert read["gn_roofline"] > 0


def test_readers_report_nothing_without_their_source():
    cell = registry.find_cell("sd15_guided_b8")
    recs = [types.SimpleNamespace(start=Ev(0), end=Ev(10), units=[], spans={})]
    tw = TracedWindow(cfg=cell.config, traffic=cell.traffic, batch=8, records=recs,
                      first_profiled=1, profiled=1, slice=None, flops_per_image=lambda: 1.0)
    for name in ("guidance_ms_per_image", "kernels_per_image", "attn_roofline", "gn_roofline",
                 "idle_share", "between_batch_ms"):
        assert registry.load_metric(name).read(tw) is None

