"""The trace reader on a made-up trace: device time goes to the spans
open where its launch was, a kernel whose launch the profiler missed is
placed by its stream's order, and idle gaps are labelled by the host's
innermost spans."""
from __future__ import annotations

from torch.autograd import DeviceType

from perfbench import trace


class Ev:
    def __init__(self, name, start, dur, dev=False, tid=1, cid=0, link=0,
                 stream=7):
        self._a = (name, start, dur, dev, tid, cid, link, stream)

    def name(self):
        return self._a[0]

    def start_ns(self):
        return self._a[1]

    def duration_ns(self):
        return self._a[2]

    def device_type(self):
        return DeviceType.CUDA if self._a[3] else DeviceType.CPU

    def start_thread_id(self):
        return self._a[4]

    def correlation_id(self):
        return self._a[5]

    def linked_correlation_id(self):
        return self._a[6]

    def device_resource_id(self):
        return self._a[7]

    def is_user_annotation(self):
        return False


def test_spans_linking_placement_and_gaps():
    us = 1000
    evs = [
        Ev(trace.WINDOW, 0, 1000 * us, tid=9),
        # thread 1: a prefill whose attention call launches an unrecorded kernel
        Ev("engine.prefill", 10 * us, 300 * us, tid=1),
        Ev("aten::mm", 20 * us, 5 * us, tid=1),
        Ev("cudaLaunchKernel", 21 * us, 2 * us, tid=1, cid=101),
        Ev("attention:1", 40 * us, 20 * us, tid=1),
        Ev("cudaLaunchKernel", 70 * us, 2 * us, tid=1, cid=102),
        # thread 2: a decode step with an moe span
        Ev("engine.decode_step", 400 * us, 200 * us, tid=2),
        Ev("moe", 450 * us, 50 * us, tid=2),
        Ev("cudaLaunchKernel", 460 * us, 2 * us, tid=2, cid=103),
        # the device: gemm (linked), flash (not recorded), out proj, moe op
        Ev("gemm", 100 * us, 50 * us, dev=True, link=101),
        Ev("flash", 150 * us, 100 * us, dev=True),
        Ev("outproj", 250 * us, 30 * us, dev=True, link=102),
        Ev("expert", 470 * us, 40 * us, dev=True, link=103),
    ]
    t = trace.analyse(evs)
    assert t["window_s"] == 1e-3 and abs(t["busy_s"] - 220e-6) < 1e-12
    assert abs(t["linked_device_s"] - 120e-6) < 1e-12
    assert t["unplaced_device_s"] == 0
    sp = t["span_device_s"]
    assert abs(sp["attention:1"] - 100e-6) < 1e-12
    assert abs(sp["engine.prefill"] - 180e-6) < 1e-12
    assert abs(sp["moe"] - 40e-6) < 1e-12
    assert abs(sp["engine.decode_step"] - 40e-6) < 1e-12
    gaps = dict(t["idle_gaps"])
    # 280-470 us: thread 2's decode step is open from 400 us, thread 1's
    # prefill until 310 us; the gap's middle (375 us) has no span open
    assert "no span" in gaps
    assert t["device_ops"][0][0] == "flash"

