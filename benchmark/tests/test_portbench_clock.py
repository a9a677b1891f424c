"""On the card: the port's obs clock mapped onto the device profiler's time
base (obs/trace.py ``ClockMap``, as spans.ClockedProfiler reads and binds
it).  ``torch.cuda._sleep`` kernels, each launched and synchronized inside
a host span, must land inside their spans on the device clock, and the
mapping must be pinned to 100 us: over the spans, the least gap between
the span's start and its kernel's start, and the least between the
kernel's end and the span's end, are each under 100 us (a launch, and a
synchronize's wake; an offset of the map would widen one of them).  The
spans run back to back after one untimed launch: a card left idle for
tens of ms starts a kernel ~120 us after its launch, not ~50.  Run on the card: ``python -m pytest benchmark/tests -q -m gpu -s``
(the edges are printed)."""

from __future__ import annotations

import time

import pytest

EDGE_US = 100.0


@pytest.mark.gpu
def test_a_kernel_lands_inside_its_host_span_on_the_device_clock(card):
    import torch

    from ai_rtc_agent_tpu_torch.obs.trace import clock
    from benchmark.spans import ClockedProfiler

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof = ClockedProfiler()
    prof.start()
    time.sleep(0.6)
    torch.cuda._sleep(1000)  # the window's first launch: not timed
    torch.cuda.synchronize()
    spans = []
    for cycles in (2_000_000, 20_000_000, 2_000_000, 60_000_000, 2_000_000, 2_000_000):
        t0 = clock()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        spans.append((t0, clock()))
    time.sleep(0.6)
    prof.stop()
    assert prof.clock is not None
    kernels = sorted((s, e, n) for n, s, e in prof.records())[1:]
    assert len(kernels) == len(spans), [k[2] for k in kernels]
    starts, ends = [], []
    for (t0, t1), (ks, ke, name) in zip(spans, kernels):
        h0, h1 = prof.clock.to_device_us(t0), prof.clock.to_device_us(t1)
        print(f"{name}: kernel {ke - ks:.1f} us, starts {ks - h0:.1f} us after the span, "
              f"ends {h1 - ke:.1f} us before its end")
        assert h0 <= ks and ke <= h1
        starts.append(ks - h0)
        ends.append(h1 - ke)
    assert min(starts) < EDGE_US and min(ends) < EDGE_US, (starts, ends)
