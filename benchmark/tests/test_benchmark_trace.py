"""The busy-union arithmetic on synthetic profiler intervals."""

from __future__ import annotations

import types

import pytest

from qbench import trace
from qbench.trace import Activity, Trace


def _trace():
    dev = [Activity(10, 30, "k1", "kernel", 7),
           Activity(20, 40, "k2", "kernel", 7),      # overlaps k1
           Activity(35, 45, "Memcpy HtoD", "h2d", 9),
           Activity(60, 70, "k1", "kernel", 7),
           Activity(72, 80, "Memcpy DtoH", "d2h", 11),
           Activity(74, 78, "gather", "kernel", 11),  # output stream
           Activity(90, 120, "k3", "kernel", 7)]      # runs past hi
    spans = [(0, 50, "handoff"), (5, 48, "feed_push"), (8, 40, "step_call"),
             (50, 100, "handoff"), (52, 58, "output_copy"),
             (80, 95, "output_wait"), (100, 110, "handoff")]
    return trace.window(Trace(dev, spans))


def test_window_from_handoffs():
    tr = _trace()
    assert (tr.lo, tr.hi, tr.blocks) == (0, 100, 2)


def test_union_and_gaps():
    merged = trace.union([(10, 30), (20, 40), (35, 45), (60, 70), (90, 120)],
                         0, 100)
    assert merged == [(10, 45), (60, 70), (90, 100)]
    assert trace.covered(merged) == 55
    assert trace.gaps(merged, 0, 100) == [(0, 10), (45, 60), (70, 90)]
    assert trace.union([], 0, 10) == [] and trace.gaps([], 0, 10) == [(0, 10)]


def test_busy_and_step_busy():
    tr = _trace()
    assert trace.busy_ns(tr) == 35 + 10 + 8 + 10
    assert trace.output_streams(tr) == {11}
    # the step: kernels off the output stream, no copies
    assert trace.busy_ns(tr, trace.step_activity(tr)) == 30 + 10 + 10
    assert trace.step_busy_ms(tr) == pytest.approx(50 / 2 / 1e6)


def test_idle_gaps_named_by_innermost_span():
    tr = _trace()
    got = dict(trace.idle_by_span(tr))
    # gaps: [0,10) mid 5 -> feed_push; [45,60) mid 52 -> output_copy;
    # [70,72) mid 71 -> handoff; [80,90) mid 85 -> output_wait
    assert got == {"feed_push": 10 / 1e9, "output_copy": 15 / 1e9,
                   "handoff": 2 / 1e9, "output_wait": 10 / 1e9}


def test_top_ops_clipped_to_window():
    tr = _trace()
    top = dict(trace.top_ops(tr))
    assert top["k1"] == pytest.approx(30 / 1e9)
    assert top["k3"] == pytest.approx(10 / 1e9)


def test_layer_readers(manifest):
    tr = _trace()
    ctx = types.SimpleNamespace(trace=tr, cfg={"system": "rx_chain"})
    idle = manifest.reader("device.idle_pct")(ctx)
    assert idle == pytest.approx(100 * (1 - 63 / 100))
    assert manifest.reader("feed.h2d_ms")(ctx) == pytest.approx(10 / 2 / 1e6)
    assert manifest.reader("rx.step_busy_ms")(ctx) == pytest.approx(
        50 / 2 / 1e6)
    assert manifest.reader("pfb.step_busy_ms")(ctx) is None
    empty = types.SimpleNamespace(trace=Trace([], []), cfg=ctx.cfg)
    for m in ("device.idle_pct", "feed.h2d_ms", "rx.step_busy_ms"):
        assert manifest.reader(m)(empty) is None
