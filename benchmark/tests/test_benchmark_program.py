"""The program's spans in the trace (``qbench.program``) on a synthetic
trace: the launch join, device time put down to the innermost span that
launched it (an enclosing span selecting it too), launch and sync counts
a step, the feed's overlap with the step, the idle-by-program-span line,
the readers' None where their system or span is absent, and the readers
that were there before giving the values they gave."""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from qbench import program, trace
from qbench.program import Launched, Program
from qbench.trace import Activity, Trace
from test_benchmark_trace import _trace

OLD = ("device.idle_pct", "feed.h2d_ms", "rx.step_busy_ms",
       "rx.kernels_roofline_pct", "pfb.step_busy_ms",
       "pfb.kernels_roofline_pct")
NEW_RX = ("rx.front_ms", "rx.filter_ms", "rx.demod_ms", "rx.agc_ms",
          "rx.launches_per_block", "rx.host_syncs_per_block")
NEW_PFB = ("pfb.poly_ms", "pfb.stage1_ms", "pfb.demod_ms", "pfb.power_ms",
           "pfb.launches_per_block", "pfb.host_syncs_per_block")
SHAPES = {"rx_chain": {"channels": 8, "block_in": 5120, "block_audio": 256,
                       "front_taps": 1421, "filter_taps": 1025,
                       "agc_lookahead": 96,
                       "families": ["ssb", "ssb", "am", "fm"] * 2},
          "pfb_rx": {"n_chan": 256, "block_in": 16384, "n_out": 128,
                     "taps_per_branch": 8, "families": ["ssb"] * 256}}

# (start, end, name, kind, stream, launched, thread)
DEVICE = [(40, 56, "Memcpy HtoD", "h2d", 9, 2, 1),      # feed.copy
          (12, 22, "front", "kernel", 7, 11, 1),         # rx.front
          (22, 30, "fft", "kernel", 7, 15, 1),           # rx.filter
          (30, 34, "fft2", "kernel", 7, 16, 1),          # rx.filter
          (34, 50, "agc", "kernel", 7, 18, 1),           # rx.agc
          (50, 60, "Memcpy DtoH", "d2h", 11, 25, 1),     # the harness
          (52, 58, "gather", "kernel", 11, 24, 1),       # output stream
          (60, 70, "front", "kernel", 7, 61, 1),         # rx.front
          (72, 75, "orphan", "kernel", 7, -1, -1),       # no link
          (80, 90, "other", "kernel", 7, 66, 2)]         # another thread
SPANS = [(1, 3, "feed.copy", 1), (10, 19, "rx.step", 1),
         (10, 14, "rx.front", 1), (14, 17, "rx.filter", 1),
         (17, 19, "rx.agc", 1), (60, 80, "rx.step", 1),
         (60, 64, "rx.front", 1), (101, 109, "rx.step", 1)]
CALLS = [(2, "cudaMemcpyAsync", 1), (11, "cudaLaunchKernel", 1),
         (13, "cudaStreamIsCapturing", 1), (15, "cudaLaunchKernel", 1),
         (16, "cuLaunchKernel", 1), (18, "cudaLaunchKernelExC", 1),
         (24, "cudaLaunchKernel", 1), (25, "cudaMemcpyAsync", 1),
         (61, "cudaLaunchKernel", 1), (62, "cudaStreamSynchronize", 1),
         (63, "cudaMemsetAsync", 1), (66, "cudaLaunchKernel", 2),
         (102, "cudaLaunchKernel", 1)]
HANDOFFS = [(0, 1, "handoff"), (50, 51, "handoff"), (100, 101, "handoff")]


def _synthetic() -> Trace:
    """A window of 0-100 ns, two blocks, with its program view."""
    tr = trace.window(Trace([Activity(*d[:5]) for d in DEVICE],
                            list(HANDOFFS)))
    tr.program = Program([Launched(*d) for d in DEVICE], list(SPANS),
                         list(CALLS))
    return tr


def _ctx(tr, system):
    return types.SimpleNamespace(trace=tr, cfg={"system": system},
                                 shapes=SHAPES[system])


class _Event:
    """A kineto event as ``from_events`` reads it."""

    def __init__(self, name, start, end, cuda=False, corr=0, thread=1,
                 stream=7, annotation=False):
        self._v = (name, start, end, cuda, corr, thread, stream, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def device_resource_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def _events():
    ev = [_Event("bench." + n, s, e) for s, e, n in HANDOFFS]
    ev += [_Event("quisk." + n, s, e, thread=th) for s, e, n, th in SPANS]
    ev += [_Event(n, s, s + 1, corr=1000 + i, thread=th)
           for i, (s, n, th) in enumerate(CALLS)]
    corr = {s: 1000 + i for i, (s, _, _) in enumerate(CALLS)}
    ev += [_Event(n, s, e, cuda=True, corr=corr.get(at, 1), stream=st)
           for s, e, n, _, st, at, _ in DEVICE]
    ev.append(_Event("quisk.rx.front", 12, 22, cuda=True, annotation=True))
    ev.append(_Event("aten::add", 11, 12, corr=1000))   # an op, not a call
    return ev


def test_launch_join_by_correlation_id():
    tr = trace.window(Trace([], list(HANDOFFS)))
    pv = program.from_events(_events(), tr)
    got = sorted((a.start, a.name, a.launched, a.thread) for a in pv.device)
    want = sorted((d[0], d[2], d[5], d[6]) for d in DEVICE)
    assert got == want
    assert sorted(pv.spans) == sorted(SPANS)
    assert [c[1] for c in pv.calls] == [c[1] for c in sorted(CALLS)]
    # another record's hand-offs do not bound this window
    assert program.from_events(_events(), Trace([], [], 5, 100, 2)) is None


def test_innermost_and_enclosing_spans_select():
    tr = _synthetic()
    pv = tr.program
    front = program.launched_in(pv, "rx.front")
    step = program.launched_in(pv, "rx.step")
    assert [a.name for a in pv.device if front(a)] == ["front", "front"]
    assert {a.name for a in pv.device if step(a)} == {"front", "fft", "fft2",
                                                      "agc"}
    # an unlinked activity and one launched on another thread: neither
    anyspan = program.launched_in_any(pv)
    assert not [a for a in pv.device if a.name in ("orphan", "other")
                and anyspan(a)]
    assert program.stage_ms(tr, "rx.front") == pytest.approx(20 / 2 / 1e6)
    assert program.stage_ms(tr, "rx.filter") == pytest.approx(12 / 2 / 1e6)
    assert program.stage_ms(tr, "rx.agc") == pytest.approx(16 / 2 / 1e6)
    assert program.stage_ms(tr, "rx.demod") is None
    # the stages account for the step's busy time but for what no span
    # launched (the orphan, the other thread's kernel)
    assert trace.step_busy_ms(tr) == pytest.approx((38 + 10 + 3 + 10) / 2
                                                  / 1e6)
    assert program.unattributed_share(tr, pv) == pytest.approx(13 / 61)


def test_launch_and_sync_counts_a_step():
    tr = _synthetic()
    pv = tr.program
    # the two steps that start in the window; the third's call, the other
    # thread's and the harness's are left out
    assert program.calls_per_step(tr, "rx.step", program.is_launch) == 3.0
    assert program.calls_per_step(tr, "rx.step", program.is_sync) == 0.5
    assert program.calls_per_step(tr, "pfb.step", program.is_launch) is None
    assert [c[1] for c in program.calls_in(pv, "rx.filter",
                                           program.is_launch)] == [
        "cudaLaunchKernel", "cuLaunchKernel"]
    assert program.is_sync("cudaMemcpy")
    assert not program.is_sync("cudaMemcpyAsync")
    assert program.is_launch("cudaGraphLaunch")
    assert not program.is_launch("cudaStreamIsCapturing")


def test_feed_overlap():
    tr = _synthetic()
    # copy 40-56 against step work 12-50 and 60-70: 10 of the copy's 16
    assert program.feed_overlap_pct(tr) == pytest.approx(100 * 10 / 16)
    assert program.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program.overlap_ns([], [(0, 5)]) == 0


def test_idle_by_program_span():
    tr = _synthetic()
    got = dict(program.idle_by_program_span(tr, tr.program))
    # gaps 0-12 and 90-100 outside any span, 70-72 and 75-80 in rx.step
    assert got == {"none": 22 / 1e9, "rx.step": 7 / 1e9}
    # the host's ms a harness step_call, over those that start in the
    # window
    assert program.step_call_ms(_trace()) == pytest.approx(32 / 1e6)
    assert program.step_call_ms(tr) is None


def test_new_readers(manifest):
    ctx = _ctx(_synthetic(), "rx_chain")
    want = {"rx.front_ms": 1e-5, "rx.filter_ms": 6e-6, "rx.agc_ms": 8e-6,
            "rx.launches_per_block": 3.0, "rx.host_syncs_per_block": 0.5,
            "feed.overlap_pct": 62.5}
    for m, v in want.items():
        assert manifest.reader(m)(ctx) == pytest.approx(v), m
    assert manifest.reader("rx.demod_ms")(ctx) is None


def test_new_readers_none_where_absent(manifest):
    tr = _synthetic()
    # the other system's readers, and this system's where it emits no span
    for m in NEW_PFB:
        assert manifest.reader(m)(_ctx(tr, "pfb_rx")) is None
    for m in NEW_RX:
        assert manifest.reader(m)(_ctx(tr, "pfb_rx")) is None
    bare = _synthetic()
    bare.program = Program(bare.program.device, [], bare.program.calls)
    for m in NEW_RX + ("feed.overlap_pct",):
        assert manifest.reader(m)(_ctx(bare, "rx_chain")) is None
    # no profiler on the stack: no view, no reading
    lost = trace.window(Trace([], list(HANDOFFS)))
    assert program.of(lost) is None
    for m in NEW_RX + ("feed.overlap_pct",):
        assert manifest.reader(m)(_ctx(lost, "rx_chain")) is None


@pytest.mark.parametrize("system", ["rx_chain", "pfb_rx"])
def test_old_readers_unchanged(manifest, system):
    plain, spanned = _trace(), _trace()
    spanned.program = Program(
        [Launched(a.start, a.end, a.name, a.kind, a.stream, 1, 1)
         for a in spanned.device], [(0, 200, "rx.step", 1)], [])
    for m in OLD:
        assert manifest.reader(m)(_ctx(plain, system)) == \
            manifest.reader(m)(_ctx(spanned, system))
    # the values test_benchmark_trace.py's readers test holds
    ctx = _ctx(spanned, system)
    assert manifest.reader("device.idle_pct")(ctx) == pytest.approx(37.0)
    assert manifest.reader("feed.h2d_ms")(ctx) == pytest.approx(5e-6)


def test_found_on_the_callers_stack():
    """A real (CPU) profiler record: the harness's hand-offs and the
    program's spans, found by ``of`` on the stack of a reader's caller."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with torch.profiler.record_function("bench.handoff"):
                with torch.profiler.record_function("quisk.rx.step"):
                    torch.ones(4).add_(1)
    tr = trace.from_profiler(prof)
    assert tr.blocks == 2
    pv = program.of(tr)
    assert pv is not None and program.of(tr) is pv
    assert [n for _, _, n, _ in sorted(pv.spans)] == ["rx.step"] * 3
    assert program.calls_per_step(tr, "rx.step", program.is_launch) == 0.0
