"""The program's own spans in the traced stretch, beside the card's work.

``quisk_tpu_torch`` marks each stage of its steps and of its feed with a
``torch.profiler`` range named ``quisk.<layer>.<stage>`` (its
``utils/profiling.py``).  This module reads, from the same profiler
record as ``qbench.trace``, those ranges (``Program.spans``), the host's
CUDA runtime and driver calls (``Program.calls``), and the card's
activities with the host start of the call that launched each
(``Launched.launched``, joined by the profiler's correlation id), so that
device time is put down to the stage that launched it and calls are
counted a step.

The harness hands a metric's reader the reduced ``Trace`` alone; the
profiler it was reduced from is still held by the run that calls the
reader, so ``of`` finds it on the caller's stack, checks that it is the
record the trace came from (its hand-offs bound the same window), reads
it once and keeps the result on the trace.  Where the program emits no
span (a version of it without them), every selection here is empty and
the readers built on it return None.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

from qbench import trace
from qbench.trace import Activity, Trace

PREFIX = "quisk."
STEPS = ("rx.step", "pfb.step")

# host calls that put work on the card, and calls that wait for it; a
# CUDA graph's replay is one cudaGraphLaunch
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCHES = {"cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch"}
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
         "cudaMemcpy"}


@dataclasses.dataclass(frozen=True)
class Launched(Activity):
    launched: int = -1   # host start of the launching call; -1: no link
    thread: int = -1     # the launching call's thread


@dataclasses.dataclass
class Program:
    device: list         # [Launched], the trace's device activities
    spans: list          # [(start, end, name, thread)], name unprefixed
    calls: list          # [(start, name, thread)] runtime / driver calls

    def __post_init__(self):
        # per (name, thread): the instances' starts and ends, by start
        # (instances of one name do not nest in each other)
        idx: dict = {}
        for s, e, n, th in sorted(self.spans):
            idx.setdefault((n, th), ([], []))
            idx[(n, th)][0].append(s)
            idx[(n, th)][1].append(e)
        self._index = idx

    def inside(self, name: str, t: int, thread: int) -> bool:
        """Whether host time ``t`` on ``thread`` lies inside an instance
        of span ``name``."""
        starts, ends = self._index.get((name, thread), ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    def names(self) -> set:
        return {n for n, _ in self._index}


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) or name in LAUNCHES


def is_sync(name: str) -> bool:
    return name in SYNCS


# ----------------------------------------------------------- reading it
def from_events(events, tr: Trace) -> Program | None:
    """The program view of a profiler's kineto events, or None where
    their hand-offs do not bound ``tr``'s window (another record)."""
    from torch.autograd import DeviceType
    handoffs, spans, calls, by_corr, dev = set(), [], [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
            continue
        s = e.start_ns()
        if name.startswith(PREFIX):
            spans.append((s, s + e.duration_ns(), name[len(PREFIX):],
                          e.start_thread_id()))
        elif name == trace.SPAN_PREFIX + "handoff":
            handoffs.add(s)
        elif name.startswith("cu"):
            calls.append((s, name, e.start_thread_id()))
            by_corr[e.correlation_id()] = (s, e.start_thread_id())
    if tr.blocks and not {tr.lo, tr.hi} <= handoffs:
        return None
    device = []
    for e in dev:
        s, name = e.start_ns(), e.name()
        t0, th = by_corr.get(e.correlation_id(), (-1, -1))
        device.append(Launched(s, s + e.duration_ns(), name,
                               trace.kind_of(name), e.device_resource_id(),
                               t0, th))
    return Program(device, spans, sorted(calls))


def _profilers():
    """The ``torch.profiler.profile`` objects held by the frames that
    called into this module."""
    import torch
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, torch.profiler.profile):
                yield v
        f = f.f_back


def of(tr: Trace) -> Program | None:
    """The program view of the traced stretch ``tr``, read once from the
    profiler that recorded it; None where no such profiler is found."""
    if "program" in tr.__dict__:
        return tr.program
    pv = None
    for prof in _profilers():
        pv = from_events(prof.profiler.kineto_results.events(), tr)
        if pv is not None:
            break
    tr.program = pv
    if pv is not None:
        trace_log(tr, pv)
    return pv


# ------------------------------------------------------------ selections
def launched_in(pv: Program, name: str):
    """A selector of the activities launched by a call inside an instance
    of span ``name``, on the same thread."""
    return lambda a: a.launched >= 0 and pv.inside(name, a.launched,
                                                   a.thread)


def launched_in_any(pv: Program):
    """A selector of the activities launched inside any program span."""
    names = pv.names()
    return lambda a: a.launched >= 0 and any(
        pv.inside(n, a.launched, a.thread) for n in names)


def both(*selects):
    return lambda a: all(s(a) for s in selects)


def calls_in(pv: Program, name: str, kinds) -> list:
    """The calls, named for which ``kinds(name)`` holds, made inside an
    instance of span ``name`` on the same thread."""
    return [c for c in pv.calls if kinds(c[1]) and pv.inside(name, c[0],
                                                             c[2])]


def overlap_ns(a, b) -> int:
    """The time two merged, sorted interval lists share."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def merged(tr: Trace, pv: Program, select) -> list:
    """The selected activities' intervals, clipped to the window, as one
    merged list."""
    return trace.union([(a.start, a.end) for a in pv.device if select(a)],
                       tr.lo, tr.hi)


# --------------------------------------------------------------- metrics
def stage_ms(tr: Trace, name: str) -> float | None:
    """Span ``name``'s device time a block, in ms: the union of the
    intervals of the step's own activities (``step_busy_ms``'s
    selection) launched inside it, over the window's blocks."""
    pv = of(tr)
    if pv is None or not tr.blocks:
        return None
    busy = trace.covered(merged(tr, pv, both(trace.step_activity(tr),
                                             launched_in(pv, name))))
    return busy / tr.blocks / 1e6 if busy else None


def calls_per_step(tr: Trace, step: str, kinds) -> float | None:
    """Calls of ``kinds`` made inside span ``step`` a step, over the
    instances of ``step`` that start in the window: an exact count where
    every step makes the same calls."""
    pv = of(tr)
    if pv is None:
        return None
    steps = sorted((s, e, th) for s, e, n, th in pv.spans
                   if n == step and tr.lo <= s < tr.hi)
    if not steps:
        return None
    starts = [s for s, _, _ in steps]
    n = 0
    for t, name, thread in pv.calls:
        i = bisect.bisect_right(starts, t) - 1
        n += (kinds(name) and i >= 0 and t <= steps[i][1]
              and thread == steps[i][2])
    return n / len(steps)


def feed_overlap_pct(tr: Trace) -> float | None:
    """100 |feed copies and step work at once| / the shorter of the two:
    the feed's copies are what was launched inside ``feed.copy``, the
    step work what was launched inside a ``*.step`` span."""
    pv = of(tr)
    if pv is None:
        return None
    copies = merged(tr, pv, launched_in(pv, "feed.copy"))
    steps = [launched_in(pv, s) for s in STEPS]
    work = merged(tr, pv, lambda a: any(s(a) for s in steps))
    least = min(trace.covered(copies), trace.covered(work))
    if not least:
        return None
    return 100.0 * overlap_ns(copies, work) / least


# --------------------------------------------------------------- the log
def idle_by_program_span(tr: Trace, pv: Program, n: int = 10) -> list:
    """[[span, seconds]]: the window's device-idle time by the innermost
    program span open in the middle of each gap (``idle_by_span``'s
    arithmetic over the program's spans)."""
    spans = [(s, e, name) for s, e, name, _ in pv.spans]
    return trace.idle_by_span(dataclasses.replace(tr, spans=spans), n)


def unattributed_share(tr: Trace, pv: Program) -> float | None:
    """The share of the step's device busy time (``step_busy_ms``'s
    selection) launched outside any program span."""
    step = trace.step_activity(tr)
    busy = trace.covered(merged(tr, pv, step))
    if not busy:
        return None
    inside = trace.covered(merged(tr, pv, both(step, launched_in_any(pv))))
    return (busy - inside) / busy


def step_call_ms(tr: Trace) -> float | None:
    """The host's mean ms in the harness's ``step_call`` span, over those
    that start in the window."""
    d = [e - s for s, e, n in tr.spans if n == "step_call"
         and tr.lo <= s < tr.hi]
    return sum(d) / len(d) / 1e6 if d else None


def trace_log(tr: Trace, pv: Program) -> None:
    """One line on standard error: the idle time by program span, the
    share of the step's busy time launched outside any of them, and the
    host's ms a step call."""
    idle = ", ".join(f"{k} {v!r}" for k, v in idle_by_program_span(tr, pv))
    share = unattributed_share(tr, pv)
    print(f"program spans: {len(pv.spans)} in the trace; idle s by "
          f"innermost program span: {idle}; step busy launched outside "
          f"any quisk span: "
          f"{'none' if share is None else repr(100 * share)} %; "
          f"step_call host ms a block: {step_call_ms(tr)!r}",
          file=sys.stderr, flush=True)
