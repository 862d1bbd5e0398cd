"""Reduce a ``torch.profiler`` record of the traced stretch to intervals:
the card's activities (kernels, copies, memsets) and the harness's own
host spans, in one clock (nanoseconds).  The arithmetic of busy time is
``chip_smoke.py``'s ``device_idle`` (the union of the device intervals),
copied here and extended to clip to a window, find the idle gaps and
name what the host was doing in each."""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict

SPAN_PREFIX = "bench."


@dataclasses.dataclass(frozen=True)
class Activity:
    start: int
    end: int
    name: str
    kind: str            # "kernel", "h2d", "d2h", "d2d", "memset"
    stream: int


@dataclasses.dataclass
class Trace:
    device: list         # [Activity]
    spans: list          # [(start, end, name)] host spans, name unprefixed
    lo: int = 0          # the window: first to last hand-off in the stretch
    hi: int = 0
    blocks: int = 0      # hand-offs that start in [lo, hi)

    @property
    def window_ns(self) -> int:
        return self.hi - self.lo


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy DtoD"):
        return "d2d"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_profiler(prof) -> Trace:
    """The activities and spans of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            s = e.start_ns()
            device.append(Activity(s, s + e.duration_ns(), name,
                                   kind_of(name), e.device_resource_id()))
        elif name.startswith(SPAN_PREFIX):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), name[len(SPAN_PREFIX):]))
    return window(Trace(device, spans))


def window(tr: Trace) -> Trace:
    """Set the window to the stretch's hand-offs: from the first to the
    last, counting the blocks handed off in between."""
    starts = sorted(s for s, _, n in tr.spans if n == "handoff")
    if len(starts) >= 2:
        tr.lo, tr.hi, tr.blocks = starts[0], starts[-1], len(starts) - 1
    return tr


def union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of [a, b) intervals clipped to [lo, hi), merged, sorted."""
    ivs = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                 if b > lo and a < hi)
    merged: list[list[int]] = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def covered(merged) -> int:
    return sum(b - a for a, b in merged)


def gaps(merged, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi) that the merged intervals leave uncovered."""
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def busy_ns(tr: Trace, select=lambda a: True) -> int:
    """Device-busy nanoseconds in the window over the selected
    activities: the union of their intervals."""
    return covered(union([(a.start, a.end) for a in tr.device if select(a)],
                         tr.lo, tr.hi))


def output_streams(tr: Trace) -> set:
    """The streams the harness copies outputs on (those of the
    device-to-host copies)."""
    return {a.stream for a in tr.device if a.kind == "d2h"}


def step_activity(tr: Trace):
    """A selector of the step's own device work: everything but the
    feed's and the harness's copies and what runs on the output stream."""
    out = output_streams(tr)
    return lambda a: a.kind not in ("h2d", "d2h") and a.stream not in out


def top_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the window, summed by name."""
    tot: Counter = Counter()
    for a in tr.device:
        d = min(a.end, tr.hi) - max(a.start, tr.lo)
        if d > 0:
            tot[a.name[:160]] += d
    return [[k, v / 1e9] for k, v in tot.most_common(n)]


def idle_by_span(tr: Trace, n: int = 10) -> list:
    """[[span, seconds]]: the window's device-idle time summed by the
    innermost harness span open on the host in the middle of each gap
    ("none" where the loop was between spans)."""
    merged = union([(a.start, a.end) for a in tr.device], tr.lo, tr.hi)
    spans = sorted(tr.spans)
    starts = [s for s, _, _ in spans]
    tot: defaultdict = defaultdict(int)
    for a, b in gaps(merged, tr.lo, tr.hi):
        mid = (a + b) // 2
        name = "none"
        # spans nest, a few deep: the latest-started one still open is the
        # innermost, and it is among the last few that started
        i1 = bisect.bisect_right(starts, mid)
        for i in range(i1 - 1, max(-1, i1 - 17), -1):
            if spans[i][1] > mid:
                name = spans[i][2]
                break
        tot[name] += b - a
    return [[k, v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def step_busy_ms(tr: Trace) -> float | None:
    """The step's device-busy milliseconds a block: the union of its own
    activities' intervals in the window over the blocks handed off."""
    if not tr.blocks:
        return None
    busy = busy_ns(tr, step_activity(tr))
    return busy / tr.blocks / 1e6 if busy else None
