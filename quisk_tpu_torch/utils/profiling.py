"""The program's spans: a ``torch.profiler`` range around each stage of the
receive paths and the feed, so that a profiler trace shows, beside the
card's kernels and copies, which stage launched them.

``span(name)`` is ``torch.profiler.record_function("quisk." + name)``
while a profiler session is recording on this thread (anyone's
``torch.profiler.profile``: a benchmark's traced stretch, or an operator
around a ``Radio`` or an example).  Otherwise it is one shared null
context: the path with no profiler makes one C call and builds no string,
and nothing is recorded or written.  There is no switch.

``SPANS`` names every span the program emits (without the prefix):

- ``rx.step``: ``RxChain.step``; inside it, in order, ``rx.front`` (the
  conditioner, the blanker, the fused front or the NCO, the unfused
  decimators), ``rx.filter`` (the channel filter, the fractional
  resampler, the FM squelch's RF measure), ``rx.demod``, then one span for
  each audio processor present (``rx.notch``, ``rx.anf``, ``rx.nr``,
  ``rx.agc``, ``rx.squelch``, ``rx.fm_sq``), each with its blend;
- ``rx.pll``, ``rx.deemph``, ``rx.ctcss``: inside ``rx.demod``, the PLL FM
  demodulator's loop, de-emphasis and CTCSS notch (``PLLFMDemod``);
- ``pfb.step``: ``PFBRxPipeline.__call__``; inside it ``pfb.poly``, then
  ``pfb.stage1`` (kernel route) or ``pfb.dft`` (torch-op route), then
  ``pfb.demod`` and ``pfb.power``;
- ``feed.copy`` (``DeviceFeed``'s host-to-card enqueue), ``feed.stage``
  (the memcpy into the pinned ring), ``feed.ring_wait`` (the wait for
  the copy that last read a ring buffer) and ``feed.step_wait`` (the wait
  for the last step before the next is launched: the run-ahead bound).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "quisk."
SPANS = (
    "rx.step", "rx.front", "rx.filter", "rx.demod", "rx.notch", "rx.anf",
    "rx.nr", "rx.agc", "rx.squelch", "rx.fm_sq", "rx.pll", "rx.deemph",
    "rx.ctcss",
    "pfb.step", "pfb.poly", "pfb.stage1", "pfb.dft", "pfb.demod",
    "pfb.power",
    "feed.copy", "feed.stage", "feed.ring_wait", "feed.step_wait",
)
_NAMES = {n: PREFIX + n for n in SPANS}
NULL_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``quisk.<name>`` while a profiler records,
    else the shared ``NULL_SPAN``.  ``name`` is one of ``SPANS``."""
    if _recording():
        return torch.profiler.record_function(_NAMES[name])
    return NULL_SPAN
