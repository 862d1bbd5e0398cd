"""Per-step recurrences over the time axis.

Counterpart of ``quisk_tpu.ops.scanutil.unrolled_scan``.  Some of the
reference's algorithms are sequential state machines in time (the WDSP
AGC's 5-state hang machine, the per-frame noise tracker, the block-LMS
weight update): they vectorise over channels but not over time.  Here the
time loop is a Python loop and each step is a handful of tensor ops over
the channel axis.  Only what is truly sequential goes through it; linear
recurrences use the log-step scans of ops/iir.py and ops/agc.py.
"""

from __future__ import annotations

import torch


def time_scan(step, carry, xs, dim: int = -1):
    """Run ``carry, y = step(carry, x_t)`` over the slices of ``xs`` along
    ``dim`` and stack the ys back along ``dim``.

    ``xs`` and each y are a tensor or a tuple of tensors sharing that
    axis.  Returns (carry, ys), as ``lax.scan`` does with time leading."""
    many_x = isinstance(xs, tuple)
    slices = (zip(*(t.unbind(dim) for t in xs)) if many_x
              else xs.unbind(dim))
    ys = []
    for x_t in slices:
        carry, y = step(carry, x_t)
        ys.append(y)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(col, dim=dim) for col in zip(*ys))
    return carry, torch.stack(ys, dim=dim)
