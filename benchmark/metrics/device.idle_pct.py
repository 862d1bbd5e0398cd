"""device.idle_pct: the share of the traced window in which nothing ran on
the card, 100 (1 - busy / window).  Busy is the union of the intervals of
every kernel, copy and memset; the window runs from the first to the last
hand-off of the traced stretch.  Moves input_msps: the room a faster
kernel has before the host or the feed holds the card back."""

from qbench.trace import busy_ns


def read(ctx):
    tr = ctx.trace
    if not tr.blocks or not tr.device:
        return None
    return 100.0 * (1.0 - busy_ns(tr) / tr.window_ns)
