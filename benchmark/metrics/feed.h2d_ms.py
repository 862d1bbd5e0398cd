"""feed.h2d_ms: host-to-device copy time on the card a block, in ms: the
durations of the traced window's host-to-device copies (the feed's block
copies, on its copy stream) over the blocks handed off.  Nothing to read
where the capture is already on the card.  Moves input_msps in the fed
cells, where the copy sets the pace."""


def read(ctx):
    tr = ctx.trace
    ns = sum(min(a.end, tr.hi) - max(a.start, tr.lo) for a in tr.device
             if a.kind == "h2d" and a.end > tr.lo and a.start < tr.hi)
    if not tr.blocks or not ns:
        return None
    return ns / tr.blocks / 1e6
