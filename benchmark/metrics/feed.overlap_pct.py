"""feed.overlap_pct: how far DeviceFeed's copies in and the step's work
run at once on the card, 100 |both at once| / min(|copies|, |work|): the
copies are the activities launched inside ``quisk.feed.copy``, the work
those launched inside ``quisk.rx.step`` or ``quisk.pfb.step``, each the
union of their intervals in the traced window.  100 means the shorter of
the two is wholly hidden under the other.  Nothing to read where the
capture is already on the card.  Moves input_msps in the fed cells,
where the copy sets the pace and the step hides under it."""

from qbench.program import feed_overlap_pct


def read(ctx):
    return feed_overlap_pct(ctx.trace)
