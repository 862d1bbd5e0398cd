"""nfm.deemph_ms: the device time a block, in ms, of what RxChain.step
launches inside its ``quisk.rx.deemph`` span in the narrowband-FM
receiver: the 300 Hz de-emphasis one-pole, inside quisk.rx.demod. The
union of the intervals of the step's own activities (nfm.step_busy_ms's
selection) whose launching call lies inside the span, over the window's
blocks; None where the program emits no such span.
nfm.pll_ms, nfm.deemph_ms and nfm.ctcss_ms are parts of nfm.demod_ms;
the rest of it is MixedDemod's SSB, AM and FM families, computed for
every channel and discarded, and the selection.
Moves input_msps where the step sets the pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "rx_pllnfm":
        return None
    return stage_ms(ctx.trace, "rx.deemph")
