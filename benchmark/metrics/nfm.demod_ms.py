"""nfm.demod_ms: the device time a block, in ms, of what RxChain.step
launches inside its ``quisk.rx.demod`` span in the narrowband-FM
receiver: MixedDemod: the SSB, AM and FM families, the EXT demodulator
PLLFMDemod (the PLL kernel, de-emphasis, CTCSS notch) and the selection.
The union of the intervals of the step's own activities
(nfm.step_busy_ms's selection) whose launching call lies inside the
span, over the window's blocks; None where the program emits no such
span.
With nfm.front_ms, nfm.filter_ms, nfm.demod_ms, nfm.agc_ms and
nfm.fm_sq_ms it accounts for nfm.step_busy_ms stage by stage.
Moves input_msps where the step sets the pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "rx_pllnfm":
        return None
    return stage_ms(ctx.trace, "rx.demod")
