"""pfb.demod_ms: the device time a block, in ms, of what PFBRxPipeline's step
launches inside its ``quisk.pfb.demod`` span: the IDFT's stage 2, the
demodulators and the power sums (kernel #6, its chunk and carry launches).
The union of the intervals of the step's own activities
(pfb.step_busy_ms's selection) whose launching call lies inside the span,
over the window's blocks. The four pfb.*_ms stage metrics account for
pfb.step_busy_ms stage by stage. Moves input_msps where the step sets the
pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "pfb_rx":
        return None
    return stage_ms(ctx.trace, "pfb.demod")
