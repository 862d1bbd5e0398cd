"""pfb.poly_ms: the device time a block, in ms, of what PFBRxPipeline's step
launches inside its ``quisk.pfb.poly`` span: the polyphase sums (kernel
#4). The union of the intervals of the step's own activities
(pfb.step_busy_ms's selection) whose launching call lies inside the span,
over the window's blocks. The four pfb.*_ms stage metrics account for
pfb.step_busy_ms stage by stage. Moves input_msps where the step sets the
pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "pfb_rx":
        return None
    return stage_ms(ctx.trace, "pfb.poly")
