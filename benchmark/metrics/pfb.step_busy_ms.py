"""pfb.step_busy_ms: the channelizer receiver's step (PFBRxPipeline's
call) busy on the card a block, in ms: the union of the intervals of its
own kernels, memsets and device copies (not the feed's copy in, not the
harness's gather and copy out on its output stream) in the traced window,
over the blocks handed off.  Moves input_msps where the step sets the
pace."""

from qbench.trace import step_busy_ms


def read(ctx):
    if ctx.cfg["system"] != "pfb_rx":
        return None
    return step_busy_ms(ctx.trace)
