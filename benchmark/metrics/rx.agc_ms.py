"""rx.agc_ms: the device time a block, in ms, of what RxChain.step launches
inside its ``quisk.rx.agc`` span: the lookahead AGC, with its blend. The
union of the intervals of the step's own activities (rx.step_busy_ms's
selection) whose launching call lies inside the span, over the window's
blocks. With rx.front_ms, rx.filter_ms, rx.demod_ms and rx.agc_ms it
accounts for rx.step_busy_ms stage by stage. Moves input_msps where the
step sets the pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "rx_chain":
        return None
    return stage_ms(ctx.trace, "rx.agc")
