"""tx.interp_ms: the device time a block, in ms, of what TxChain.step
launches inside its ``quisk.tx.interp`` span: the interpolator's banded
fp32 matmul to the TX rate. The union of the intervals of the step's own
activities (tx.step_busy_ms's selection) whose launching call lies inside
the span, over the window's blocks; None where the program emits no such
span.
tx.condition_ms, tx.filter_ms, tx.modulate_ms, tx.alc_ms, tx.interp_ms,
tx.place_ms account for tx.step_busy_ms stage by stage.
Moves input_msps where the step sets the pace."""

from qbench.program import stage_ms


def read(ctx):
    if ctx.cfg["system"] != "tx_chain":
        return None
    return stage_ms(ctx.trace, "tx.interp")
