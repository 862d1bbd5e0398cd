"""tx.step_busy_ms: the transmit chain's step (TxChain.step) busy on the
card a block, in ms: the union of the intervals of its own kernels,
memsets and device copies (not the harness's copy out) in the traced
window, over the blocks handed off.  Moves input_msps where the step sets
the pace."""

from qbench.trace import step_busy_ms


def read(ctx):
    if ctx.cfg["system"] != "tx_chain":
        return None
    return step_busy_ms(ctx.trace)
