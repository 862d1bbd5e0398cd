"""tx.launches_per_block: the host calls that put work on the card made
inside the transmit chain's ``quisk.tx.step`` span, a step:
cudaLaunchKernel*, cuLaunchKernel*, cudaMemcpyAsync, cudaMemsetAsync and
cudaGraphLaunch, over the step spans that start in the traced window.  An
exact integer where every step makes the same calls.  Moves input_msps
where the host's launches set the pace."""

from qbench.program import calls_per_step, is_launch


def read(ctx):
    if ctx.cfg["system"] != "tx_chain":
        return None
    return calls_per_step(ctx.trace, "tx.step", is_launch)
