"""rx.launches_per_block: the host calls that put work on the card made
inside RxChain.step's ``quisk.rx.step`` span, a step: cudaLaunchKernel*,
cuLaunchKernel*, cudaMemcpyAsync, cudaMemsetAsync and cudaGraphLaunch,
over the step spans that start in the traced window.  A CUDA graph's
replay is one call, so the count falls with a graph where the wrappers'
``.launches`` counters (which count a capture) do not.  An exact
integer where every step makes the same calls.  Moves input_msps where
the host's launches set the pace."""

from qbench.program import calls_per_step, is_launch


def read(ctx):
    if ctx.cfg["system"] != "rx_chain":
        return None
    return calls_per_step(ctx.trace, "rx.step", is_launch)
