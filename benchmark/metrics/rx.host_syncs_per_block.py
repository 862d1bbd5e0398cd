"""rx.host_syncs_per_block: the host calls that wait for the card made
inside RxChain.step's ``quisk.rx.step`` span, a step:
cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize,
cuStreamSynchronize, cuCtxSynchronize and the blocking cudaMemcpy, over
the step spans that start in the traced window.  A sync drains the card's
queue, so the launches that follow land on an idle card.  Moves
input_msps through device.idle_pct."""

from qbench.program import calls_per_step, is_sync


def read(ctx):
    if ctx.cfg["system"] != "rx_chain":
        return None
    return calls_per_step(ctx.trace, "rx.step", is_sync)
